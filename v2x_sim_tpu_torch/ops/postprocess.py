"""Prediction decoding: logits -> top-K scored boxes.

Port of ``v2x_sim_tpu/ops/postprocess.py``: ``decode_topk`` with
``_peak_filter``, and the test-time late fusion ``transform_boxes`` and
``late_fuse``. Top-K is exact (``torch.topk``): the JAX package's
``exact_topk=True`` path. Its approximate ``approx_max_k`` has no
counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from v2x_sim_tpu_torch.ops.boxes import decode_boxes
from v2x_sim_tpu_torch.ops.nms import NMSResult, batched_nms


def _peak_filter(diff_full: torch.Tensor, window: int) -> torch.Tensor:
    """Keep only spatial local maxima of the score map; the rest drop to -inf.

    diff_full: (N, H, W, K) foreground-logit differences. A cell-anchor
    survives iff its score equals the max over the ``window`` x ``window``
    spatial neighbourhood across all K anchors (at most one candidate per
    local peak). The max-pool pads with -inf at stride 1: the JAX
    ``reduce_window(..., padding="SAME")`` for an odd window.
    """
    if window % 2 != 1:
        raise ValueError(f"peak window must be odd, got {window}")
    cell_max = diff_full.amax(dim=-1)[:, None]  # (N, 1, H, W)
    pooled = F.max_pool2d(cell_max, window, stride=1, padding=window // 2)
    pooled = pooled[:, 0, :, :, None]  # (N, H, W, 1)
    return torch.where(diff_full >= pooled, diff_full, torch.full_like(diff_full, float("-inf")))


def decode_topk(
    cls_logits: torch.Tensor,
    reg: torch.Tensor,
    anchors: torch.Tensor,
    k: int,
    score_threshold: float,
    agent_mask: torch.Tensor,
    peak_window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K score selection + box decode.

    Args:
      cls_logits: (B, A, H, W, K_anchor, C).
      reg: (B, A, H, W, K_anchor, 6).
      anchors: (H, W, K_anchor, 5) dense anchor grid.
      k: candidates kept per agent.
      score_threshold: validity cutoff on the foreground probability.
      agent_mask: (B, A) bool.
      peak_window: if > 0, keep only spatial local maxima before top-K.

    Returns:
      boxes (B, A, k, 5), scores (B, A, k), valid (B, A, k); float32.
    """
    b, a, h, w, kk, _ = cls_logits.shape
    code = reg.shape[-1]
    # Binary softmax == sigmoid of the logit difference: rank on the raw
    # difference (in the logits' dtype) and sigmoid only the survivors.
    diff = cls_logits[..., 1] - cls_logits[..., 0]
    diff = diff.reshape(b * a, h, w, kk)
    if peak_window:
        diff = _peak_filter(diff, peak_window)
    top_diff, top_idx = torch.topk(diff.reshape(b * a, -1), k, dim=-1)
    top_scores = torch.sigmoid(top_diff.to(torch.float32)).reshape(b, a, k)
    reg_flat = reg.reshape(b * a, h * w * kk, code)
    top_codes = torch.gather(reg_flat, 1, top_idx[..., None].expand(b * a, k, code))
    top_codes = top_codes.to(torch.float32).reshape(b, a, k, code)
    top_anchors = anchors.reshape(-1, 5)[top_idx].reshape(b, a, k, 5)
    boxes = decode_boxes(top_codes, top_anchors)
    valid = (top_scores > score_threshold) & agent_mask[..., None]
    return boxes, top_scores, valid


def transform_boxes(boxes: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A rigid 4x4 transform of (..., 5) BEV boxes: centers through the
    transform, yaw plus its planar rotation angle, sizes unchanged."""
    x, y = boxes[..., 0], boxes[..., 1]
    nx = t[..., 0, 0] * x + t[..., 0, 1] * y + t[..., 0, 3]
    ny = t[..., 1, 0] * x + t[..., 1, 1] * y + t[..., 1, 3]
    dyaw = torch.atan2(t[..., 1, 0], t[..., 0, 0])
    return torch.stack([nx, ny, boxes[..., 2], boxes[..., 3], boxes[..., 4] + dyaw], dim=-1)


def late_fuse_candidates(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    trans: torch.Tensor,
    agent_mask: torch.Tensor,
    max_out: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The merged candidates of :func:`late_fuse`, before its NMS: (B, A, N, 5)
    boxes, (B, A, N) scores and valid, N = max_out or A*K."""
    b, a, k, _ = boxes.shape
    # moved[b, i, j, k] = box k of agent j in agent i's frame.
    moved = transform_boxes(boxes[:, None].expand(b, a, a, k, 5), trans[:, :, :, None])
    merged = moved.reshape(b, a, a * k, 5)
    src_ok = (valid & agent_mask[:, :, None])[:, None]
    merged_valid = src_ok.expand(b, a, a, k).reshape(b, a, a * k)
    merged_scores = scores[:, None].expand(b, a, a, k).reshape(b, a, a * k)
    if max_out and max_out < a * k:
        ranked = torch.where(merged_valid, merged_scores,
                             torch.full_like(merged_scores, float("-inf")))
        sel_scores, sel_idx = torch.sort(ranked, dim=-1, descending=True, stable=True)
        sel_scores, sel_idx = sel_scores[..., :max_out], sel_idx[..., :max_out]
        merged = torch.gather(merged, 2, sel_idx[..., None].expand(b, a, max_out, 5))
        merged_valid = torch.gather(merged_valid, 2, sel_idx)
        merged_scores = sel_scores
    return merged, merged_scores, merged_valid


def late_fuse(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    trans: torch.Tensor,
    agent_mask: torch.Tensor,
    nms_iou: float = 0.1,
    max_out: int = 0,
) -> NMSResult:
    """Late fusion: per ego agent i, every real agent's detections moved
    through T_{i<-j}, pooled, and suppressed by one NMS.

    Args:
      boxes/scores/valid: (B, A, K, ...) per-agent detections, each in
        its own frame.
      trans: (B, A, A, 4, 4), trans[b, i, j] = T_{i<-j}.
      agent_mask: (B, A).
      max_out: keep this many top candidates per ego before NMS (0 = all
        A*K). Ties, the invalid entries' -inf among them, keep their index
        order, as ``jax.lax.top_k``'s: a stable descending sort.

    Returns:
      NMSResult with (B, A, max_out or A*K) boxes per ego agent.
    """
    merged = late_fuse_candidates(boxes, scores, valid, trans, agent_mask, max_out)
    return batched_nms(*merged, nms_iou)
