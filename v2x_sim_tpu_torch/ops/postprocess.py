"""Prediction decoding: logits -> top-K scored boxes.

Port of ``v2x_sim_tpu/ops/postprocess.py::decode_topk`` and
``_peak_filter``. Top-K is exact (``torch.topk``): the JAX package's
``exact_topk=True`` path. Its approximate ``approx_max_k`` has no
counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from v2x_sim_tpu_torch.ops.boxes import decode_boxes


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
