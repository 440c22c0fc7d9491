"""Rotated-box NMS over a fixed-size candidate set, on the device.

Port of ``v2x_sim_tpu/ops/nms.py``. Candidates are sorted by score with a
stable sort (as ``jnp.argsort``), the K x K exact rotated-IoU matrix of
every problem comes from one launch of the CUDA kernel
(``ops/cuda/iou_cu.py``; its plain version for CPU tensors), and greedy
suppression is a loop over K of vector ops over all problems at once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from v2x_sim_tpu_torch.ops.cuda import iou_cu
from v2x_sim_tpu_torch.utils.spans import span, spanned

NEG_INF = -1e9


class NMSResult(NamedTuple):
    """boxes (..., K, 5), scores (..., K), valid (..., K) — score-sorted;
    suppressed entries have valid=False and score=NEG_INF."""

    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def sort_candidates(
    boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Invalid entries to NEG_INF, then a stable descending sort by score
    along the last axis: (..., K, 5), (..., K), (..., K)."""
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    return boxes, torch.gather(scores, -1, order), torch.gather(valid, -1, order)


@spanned("det.nms.greedy")
def greedy_keep(iou: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy suppression of score-sorted candidates.

    iou (G, K, K), valid (G, K) -> keep (G, K): candidate j is dropped
    when an earlier kept candidate i overlaps it by more than the threshold.
    """
    k = iou.shape[-1]
    later = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(diagonal=1)
    over = (iou > iou_threshold) & later  # over[g, i, j]: i may suppress j
    keep = valid.clone()
    for i in range(k):
        keep &= ~(over[:, i] & keep[:, i, None])
    return keep


@spanned("det.nms")
def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.1,
) -> NMSResult:
    """Greedy rotated NMS over leading batch dims: (..., K, 5) / (..., K)."""
    batch_shape = boxes.shape[:-2]
    k = boxes.shape[-2]
    with span("det.nms.iou"):
        boxes, scores, valid = sort_candidates(
            boxes.reshape(-1, k, 5), scores.reshape(-1, k), valid.reshape(-1, k)
        )
        boxes = boxes.to(torch.float32).contiguous()
        iou = iou_cu.rotated_iou_matrix(boxes, boxes)
    keep = greedy_keep(iou, valid, iou_threshold)
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    return NMSResult(
        boxes.reshape(batch_shape + (k, 5)),
        scores.reshape(batch_shape + (k,)),
        keep.reshape(batch_shape + (k,)),
    )


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.1,
) -> NMSResult:
    """Greedy rotated NMS of one (K, 5) candidate set."""
    return batched_nms(boxes, scores, valid, iou_threshold)
