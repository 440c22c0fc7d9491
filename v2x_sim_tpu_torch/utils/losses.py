"""Training losses.

Port of ``v2x_sim_tpu/utils/losses.py`` (softmax focal, smooth-L1 dense
and sparse, KD MSE, segmentation cross-entropy). Every ``*_sum`` loss
returns ``(sum, count)`` so the caller normalizes by a global count. Sums
are float32 whatever the activation dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def softmax_focal_loss_sum(
    logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0, alpha: float = 0.25
) -> Pair:
    """Softmax focal loss over per-anchor classes.

    Args:
      logits: (..., K, C) per-anchor class logits.
      labels: (..., K) or any shape with the same element count as the
        logits' rows: -1 ignore, 0 background, 1..C-1 classes.

    Returns:
      (loss_sum, num_positive).
    """
    c = logits.shape[-1]
    x = logits.reshape(-1, c).float()
    lab = labels.reshape(-1)
    safe = lab.clamp(0, c - 1).long()
    pt_log = torch.log_softmax(x, dim=-1).gather(1, safe[:, None])[:, 0]
    pt = torch.exp(pt_log)
    alpha_t = torch.where(safe > 0, alpha, 1.0 - alpha)
    loss = -alpha_t * (1.0 - pt) ** gamma * pt_log
    return (loss * (lab >= 0)).sum(), (lab > 0).sum().float()


def _huber(diff: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(diff < delta, 0.5 * diff * diff / delta, diff - 0.5 * delta)


def smooth_l1_loss_sum(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, delta: float = 1.0
) -> Pair:
    """Masked smooth-L1 over dense (..., K, code) predictions and targets
    with a (..., K) positive mask. Returns (loss_sum, num_positive)."""
    diff = (pred.float() - target.reshape(pred.shape).float()).abs()
    m = mask.reshape(pred.shape[:-1]).float()
    return (_huber(diff, delta).sum(dim=-1) * m).sum(), m.sum()


def smooth_l1_loss_sparse_sum(
    pred: torch.Tensor,
    cell: torch.Tensor,
    lane: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    delta: float = 1.0,
) -> Pair:
    """Smooth-L1 at sparse positive anchors.

    Args:
      pred: (B, A, R, F) predicted codes, R cells of F = K*code lanes.
      cell: (B, A, P) row index of each target (< R).
      lane: (B, A, P) anchor index within the row (< K).
      target: (B, A, P, code) encoded GT codes.
      weight: (B, A, P) 1.0 for real positives, 0.0 for padding.

    Returns:
      (loss_sum, num_positive).
    """
    b, a, r, f = pred.shape
    code = target.shape[-1]
    rows, p = b * a, cell.shape[-1]
    pf = pred.reshape(rows, r, f // code, code)
    row = torch.arange(rows, device=pred.device)[:, None]
    x = pf[row, cell.reshape(rows, p).long(), lane.reshape(rows, p).long()].float()
    diff = (x - target.reshape(rows, p, code).float()).abs()
    w = weight.reshape(rows, p).float()
    return (_huber(diff, delta).sum(dim=-1) * w).sum(), w.sum()


def kd_mse_loss_sum(student: torch.Tensor, teacher: torch.Tensor) -> Pair:
    """Feature-map distillation MSE. Returns (squared_error_sum, element_count)."""
    d = student.float() - teacher.float()
    return (d * d).sum(), torch.tensor(float(student.numel()), device=student.device)


def seg_cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> Pair:
    """Per-pixel softmax cross-entropy of (..., C) logits against (...)
    labels, in float32; labels < 0 are ignored. Returns (loss_sum,
    valid_pixel_count)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = labels.clamp(0, num_classes - 1).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    weight = (labels >= 0).float()
    return (nll * weight).sum(), weight.sum()


def seg_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """seg_cross_entropy_sum over max(valid pixel count, 1)."""
    total, n = seg_cross_entropy_sum(logits, labels, num_classes)
    return total / n.clamp(min=1.0)
