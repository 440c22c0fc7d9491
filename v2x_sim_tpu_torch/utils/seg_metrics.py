"""Segmentation metrics: confusion-matrix mIoU.

Port of ``v2x_sim_tpu/utils/seg_metrics.py``. The confusion matrix is
counted on the device with one bincount per batch; mIoU is read out on
the host from the accumulated matrix. (The JAX package counts by
compare-and-reduce, a TPU layout of the same count.)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(...) int predictions vs labels -> (C, C) int64 counts, row = label,
    column = prediction; labels < 0 are ignored."""
    c2 = num_classes * num_classes
    idx = torch.where(label >= 0, label.long() * num_classes + pred.long(), c2)  # c2: ignored
    return torch.bincount(idx.reshape(-1), minlength=c2 + 1)[:c2].reshape(num_classes, num_classes)


def iou_from_confusion(cm: np.ndarray) -> Dict[str, float]:
    """Per-class IoU and mIoU from an accumulated confusion matrix; a
    class absent from both labels and predictions has IoU NaN and is left
    out of the mean."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom > 0, tp / denom, np.nan)
    out = {f"iou_class{i}": float(v) for i, v in enumerate(iou)}
    out["miou"] = float(np.nanmean(iou))
    return out
