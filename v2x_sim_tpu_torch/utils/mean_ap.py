"""mAP evaluation for rotated BEV detections.

Port of ``v2x_sim_tpu/utils/mean_ap.py``: the reference's mmdetection-
derived evaluator (``eval_map`` / ``average_precision``): VOC-style greedy
TP/FP matching at rotated IoU 0.5 and 0.7 (or at a center distance), the
area under the PR curve, reported per agent ("local") and averaged
("global").

The (F, K, M) IoU of an ``eval_map`` call comes from one launch of the
rotated-IoU matrix kernel (``ops/cuda/iou_cu.py``) on the device the
caller names: the CUDA card by default, the plain PyTorch version for
``device="cpu"``. The greedy matching and the PR integration are the JAX
package's exact host loop in numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.ops.cuda import iou_cu


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """Area under the PR curve (mmdet 'area' mode)."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def batched_iou(det_boxes: np.ndarray, gt_boxes: np.ndarray, device: torch.device) -> np.ndarray:
    """(F, K, 5) x (F, M, 5) -> (F, K, M) IoU, one kernel launch on ``device``."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return iou_cu.rotated_iou_matrix(to(det_boxes), to(gt_boxes)).cpu().numpy()


def eval_map(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    det_valid: np.ndarray,
    gt_boxes: np.ndarray,
    gt_mask: np.ndarray,
    iou_threshold: float = 0.5,
    match: str = "iou",
    device: Optional[Union[str, torch.device]] = None,
) -> float:
    """Single-class AP over F frames of padded detections and GT.

    Args:
      det_boxes: (F, K, 5); det_scores: (F, K); det_valid: (F, K) bool.
      gt_boxes: (F, M, 5); gt_mask: (F, M) bool.
      iou_threshold: the match threshold: a rotated IoU (0.5 / 0.7) when
        match="iou" (the reference's criterion), or a center distance in
        meters when match="center" (nearest unmatched GT within the radius).
      device: where the IoU runs; None means the CUDA card.

    Returns:
      AP in [0, 1].
    """
    f = det_boxes.shape[0]
    if match == "center":
        # Match quality = negative center distance; the threshold flips sign.
        qual = -np.linalg.norm(det_boxes[:, :, None, :2] - gt_boxes[:, None, :, :2], axis=-1)
        thr = -float(iou_threshold)
    else:
        qual = batched_iou(det_boxes, gt_boxes, resolve_device(device))
        thr = float(iou_threshold)
    num_gt = int(gt_mask.sum())
    if num_gt == 0:
        return 0.0

    records = []  # (score, is_tp)
    for fi in range(f):
        order = np.argsort(-det_scores[fi])
        matched = np.zeros(gt_boxes.shape[1], bool)
        for di in order:
            if not det_valid[fi, di]:
                continue
            ious = np.where(gt_mask[fi] & ~matched, qual[fi, di], -np.inf)
            gi = int(np.argmax(ious))
            if ious[gi] >= thr:
                matched[gi] = True
                records.append((det_scores[fi, di], 1))
            else:
                records.append((det_scores[fi, di], 0))

    if not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records])
    fp = np.cumsum([1 - r[1] for r in records])
    recalls = tp / num_gt
    precisions = tp / np.maximum(tp + fp, 1)
    return average_precision(recalls, precisions)


def eval_map_agents(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    det_valid: np.ndarray,
    gt_boxes: np.ndarray,
    gt_mask: np.ndarray,
    agent_mask: np.ndarray,
    iou_thresholds: Sequence[float] = (0.5, 0.7),
    match: str = "iou",
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """Per-agent ("local") and averaged ("global") mAP, reference-style.

    Args:
      det_boxes: (F, A, K, 5) etc.; agent_mask: (F, A).
      match: "iou" (the reference's) or "center" (thresholds in meters;
        the keys get an "m" suffix, e.g. "mAP@2.0m").
      device: where the IoU runs; None means the CUDA card.

    Returns:
      {"mAP@0.5": ..., "mAP@0.7": ..., "agent{i}_mAP@0.5": ...}.
    """
    f, a = det_boxes.shape[:2]
    out: Dict[str, float] = {}
    unit = "m" if match == "center" else ""
    for thr in iou_thresholds:
        per_agent = []
        for ai in range(a):
            keep = agent_mask[:, ai]
            if not keep.any():
                continue
            ap = eval_map(
                det_boxes[keep, ai],
                det_scores[keep, ai],
                det_valid[keep, ai],
                gt_boxes[keep, ai],
                gt_mask[keep, ai],
                thr,
                match=match,
                device=device,
            )
            per_agent.append(ap)
            out[f"agent{ai}_mAP@{thr}{unit}"] = ap
        out[f"mAP@{thr}{unit}"] = float(np.mean(per_agent)) if per_agent else 0.0
    return out
