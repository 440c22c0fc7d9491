"""The plain reference of the prediction path: voxelize, the model, the
top-K decode with its peak filter, rotated NMS.

Written from the semantics the port states (``DetModule.predict``):

  * occupancy: a point inside the extents sets its voxel to 1
    (index = floor((p - lower) / voxel)); padded points set nothing;
  * the anchor grid: one anchor per (cell, table entry), centred on the
    cell (row indexes x, column indexes y);
  * scores: the binary softmax, ranked on the logit difference
    (class 1 - class 0); at voxels of at most 0.5 m only the 3x3 spatial
    peaks (over every anchor of the cells) stay candidates; the top
    ``max_boxes`` an agent, decoded from their anchors' codes
    (dx, dy scaled by the anchor's diagonal, log size ratios, yaw from
    (sin, cos)); valid where the score passes the threshold and the agent
    is real;
  * NMS: a stable descending sort by score (invalid ones last), then a
    candidate is dropped when an earlier kept one overlaps it by more
    than ``nms_iou``; suppressed entries keep their boxes and read score
    -1e9.

Imports nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.iou import rotated_iou

NEG_INF = -1e9


class Detections(NamedTuple):
    """boxes (..., K, 5), scores (..., K), valid (..., K), score-sorted."""

    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def anchor_grid(config: dict, device) -> torch.Tensor:
    """(H, W, K, 5) float32 anchors (x, y, l, w, yaw)."""
    h, w, _ = config["grid"]["shape"]
    (x0, _), (y0, _) = config["grid"]["area_extents"][:2]
    vx, vy = config["grid"]["voxel_size"][:2]
    sizes = torch.tensor(config["anchors"]["sizes"], dtype=torch.float32, device=device)
    k = sizes.shape[0]
    cx = x0 + (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * vx
    cy = y0 + (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * vy
    out = torch.empty(h, w, k, 5, dtype=torch.float32, device=device)
    out[..., 0] = cx[:, None, None]
    out[..., 1] = cy[None, :, None]
    out[..., 2:] = sizes
    return out


def voxelize(points: torch.Tensor, mask: torch.Tensor, config: dict) -> torch.Tensor:
    """(B, A, P, 3) points, (B, A, P) mask -> (B, A, D, H, W) float32 occupancy."""
    h, w, d = config["grid"]["shape"]
    b, a, p = mask.shape
    lower = torch.tensor([lo for lo, _ in config["grid"]["area_extents"]], device=points.device)
    size = torch.tensor(config["grid"]["voxel_size"], device=points.device)
    dims = torch.tensor([h, w, d], device=points.device)
    idx = torch.floor((points[..., :3].float() - lower) / size).long()
    ok = mask & ((idx >= 0) & (idx < dims)).all(dim=-1)
    occ = torch.zeros(b * a, d, h, w, device=points.device)
    n = torch.arange(b * a, device=points.device).repeat_interleave(p).reshape(b, a, p)
    occ[n[ok], idx[..., 2][ok], idx[..., 0][ok], idx[..., 1][ok]] = 1.0
    return occ.reshape(b, a, d, h, w)


def decode_boxes(code: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(..., 6) codes against broadcastable (..., 5) anchors -> (..., 5) boxes."""
    ax, ay, al, aw = anchors[..., 0], anchors[..., 1], anchors[..., 2], anchors[..., 3]
    diag = torch.sqrt(al * al + aw * aw)
    return torch.stack([code[..., 0] * diag + ax, code[..., 1] * diag + ay,
                        torch.exp(code[..., 2]) * al, torch.exp(code[..., 3]) * aw,
                        torch.atan2(code[..., 4], code[..., 5])], dim=-1)


def peak_window(config: dict) -> int:
    """3 at voxels of at most 0.5 m, where one vehicle covers many cells; else 0."""
    return 3 if config["grid"]["voxel_size"][0] <= 0.5 else 0


def score_map(cls: torch.Tensor, config: dict) -> torch.Tensor:
    """(N, H, W, K, 2) logits -> (N, H, W, K) logit differences, with
    every candidate that is not a peak of its window at -inf."""
    diff = (cls[..., 1] - cls[..., 0]).float()
    win = peak_window(config)
    if not win:
        return diff
    pooled = F.max_pool2d(diff.amax(dim=-1)[:, None], win, stride=1, padding=win // 2)[:, 0]
    return torch.where(diff >= pooled[..., None], diff, torch.full_like(diff, float("-inf")))


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float) -> Detections:
    """Greedy rotated NMS of (G, K, 5) candidates, each row on its own."""
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(boxes.shape))
    scores, valid = torch.gather(scores, 1, order), torch.gather(valid, 1, order)
    iou = rotated_iou(boxes[:, :, None], boxes[:, None, :])
    k = boxes.shape[1]
    keep = valid.clone()
    for i in range(k):
        over = (iou[:, i] > iou_threshold) & (torch.arange(k, device=boxes.device) > i)
        keep &= ~(over & keep[:, i, None])
    return Detections(boxes, torch.where(keep, scores, torch.full_like(scores, NEG_INF)), keep)


class Dense(NamedTuple):
    """The reference's dense view of one call, for judging the port's:
    diff (N, H*W*K) raw logit differences, peak (N, H*W*K) the same with
    non-peaks at -inf, boxes (N, H*W*K, 5) every anchor's decoded box,
    rho (N, H*W*K) the length of its (sin, cos) code, which the yaw's
    rounding error scales with (atan2 of a short vector), and real (N,)
    whether the agent is present."""

    diff: torch.Tensor
    peak: torch.Tensor
    boxes: torch.Tensor
    rho: torch.Tensor
    real: torch.Tensor


def predict(model, batch: dict, config: dict, max_boxes: int, nms_iou: float,
            score_threshold: float, block: int = 4):
    """The reference's prediction of a batch, in blocks of ``block`` scenes.
    Returns (Detections (B, A, K, ...), Dense over the B*A agent-scenes)."""
    anchors = anchor_grid(config, batch["points"].device)
    flat_anchors = anchors.reshape(-1, 5)
    dets, dense = [], []
    with torch.no_grad():
        for s in range(0, batch["points"].shape[0], block):
            rows = {k: v[s:s + block] for k, v in batch.items()}
            mask = rows["agent_mask"].to(torch.bool)
            occ = voxelize(rows["points"], rows["point_mask"], config)
            cls, reg = model(occ, rows["trans"], mask)
            b, a = cls.shape[:2]
            n = b * a
            diff = (cls[..., 1] - cls[..., 0]).float().reshape(n, -1)
            peak = score_map(cls.reshape((n,) + cls.shape[2:]), config).reshape(n, -1)
            codes = reg.float().reshape(n, -1, reg.shape[-1])
            boxes = decode_boxes(codes, flat_anchors)
            top, idx = torch.topk(peak, max_boxes, dim=-1)
            scores = torch.sigmoid(top)
            cand = torch.gather(boxes, 1, idx[..., None].expand(n, max_boxes, 5))
            valid = (scores > score_threshold) & mask.reshape(n, 1)
            d = nms(cand, scores, valid, nms_iou)
            dets.append(Detections(*(t.reshape((b, a) + t.shape[1:]) for t in d)))
            dense.append(Dense(diff, peak, boxes, codes[..., 4:6].norm(dim=-1),
                               mask.reshape(n)))
    return (Detections(*(torch.cat(parts) for parts in zip(*dets))),
            Dense(*(torch.cat(parts) for parts in zip(*dense))))
