"""Exact rotated-box IoU by Sutherland-Hodgman clipping, in plain PyTorch.

Frozen copy of ``v2x_sim_tpu_torch/ops/iou_sh.py`` (``_clip_quad``,
``_clip_corners``, ``quad_intersection_area``, ``rotated_iou``) and of
``box_corners``/``box_area`` from ``v2x_sim_tpu_torch/ops/boxes.py``, at
commit 73ef7cd, without the kernel's cull and work counters. Boxes are
(x, y, l, w, yaw). Imports nothing of the port.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) boxes -> (..., 4, 2) corners in CCW order starting front-left."""
    x, y, l, w, yaw = boxes.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    # Local CCW corners: (+l/2,+w/2), (-l/2,+w/2), (-l/2,-w/2), (+l/2,-w/2)
    lx = torch.stack([l, -l, -l, l], dim=-1) * 0.5
    ly = torch.stack([w, w, -w, -w], dim=-1) * 0.5
    cx = c[..., None] * lx - s[..., None] * ly + x[..., None]
    cy = s[..., None] * lx + c[..., None] * ly + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 5) boxes."""
    return boxes[..., 2] * boxes[..., 3]


EPS = 1e-8
SLOTS = 8


def _clip_quad(
    px: List[torch.Tensor], py: List[torch.Tensor], cbx, cby, trace: Optional[list] = None
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Clip the 8-slot subject polygon (px, py) by the 4 edges of the CCW
    quad (cbx, cby). Returns the clipped polygon and its vertex count; with
    a `trace` list, appends each stage's (vertices taken, side changes,
    vertices kept)."""
    count = torch.full_like(px[0], 4, dtype=torch.int32)
    for e in range(4):
        ea_x, ea_y = cbx[e], cby[e]
        eb_x, eb_y = cbx[(e + 1) % 4], cby[(e + 1) % 4]
        ex, ey = eb_x - ea_x, eb_y - ea_y
        side = [ex * (py[i] - ea_y) - ey * (px[i] - ea_x) >= -EPS for i in range(SLOTS)]
        if trace is not None:  # padding repeats the last vertex: no extra changes
            trace.append((
                count.clamp(max=SLOTS),
                sum((side[i] != side[(i + 1) % SLOTS]).int() for i in range(SLOTS)),
                sum((side[i] & (count > i)).int() for i in range(SLOTS)),
            ))
        stream = []  # (x, y, valid) per stream entry
        for i in range(SLOTS):
            j = (i + 1) % SLOTS
            dx, dy = px[j] - px[i], py[j] - py[i]
            denom = ex * dy - ey * dx
            ok = denom.abs() > EPS
            t_num = ex * (ea_y - py[i]) - ey * (ea_x - px[i])
            t = t_num / torch.where(ok, denom, torch.ones_like(denom))
            # Padding slots gate only vertex emission; crossings stay
            # ungated (duplicate edges never cross, and the real closing
            # edge from the last duplicate back to slot 0 must keep its).
            stream.append((px[i], py[i], side[i] & (count > i)))
            stream.append((px[i] + t * dx, py[i] + t * dy, (side[i] != side[j]) & ok))
        # Order-preserving compaction: slot k takes the valid stream entry
        # whose exclusive position is k.
        zeros = torch.zeros_like(px[0])
        ox, oy = [zeros] * SLOTS, [zeros] * SLOTS
        pos = torch.zeros_like(count)
        for vx, vy, v in stream:
            for k in range(SLOTS):
                hit = v & (pos == k)
                ox[k] = torch.where(hit, vx, ox[k])
                oy[k] = torch.where(hit, vy, oy[k])
            pos = pos + v.to(torch.int32)
        # Duplicate-fill the tail so padding stays degenerate.
        for k in range(1, SLOTS):
            filled = pos > k
            ox[k] = torch.where(filled, ox[k], ox[k - 1])
            oy[k] = torch.where(filled, oy[k], oy[k - 1])
        px, py, count = ox, oy, pos
    return px, py, count


def _clip_corners(ca: torch.Tensor, cb: torch.Tensor, trace: Optional[list] = None):
    """_clip_quad of quad ca by quad cb, both (..., 4, 2) corners."""
    cax, cay = list(ca[..., 0].unbind(-1)), list(ca[..., 1].unbind(-1))
    cbx, cby = list(cb[..., 0].unbind(-1)), list(cb[..., 1].unbind(-1))
    px = cax + [cax[3]] * (SLOTS - 4)
    py = cay + [cay[3]] * (SLOTS - 4)
    return _clip_quad(px, py, cbx, cby, trace)


def quad_intersection_area(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex CCW quads ca, cb: (..., 4, 2) corners."""
    px, py, count = _clip_corners(ca, cb)
    area2 = torch.zeros_like(px[0])
    for i in range(SLOTS):
        j = (i + 1) % SLOTS
        area2 = area2 + (px[i] * py[j] - px[j] * py[i])
    inter = 0.5 * area2.abs()
    return torch.where(count >= 3, inter, torch.zeros_like(inter))


def rotated_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Elementwise exact IoU of broadcastable (..., 5) float32 box arrays."""
    boxes_a, boxes_b = torch.broadcast_tensors(boxes_a, boxes_b)
    inter = quad_intersection_area(box_corners(boxes_a), box_corners(boxes_b))
    union = box_area(boxes_a) + box_area(boxes_b) - inter
    return inter / torch.clamp(union, min=EPS)
