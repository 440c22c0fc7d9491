"""Exact rotated IoU by Sutherland–Hodgman clipping — the plain PyTorch version.

Port of ``v2x_sim_tpu/ops/iou_sh.py`` in the per-pair form of the Pallas
kernel body ``v2x_sim_tpu/ops/pallas/iou_pl.py::_iou_tile``. It is the
reference for the CUDA kernel (``csrc/rotated_iou.cu``), which repeats
this arithmetic step for step, and it is what the kernel's wrapper runs
for CPU tensors.

A convex quad clipped by 4 half-planes has at most 8 vertices, and S-H
keeps vertex order, so the polygon lives in 8 slots padded by repeating
its last vertex (duplicates are no-ops for clipping and for the shoelace
area). Each clip stage emits a 16-entry stream (kept vertex,
edge crossing) per slot, compacted back to 8 slots in order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from v2x_sim_tpu_torch.ops.boxes import box_area, box_corners

EPS = 1e-8
SLOTS = 8

#: The CUDA kernel's cull (csrc/rotated_iou.cu): a pair whose circumscribed
#: circles lie apart by this slack (relative on the squared radius sum,
#: absolute in m^2) has IoU exactly 0, and the kernel returns 0 for it
#: without clipping. Boxes with a side under CULL_MIN_SIDE are never culled.
CULL_REL = 1.0 / 1024.0
CULL_ABS = 1e-3
CULL_MIN_SIDE = 1e-2


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


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5) x (..., M, 5) -> (..., N, M) exact IoU."""
    return rotated_iou(boxes_a[..., :, None, :], boxes_b[..., None, :, :])


def rotated_iou_pairs_soa_periodic(a_soa: torch.Tensor, b_soa: torch.Tensor) -> torch.Tensor:
    """(5, n) x (5, B*n) field-major boxes -> (B*n,) IoU, where pair p
    takes box A from column p % n: the anchor table against B stacked
    blocks of per-anchor GT boxes."""
    n, nb = a_soa.shape[1], b_soa.shape[1]
    if n == 0 or nb % n:
        raise ValueError(f"pair count {nb} is not a multiple of the period {n}")
    return rotated_iou(a_soa.T.repeat(nb // n, 1), b_soa.T)


def cull_radius(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) boxes -> (...,) circumscribed radius, inf for a box that
    the cull never takes (a side under CULL_MIN_SIDE, or not finite)."""
    l, w = boxes[..., 2], boxes[..., 3]
    r = 0.5 * torch.sqrt(l * l + w * w)
    proper = (l >= CULL_MIN_SIDE) & (w >= CULL_MIN_SIDE)
    return torch.where(proper, r, torch.full_like(r, float("inf")))


def culled(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Broadcastable (..., 5) boxes -> bool mask of the pairs the kernel's
    cull answers with 0 before clipping. A plain copy of the kernel's test
    (its float rounding may differ at the margin): chip_smoke.py counts
    the kernel's work with it, and the tests hold that every pair it takes
    has IoU exactly 0 here. Nothing on the main path calls it."""
    dx = boxes_a[..., 0] - boxes_b[..., 0]
    dy = boxes_a[..., 1] - boxes_b[..., 1]
    s = cull_radius(boxes_a) + cull_radius(boxes_b)
    return dx * dx + dy * dy > s * s * (1.0 + CULL_REL) + CULL_ABS


def clip_profile(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Broadcastable (..., 5) boxes -> four (...,) int tensors: over the
    clip's 4 stages, the vertices taken (at most 8 a stage), the side
    changes (crossings tried) and the vertices kept; and the vertices of
    the final polygon (at most 8). These are what the kernel's clip walks:
    chip_smoke.py counts its operations from them (``iou_cu.clip_ops``).
    Nothing on the main path calls it."""
    boxes_a, boxes_b = torch.broadcast_tensors(boxes_a, boxes_b)
    trace: list = []
    _, _, count = _clip_corners(box_corners(boxes_a), box_corners(boxes_b), trace)
    taken, changes, kept = (sum(stage[i] for stage in trace) for i in range(3))
    return taken, changes, kept, count.clamp(max=SLOTS)
