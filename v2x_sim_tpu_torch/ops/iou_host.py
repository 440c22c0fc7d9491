"""Host-side (pure numpy) exact rotated IoU.

The port's own copy of ``v2x_sim_tpu/ops/iou_host.py``: the
Sutherland-Hodgman clip of ``ops/iou_sh.py`` in numpy, in float64, for
host-side consumers whose box lists change size every frame (the SORT
tracker and the MOT metrics, ``tracking/``). Tracking keeps to this copy
rather than the CUDA matrix entry: on zero-size boxes the two return
different area / 1e-8 values.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-8
_SLOTS = 8


def _corners(boxes: np.ndarray) -> np.ndarray:
    x, y, l, w, yaw = (boxes[..., i] for i in range(5))
    c, s = np.cos(yaw), np.sin(yaw)
    lx = np.stack([l, -l, -l, l], -1) * 0.5
    ly = np.stack([w, w, -w, -w], -1) * 0.5
    cx = c[..., None] * lx - s[..., None] * ly + x[..., None]
    cy = s[..., None] * lx + c[..., None] * ly + y[..., None]
    return np.stack([cx, cy], -1)


def _clip(poly, count, ax, ay, bx, by):
    px, py = poly[..., 0], poly[..., 1]
    nx = np.roll(px, -1, -1)
    ny = np.roll(py, -1, -1)
    a_x, a_y, b_x, b_y = ax[..., None], ay[..., None], bx[..., None], by[..., None]
    cross = lambda qx, qy: (b_x - a_x) * (qy - a_y) - (b_y - a_y) * (qx - a_x)
    cur_in = cross(px, py) >= -_EPS
    nxt_in = cross(nx, ny) >= -_EPS
    dx, dy = nx - px, ny - py
    ex, ey = b_x - a_x, b_y - a_y
    denom = ex * dy - ey * dx
    t_num = ex * (a_y - py) - ey * (a_x - px)
    t = t_num / np.where(np.abs(denom) > _EPS, denom, 1.0)
    ix, iy = px + t * dx, py + t * dy
    crossing = (cur_in != nxt_in) & (np.abs(denom) > _EPS)

    slots = np.arange(_SLOTS)
    emit_v = cur_in & (slots < count[..., None])
    sx = np.stack([px, ix], -1).reshape(px.shape[:-1] + (2 * _SLOTS,))
    sy = np.stack([py, iy], -1).reshape(py.shape[:-1] + (2 * _SLOTS,))
    sv = np.stack([emit_v, crossing], -1).reshape(px.shape[:-1] + (2 * _SLOTS,))

    pos = np.cumsum(sv, -1) - sv
    onehot = ((pos[..., None, :] == slots[..., :, None]) & sv[..., None, :]).astype(
        poly.dtype
    )
    ox = np.einsum("...kj,...j->...k", onehot, sx)
    oy = np.einsum("...kj,...j->...k", onehot, sy)
    new_count = sv.sum(-1)
    filled = slots < new_count[..., None]
    for k in range(1, _SLOTS):
        ox[..., k] = np.where(filled[..., k], ox[..., k], ox[..., k - 1])
        oy[..., k] = np.where(filled[..., k], oy[..., k], oy[..., k - 1])
    return np.stack([ox, oy], -1), new_count


def rotated_iou_matrix_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 5) x (M, 5) -> (N, M) exact IoU in pure numpy."""
    n, m = len(boxes_a), len(boxes_b)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    boxes_a = np.asarray(boxes_a, np.float64)
    boxes_b = np.asarray(boxes_b, np.float64)
    ca = np.broadcast_to(_corners(boxes_a)[:, None], (n, m, 4, 2)).copy()
    cb = np.broadcast_to(_corners(boxes_b)[None, :], (n, m, 4, 2)).copy()
    # CCW orientation of the clip quad.
    x, y = cb[..., 0], cb[..., 1]
    signed = np.sum(x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y, -1)
    cb = np.where((signed >= 0)[..., None, None], cb, cb[..., ::-1, :])

    poly = np.concatenate([ca, np.repeat(ca[..., 3:4, :], 4, axis=-2)], axis=-2)
    count = np.full((n, m), 4)
    for e in range(4):
        poly, count = _clip(
            poly,
            count,
            cb[..., e, 0],
            cb[..., e, 1],
            cb[..., (e + 1) % 4, 0],
            cb[..., (e + 1) % 4, 1],
        )
    px, py = poly[..., 0], poly[..., 1]
    inter = 0.5 * np.abs(
        np.sum(px * np.roll(py, -1, -1) - np.roll(px, -1, -1) * py, -1)
    )
    inter = np.where(count >= 3, inter, 0.0)
    area_a = boxes_a[:, None, 2] * boxes_a[:, None, 3]
    area_b = boxes_b[None, :, 2] * boxes_b[None, :, 3]
    return (inter / np.maximum(area_a + area_b - inter, _EPS)).astype(np.float32)
