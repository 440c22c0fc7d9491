"""Rotated BEV box representation and anchor codec.

Port of ``v2x_sim_tpu/ops/boxes.py``. Boxes are ``(x, y, l, w, yaw)``:
metric center, length along heading, width, heading angle (radians, CCW
from +x). The 6-dim box code is ``(dx, dy, dl, dw, sin yaw, cos yaw)``:
center deltas normalized by the anchor diagonal, log size ratios, and the
absolute heading as (sin, cos).
"""

from __future__ import annotations

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


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(..., 5) GT boxes relative to broadcastable (..., 5) anchors -> (..., 6) code."""
    ax, ay, al, aw = (anchors[..., i] for i in range(4))
    gx, gy, gl, gw, gyaw = gt.unbind(-1)
    diag = torch.sqrt(al * al + aw * aw)
    return torch.stack(
        [
            (gx - ax) / diag,
            (gy - ay) / diag,
            torch.log(gl / al),
            torch.log(gw / aw),
            torch.sin(gyaw),
            torch.cos(gyaw),
        ],
        dim=-1,
    )


def decode_boxes(code: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_boxes`: (..., 6) code + (..., 5) anchors -> (..., 5)."""
    ax, ay, al, aw = (anchors[..., i] for i in range(4))
    diag = torch.sqrt(al * al + aw * aw)
    x = code[..., 0] * diag + ax
    y = code[..., 1] * diag + ay
    l = torch.exp(code[..., 2]) * al
    w = torch.exp(code[..., 3]) * aw
    yaw = torch.atan2(code[..., 4], code[..., 5])
    return torch.stack([x, y, l, w, yaw], dim=-1)
