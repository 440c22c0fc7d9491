"""Cross-agent ego-frame feature warping.

Port of ``v2x_sim_tpu/ops/warp.py::warp_all_pairs``. The JAX package has
two regimes that compute the same bilinear sample: a one-hot matmul for
maps of at most 2048 cells and a gather above. Both are layouts of one
function, so the port has one implementation, ``grid_sample``.

Transform convention: ``trans[b, i, j]`` is the 4x4 rigid transform
taking points in agent j's frame to agent i's frame (T_{i<-j}). Agent j's
features are rendered in agent i's frame by sampling j's map at
``p_j = trans[b, j, i] @ p_i`` over metric cell centers. BEV rows index x
and columns index y. Sampling follows ``grid_sample``: bilinear, zeros
padding, ``align_corners=False``. ``roi_all_pairs`` samples a map of
ones on the same grid by nearest neighbour: where each source covers
each ego's cells (V2X-ViT's ROI mask).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from v2x_sim_tpu_torch.configs.config import GridConfig


def sample_grid(trans: torch.Tensor, grid: GridConfig, h: int, w: int) -> torch.Tensor:
    """``grid_sample``'s float32 sampling grid of every (ego i, source j)
    pair over (h, w) maps: (B*Aj, Ai*h, w, 2), source-major. For source j,
    the A ego frames i stack along the grid's rows, so ``grid_sample``
    reads each source map in place (no A-fold copy of the input)."""
    b, a = trans.shape[:2]
    dev = trans.device
    (x0, x1), (y0, y1) = grid.area_extents[0], grid.area_extents[1]
    sx = (x1 - x0) / h
    sy = (y1 - y0) / w
    xs = x0 + (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * sx
    ys = y0 + (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * sy
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")  # (h, w) ego-frame centers
    # t[b, j, i] = T_{j<-i} = trans[b, j, i].
    t = trans.to(torch.float32)
    r, tt = t[..., :2, :2], t[..., :2, 3]  # (B, Aj, Ai, 2, 2), (B, Aj, Ai, 2)
    xj = r[..., 0, 0, None, None] * gx + r[..., 0, 1, None, None] * gy + tt[..., 0, None, None]
    yj = r[..., 1, 0, None, None] * gx + r[..., 1, 1, None, None] * gy + tt[..., 1, None, None]
    px = (xj - x0) / sx - 0.5  # fractional row in j's map
    py = (yj - y0) / sy - 0.5  # fractional col in j's map
    # grid_sample's last grid dim is (x over WIDTH, y over HEIGHT): the
    # column coordinate comes first.
    gxn = (2.0 * py + 1.0) / w - 1.0
    gyn = (2.0 * px + 1.0) / h - 1.0
    return torch.stack([gxn, gyn], dim=-1).reshape(b * a, a * h, w, 2)


def warp_all_pairs(feats: torch.Tensor, trans: torch.Tensor, grid: GridConfig) -> torch.Tensor:
    """Warp every agent's features into every other agent's frame.

    Args:
      feats: (B, A, H, W, C) per-agent feature maps (each in its own frame).
      trans: (B, A, A, 4, 4); trans[b, i, j] = T_{i<-j}.

    Returns:
      (B, A, A, H, W, C) where out[b, i, j] = agent j's features rendered
      in agent i's frame, in the dtype of ``feats``. The sample itself
      runs in float32 at least, and the coordinates in float32: normalized
      coordinates in bf16 would be off by a tenth of a cell.
    """
    b, a, h, w, c = feats.shape
    src_dtype = torch.promote_types(feats.dtype, torch.float32)
    src = feats.reshape(b * a, h, w, c).permute(0, 3, 1, 2).to(src_dtype)
    out = F.grid_sample(
        src, sample_grid(trans, grid, h, w).to(src_dtype), mode="bilinear",
        padding_mode="zeros", align_corners=False
    )  # (B*Aj, C, Ai*h, w)
    out = out.reshape(b, a, c, a, h, w).permute(0, 3, 1, 4, 5, 2)  # (B, Ai, Aj, h, w, C)
    return out.to(feats.dtype)


def roi_all_pairs(trans: torch.Tensor, grid: GridConfig, h: int, w: int) -> torch.Tensor:
    """(B, Ai, Aj, h, w) bool: where agent j's (h, w) map covers agent i's
    cells, as a map of ones of agent j sampled into i's frame by nearest
    neighbour on the warp's own grid (zeros outside)."""
    b, a = trans.shape[:2]
    ones = torch.ones(b * a, 1, h, w, dtype=torch.float32, device=trans.device)
    roi = F.grid_sample(ones, sample_grid(trans, grid, h, w), mode="nearest",
                        padding_mode="zeros", align_corners=False)  # (B*Aj, 1, Ai*h, w)
    return roi.reshape(b, a, a, h, w).transpose(1, 2) > 0.5
