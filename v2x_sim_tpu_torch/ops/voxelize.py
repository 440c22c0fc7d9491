"""Point cloud -> dense BEV occupancy voxelization.

Port of ``v2x_sim_tpu/ops/voxelize.py`` (plain layout): a scatter-max of
padded fixed-size point arrays into an (H, W, D) occupancy grid. Padded
points and points outside the extents are dropped: they are routed to a
spill slot past the end of the grid that is cut off afterwards, so the
shapes stay static and nothing syncs with the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from v2x_sim_tpu_torch.configs.config import GridConfig


def voxel_indices(points: torch.Tensor, grid: GridConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize metric points into voxel indices.

    Args:
      points: (..., P, 3+) xyz (extra columns like intensity ignored).

    Returns:
      idx: (..., P, 3) int64 voxel indices (may be out of range).
      valid: (..., P) bool, True where the point falls inside the extents.
    """
    lower = torch.tensor(grid.lower, dtype=points.dtype, device=points.device)
    vs = torch.tensor(grid.voxel_size, dtype=points.dtype, device=points.device)
    dims = torch.tensor(grid.grid_shape, dtype=torch.int64, device=points.device)
    idx = torch.floor((points[..., :3] - lower) / vs).to(torch.int64)
    valid = ((idx >= 0) & (idx < dims)).all(dim=-1)
    return idx, valid


def voxelize_batch(
    points: torch.Tensor,
    mask: torch.Tensor,
    grid: GridConfig,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Voxelize a (..., P, 3+) batch of padded point clouds.

    Args:
      points: (..., P, 3+) padded points.
      mask: (..., P) bool validity of each point (padding = False).
      dtype: occupancy dtype (the model's compute dtype).

    Returns:
      (..., H, W, D) occupancy in {0, 1}; D (the z-slices) is the channel
      axis the 2D backbone convolves over.
    """
    h, w, d = grid.grid_shape
    batch_shape = points.shape[:-2]
    p = points.shape[-2]
    n = 1
    for s in batch_shape:
        n *= s
    idx, valid = voxel_indices(points.reshape(n, p, points.shape[-1]), grid)
    valid = valid & mask.reshape(n, p)
    cells = h * w * d
    sample = torch.arange(n, device=points.device)[:, None]
    flat = sample * cells + (idx[..., 0] * w + idx[..., 1]) * d + idx[..., 2]
    spill = n * cells
    flat = torch.where(valid, flat, torch.full_like(flat, spill))
    occ = torch.zeros(spill + 1, dtype=dtype, device=points.device)
    # Occupancy is {0, 1}: a scatter-max of ones into zeros is a fill of
    # ones at every hit index, which is order-independent.
    occ.index_fill_(0, flat.reshape(-1), 1)
    return occ[:spill].reshape(batch_shape + (h, w, d))


def voxelize(
    points: torch.Tensor,
    mask: torch.Tensor,
    grid: GridConfig,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One (P, 3+) padded cloud with (P,) mask -> (H, W, D) occupancy."""
    return voxelize_batch(points, mask, grid, dtype)


def merged_occupancy(
    points: torch.Tensor,
    point_mask: torch.Tensor,
    trans: torch.Tensor,
    agent_mask: torch.Tensor,
    grid: GridConfig,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Early-fusion occupancy: every real agent's cloud moved into each
    agent's frame and voxelized together (the upperbound input and the KD
    teacher's).

    Args:
      points: (B, A, P, 3+) padded per-agent points, each in its own frame.
      point_mask: (B, A, P).
      trans: (B, A, A, 4, 4), trans[b, i, j] = T_{i<-j}.
      agent_mask: (B, A).

    Returns:
      (B, A, H, W, D): slice [b, i] voxelizes the union over real agents j
      of j's points through T_{i<-j}. The transform is written out as sums
      of products in float32 (at least); a point within rounding of a voxel
      face may land on either side of it.
    """
    b, a, p = point_mask.shape
    acc = torch.promote_types(points.dtype, torch.float32)
    xyz = points[..., :3].to(acc)[:, None]  # (B, 1, Aj, P, 3)
    t = trans.to(acc)[:, :, :, None]  # (B, Ai, Aj, 1, 4, 4)
    moved = torch.stack(
        [t[..., r, 0] * xyz[..., 0] + t[..., r, 1] * xyz[..., 1] + t[..., r, 2] * xyz[..., 2]
         + t[..., r, 3] for r in range(3)], dim=-1)  # (B, Ai, Aj, P, 3)
    mmask = (point_mask & agent_mask[:, :, None])[:, None].expand(b, a, a, p)
    return voxelize_batch(moved.reshape(b, a, a * p, 3), mmask.reshape(b, a, a * p), grid, dtype)
