"""LiDAR visibility (free-space) maps.

Port of ``v2x_sim_tpu/ops/visibility.py`` (the reference dataset's
``vis_maps``). Every ray from the sensor to a LiDAR return is clipped to
the grid's box, sampled at ``num_samples`` fractions of the clipped
segment, and the samples are scattered into the voxel grid as free space;
the returns themselves mark their voxels occupied. Samples that fall in
the return's own voxel are dropped, so that voxel stays occupied.

Encoding: 0 = unknown (never observed), 1 = free (a ray passed through),
2 = occupied (a LiDAR return landed in the cell).

The arithmetic is the JAX package's, in its order, so the same float32
clouds give the same voxel indices. The JAX package vmaps every cloud at
once; here the clouds run ``CHUNK`` at a time, since each cloud's samples
take num_samples x P x 3 floats and as many int64 indices (at 384 x 8192
points: 37.7 MB and 75.5 MB).
"""

from __future__ import annotations

from typing import Optional

import torch

from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.ops.voxelize import voxel_indices, voxelize_batch

FREE = 1.0
OCCUPIED = 2.0

#: Ray samples per point, shared by the bake (create_data_det --vis) and
#: the on-device fallback of DetModule: 384 samples over the grid-clipped
#: segment keep the spacing under the 0.25 m voxel for any ray (the
#: in-grid segment is at most the ~91 m grid diagonal).
DEFAULT_NUM_SAMPLES = 384

#: Clouds carved at once by visibility_batch.
CHUNK = 8


def _visibility(points: torch.Tensor, mask: torch.Tensor, grid: GridConfig,
                origin: Optional[torch.Tensor], num_samples: int) -> torch.Tensor:
    """(N, P, 3+) padded clouds with (N, P) masks -> (N, H, W, D) float32
    visibility grids, every cloud with the same sensor origin."""
    p = points[..., :3]
    dt = p.dtype
    origin = torch.zeros(3, dtype=dt, device=p.device) if origin is None else (
        torch.as_tensor(origin, dtype=dt, device=p.device))
    # Clip each ray to the grid's box (slab method), so that every sample
    # lands inside the extents.
    lo = torch.tensor([e[0] for e in grid.area_extents], dtype=dt, device=p.device)
    hi = torch.tensor([e[1] for e in grid.area_extents], dtype=dt, device=p.device)
    d = p - origin  # (N, P, 3)
    inv = torch.where(d.abs() > 1e-9, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                      torch.full_like(d, 1e30))
    ta = (lo - origin) * inv
    tb = (hi - origin) * inv
    tmin = torch.minimum(ta, tb).amax(dim=-1).clamp(0.0, 1.0)  # (N, P)
    tmax = torch.maximum(ta, tb).amin(dim=-1).clamp(0.0, 1.0)
    seg_ok = tmax > tmin

    # Interior fractions of the clipped segment; samples in the return's
    # own voxel are masked out.
    frac = torch.arange(num_samples, dtype=dt, device=p.device) / num_samples  # (S,)
    t = tmin[:, None, :] + frac[None, :, None] * (tmax - tmin)[:, None, :]  # (N, S, P)
    samples = origin + t[..., None] * d[:, None]  # (N, S, P, 3)

    end_idx, _ = voxel_indices(p, grid)
    s_idx, s_valid = voxel_indices(samples, grid)
    in_end_cell = (s_idx == end_idx[:, None]).all(dim=-1)
    s_mask = s_valid & (mask & seg_ok)[:, None, :] & ~in_end_cell

    n, s, np_ = s_mask.shape
    free = voxelize_batch(samples.reshape(n, s * np_, 3), s_mask.reshape(n, s * np_), grid)
    occ = voxelize_batch(p, mask, grid)
    return torch.maximum(free * FREE, occ * OCCUPIED)


def visibility_map(
    points: torch.Tensor,
    mask: torch.Tensor,
    grid: GridConfig,
    origin: Optional[torch.Tensor] = None,
    num_samples: int = DEFAULT_NUM_SAMPLES,
) -> torch.Tensor:
    """Trinary visibility grid of one padded point cloud.

    Args:
      points: (P, 3+) padded points in the agent frame.
      mask: (P,) point validity.
      grid: grid geometry.
      origin: (3,) sensor origin in the same frame (default zeros).
      num_samples: ray samples per point, spread over the ray's grid-clipped
        segment; keep grid_diagonal / num_samples under the voxel size for
        gap-free carving (the default covers the production grid).

    Returns:
      (H, W, D) float32 grid in {0, 1, 2} (unknown / free / occupied), on
      the device of ``points``.
    """
    return _visibility(points[None], mask[None].to(torch.bool), grid, origin, num_samples)[0]


def visibility_batch(
    points: torch.Tensor,
    mask: torch.Tensor,
    grid: GridConfig,
    num_samples: int = DEFAULT_NUM_SAMPLES,
) -> torch.Tensor:
    """(..., P, 3+) padded clouds with (..., P) masks -> (..., H, W, D)
    float32 visibility grids, carved ``CHUNK`` clouds at a time, each from
    the origin of its own frame."""
    batch_shape = points.shape[:-2]
    flat_pts = points.reshape((-1,) + tuple(points.shape[-2:]))
    flat_mask = mask.reshape((-1, mask.shape[-1])).to(torch.bool)
    out = torch.cat([
        _visibility(flat_pts[i:i + CHUNK], flat_mask[i:i + CHUNK], grid, None, num_samples)
        for i in range(0, flat_pts.shape[0], CHUNK)
    ])
    return out.reshape(batch_shape + tuple(out.shape[-3:]))
