"""Anchor grid generation over the BEV map.

The port's own copy of ``v2x_sim_tpu/ops/anchors.py``: one anchor per
(cell, anchor-table entry), centered on the cell, yielding an
(H, W, K, 5) array of (x, y, l, w, yaw), computed once in numpy.
"""

from __future__ import annotations

import numpy as np

from v2x_sim_tpu_torch.configs.config import Config


def anchor_grid(config: Config) -> np.ndarray:
    """Build the dense anchor map.

    Returns:
      (H, W, K, 5) float32 array of (x, y, l, w, yaw), where K =
      config.anchors.num_anchors. Row indexes x bins, column indexes y bins
      (same convention as the voxel grid).
    """
    h, w = config.grid.bev_shape
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cx, cy = config.grid.cell_center_xy(rows, cols)  # (H, W) each
    sizes = np.asarray(config.anchors.sizes, dtype=np.float32)  # (K, 3)
    k = sizes.shape[0]
    out = np.zeros((h, w, k, 5), dtype=np.float32)
    out[..., 0] = cx[..., None]
    out[..., 1] = cy[..., None]
    out[..., 2] = sizes[None, None, :, 0]
    out[..., 3] = sizes[None, None, :, 1]
    out[..., 4] = sizes[None, None, :, 2]
    return out
