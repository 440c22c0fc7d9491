"""BEV semantic ground-truth rasterization.

The port's own copy of ``v2x_sim_tpu/utils/mapping.py`` (numpy only):
rasterize map polygons (road, sidewalk, terrain, buildings, vegetation)
and pedestrian and vehicle boxes into per-agent BEV class-label maps. It
runs in the host's preprocessing, not on the device.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from v2x_sim_tpu_torch.configs.config import Config


#: One (H, W) coordinate grid per geometry — build_seg_labels calls the
#: rasterizers once per polygon per agent per frame, and rebuilding the
#: identical 256x256 meshgrid hundreds of times per frame was pure
#: host-side waste.
_CENTERS_CACHE: dict = {}


def _cell_centers(config: Config) -> Tuple[np.ndarray, np.ndarray]:
    key = (config.grid.bev_shape, config.grid.voxel_size,
           config.grid.area_extents)
    got = _CENTERS_CACHE.get(key)
    if got is None:
        h, w = config.grid.bev_shape
        rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        got = config.grid.cell_center_xy(rows, cols)
        _CENTERS_CACHE[key] = got
    return got


def rasterize_polygon(
    config: Config, polygon: np.ndarray
) -> np.ndarray:
    """Point-in-polygon mask over the BEV grid.

    Args:
      polygon: (N, 2) vertices (metric, agent frame), either winding.

    Returns:
      (H, W) bool mask (even-odd crossing rule, vectorized).
    """
    cx, cy = _cell_centers(config)
    px, py = polygon[:, 0], polygon[:, 1]
    nxt = np.roll(np.arange(len(polygon)), -1)
    qx, qy = px[nxt], py[nxt]
    inside = np.zeros(cx.shape, bool)
    for i in range(len(polygon)):
        cond = (py[i] > cy) != (qy[i] > cy)
        denom = qy[i] - py[i]
        if abs(denom) < 1e-12:
            continue
        t = (cy - py[i]) / denom
        xi = px[i] + t * (qx[i] - px[i])
        inside ^= cond & (cx < xi)
    return inside


def rasterize_boxes(config: Config, boxes: np.ndarray) -> np.ndarray:
    """(M, 5) rotated boxes -> (H, W) bool footprint mask."""
    cx, cy = _cell_centers(config)
    mask = np.zeros(cx.shape, bool)
    for x, y, l, w, yaw in np.asarray(boxes).reshape(-1, 5):
        c, s = np.cos(yaw), np.sin(yaw)
        dx, dy = cx - x, cy - y
        lx = c * dx + s * dy
        ly = -s * dx + c * dy
        mask |= (np.abs(lx) < l / 2) & (np.abs(ly) < w / 2)
    return mask


def build_seg_labels(
    config: Config,
    vehicle_boxes: np.ndarray,
    layer_polygons: Iterable[Tuple[str, Sequence[np.ndarray]]] = (),
    pedestrian_boxes: np.ndarray = (),
) -> np.ndarray:
    """Compose the BEV semantic label map for one agent.

    Args:
      vehicle_boxes: (M, 5) vehicle footprints in the agent frame.
      layer_polygons: iterable of (class_name, [(N,2) polygon, ...]);
        class_name must be in config.seg_class_names. Painted in
        iteration order (later layers overwrite); actors always last.
      pedestrian_boxes: (P, 5) pedestrian footprints, painted above the
        map layers but below vehicles.

    Returns:
      (H, W) int32 class ids (0 = background).
    """
    labels = np.zeros(config.grid.bev_shape, np.int32)
    name_to_id = {n: i for i, n in enumerate(config.seg_class_names)}
    for name, polys in layer_polygons:
        cid = name_to_id[name]
        for poly in polys:
            labels[rasterize_polygon(config, np.asarray(poly))] = cid
    if len(pedestrian_boxes):
        labels[rasterize_boxes(config, pedestrian_boxes)] = name_to_id[
            "pedestrian"
        ]
    if len(vehicle_boxes):
        labels[rasterize_boxes(config, vehicle_boxes)] = name_to_id["vehicle"]
    return labels
