"""Static configuration for the V2X-Sim perception stack.

The port's own copy of ``v2x_sim_tpu/configs/config.py`` (numpy only; the
port imports nothing of the JAX package): BEV grid geometry, anchor
table, box codec size, class maps, as frozen dataclasses of static values.

Constants marked ``# VERIFY vs reference`` are reconstructions of the
reference's settings, isolated here so that pinning exact parity is a
config diff, not a refactor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """BEV voxel-grid geometry.

    Mirrors the reference's `Config` grid fields: voxel_size ~(0.25, 0.25,
    0.4) m over area_extents ~[-32,32]^2 x [-3,2] m -> a 256 x 256 x 13
    occupancy grid.
    """

    voxel_size: Tuple[float, float, float] = (0.25, 0.25, 0.4)
    area_extents: Tuple[Tuple[float, float], ...] = (
        (-32.0, 32.0),
        (-32.0, 32.0),
        (-3.0, 2.0),
    )

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        """(H, W, D) voxel dimensions — (256, 256, 13) at defaults."""
        dims = []
        for (lo, hi), v in zip(self.area_extents, self.voxel_size):
            dims.append(int(math.ceil((hi - lo) / v - 1e-8)))
        return tuple(dims)  # type: ignore[return-value]

    @property
    def bev_shape(self) -> Tuple[int, int]:
        h, w, _ = self.grid_shape
        return (h, w)

    @property
    def lower(self) -> Tuple[float, float, float]:
        return tuple(lo for lo, _ in self.area_extents)  # type: ignore

    def cell_center_xy(self, row: np.ndarray, col: np.ndarray):
        """Metric (x, y) of the center of BEV cell (row, col).

        Axis convention: row indexes x, col indexes y (matches the
        reference's voxel indexing where dim0 = x bins, dim1 = y bins).
        """
        (x0, _), (y0, _) = self.area_extents[0], self.area_extents[1]
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        return x0 + (row + 0.5) * vx, y0 + (col + 0.5) * vy


# Anchor table: (length_along_heading, width, yaw) per anchor, 6 anchors per
# BEV cell. The reference uses car-sized boxes at several yaw bins plus small
# boxes.  # VERIFY vs reference († coperception/configs/Config.py)
DEFAULT_ANCHOR_SIZES: Tuple[Tuple[float, float, float], ...] = (
    (4.0, 2.0, 0.0),
    (4.0, 2.0, math.pi / 2.0),
    (1.0, 1.0, 0.0),
    (2.0, 1.0, 0.0),
    (2.0, 1.0, math.pi / 2.0),
    (4.0, 2.0, -math.pi / 4.0),
)


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Per-cell anchor table and box codec parameters."""

    sizes: Tuple[Tuple[float, float, float], ...] = DEFAULT_ANCHOR_SIZES
    #: (x, y, l, w, sin, cos) deltas — reference `box_code_size=6`.
    box_code_size: int = 6
    #: IoU thresholds for GT->anchor assignment.
    # VERIFY vs reference († coperception/utils/obj_util.py)
    pos_iou_threshold: float = 0.4
    neg_iou_threshold: float = 0.2

    @property
    def num_anchors(self) -> int:
        return len(self.sizes)


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level static config consumed by all layers."""

    grid: GridConfig = GridConfig()
    anchors: AnchorConfig = AnchorConfig()
    #: Max agents per scene: 1 RSU + 5 vehicles.
    num_agents: int = 6
    #: Binary vehicle-vs-background detection.
    num_classes: int = 2
    #: BEV semantic segmentation classes.
    # VERIFY vs reference († coperception/datasets/V2XSimSeg.py class list)
    seg_class_names: Tuple[str, ...] = (
        "background",
        "vehicle",
        "pedestrian",
        "road",
        "sidewalk",
        "terrain",
        "building",
        "vegetation",
    )
    #: Encoder stage at which intermediate fusion happens (reference --layer).
    fusion_layer: int = 3
    #: Max LiDAR points per agent sweep after padding (static shapes).
    max_points: int = 30000
    #: Cap on decoded boxes entering NMS (static shape).
    max_boxes: int = 512

    @property
    def num_seg_classes(self) -> int:
        return len(self.seg_class_names)

    @property
    def map_dims(self) -> Tuple[int, int]:
        return self.grid.bev_shape


DEFAULT_CONFIG = Config()
