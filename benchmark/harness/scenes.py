"""Synthetic multi-agent LiDAR scenes: the traffic's one generator.

Frozen copy of ``v2x_sim_tpu_torch/datasets/synthetic.py`` (commit
73ef7cd: ``generate_scene``, ``_render_scene`` and their helpers; the same
seed gives the same scene), without the BEV segmentation raster, which no
cell reads. It places rotated vehicle boxes in a world, 1 RSU and
vehicle-mounted agents, simulates each agent's LiDAR points with a range
limit and occlusion dropout, and emits the padded scene:

  points (A, P, 3)       point_mask (A, P)
  trans (A, A, 4, 4)     agent_mask (A,)   trans[i, j] = T_{i<-j}
  gt_boxes (A, M, 5)     gt_mask (A, M)    (each agent's own frame)

The scene's sizes come from the traffic mix (:class:`SceneSpec`), the
extents and the agent count from the configuration. Imports nothing of
the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """The generator's knobs (a traffic mix's ``scene``)."""

    num_vehicles: int = 12
    max_gt: int = 32
    points_per_agent: int = 4096
    lidar_range: float = 20.0
    #: Probability that a visible vehicle is dropped (occluded) for one agent.
    occlusion_prob: float = 0.3
    #: Points sampled on each visible vehicle's perimeter.
    points_per_vehicle: int = 96
    ground_fraction: float = 0.35


def _rot2d(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s], [s, c]])


def _pose_to_mat(x: float, y: float, yaw: float) -> np.ndarray:
    """Agent-frame -> world-frame 4x4 transform."""
    t = np.eye(4)
    t[:2, :2] = _rot2d(yaw)
    t[0, 3] = x
    t[1, 3] = y
    return t


def _box_perimeter_points(box: np.ndarray, n: int, rng) -> np.ndarray:
    """Sample n points roughly on a vehicle's sides and roof (world frame)."""
    x, y, l, w, yaw = box
    edge = rng.integers(0, 4, n)
    u = rng.uniform(-0.5, 0.5, n)
    px = np.where(edge < 2, u * l, np.where(edge == 2, l / 2, -l / 2))
    py = np.where(edge >= 2, u * w, np.where(edge == 0, w / 2, -w / 2))
    pts = np.stack([px, py], -1) @ _rot2d(yaw).T + np.array([x, y])
    z = rng.uniform(-1.5, 0.2, n)  # box height band above ground (-2m)
    return np.concatenate([pts, z[:, None]], -1)


def generate_scene(config: dict, spec: SceneSpec, seed: int) -> Dict[str, np.ndarray]:
    """Generate one multi-agent scene (unbatched)."""
    rng = np.random.default_rng(seed)
    a = config["num_agents"]
    (x0, x1), (y0, y1) = config["grid"]["area_extents"][:2]
    world_lim = min(x1 - 4, y1 - 4)

    nv = spec.num_vehicles
    vehicles = np.stack(
        [
            rng.uniform(-world_lim, world_lim, nv),
            rng.uniform(-world_lim, world_lim, nv),
            rng.uniform(3.8, 5.0, nv),
            rng.uniform(1.6, 2.1, nv),
            rng.uniform(-np.pi, np.pi, nv),
        ],
        axis=-1,
    )

    # Agent poses: agent 0 is the RSU (fixed, elevated intersection unit);
    # the rest ride along random vehicles or free positions.
    poses = np.zeros((a, 3))
    poses[0] = (0.0, 0.0, 0.0)
    for i in range(1, a):
        if i - 1 < nv:
            poses[i] = vehicles[i - 1, [0, 1, 4]]
        else:
            poses[i] = (
                rng.uniform(-world_lim, world_lim),
                rng.uniform(-world_lim, world_lim),
                rng.uniform(-np.pi, np.pi),
            )
    return _render_scene(config, spec, rng, vehicles, poses)


def _render_scene(
    config: dict,
    spec: SceneSpec,
    rng,
    vehicles: np.ndarray,
    poses: np.ndarray,
    occl: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Render one frame given world state: vehicles (nv, 5 = x,y,l,w,yaw),
    agent poses (A, 3 = x,y,yaw). With ``occl=None`` per-agent occlusion
    is drawn from `rng` in the JAX package's order, so the same seed gives
    the same scene; an (A, nv) bool ``occl`` fixes it instead and draws
    nothing for it (generate_sequence: occlusion that persists across
    frames)."""
    a = config["num_agents"]
    p = spec.points_per_agent
    m = spec.max_gt
    nv = len(vehicles)
    (x0, x1), (y0, y1) = config["grid"]["area_extents"][:2]
    agent_mask = np.ones(a, bool)

    a2w = np.stack([_pose_to_mat(*poses[i]) for i in range(a)])  # (A,4,4)
    w2a = np.linalg.inv(a2w)
    # trans[i, j] = T_{i<-j}: j's frame -> i's frame.
    trans = np.einsum("iab,jbc->ijac", w2a, a2w)

    points = np.zeros((a, p, 3), np.float32)
    point_mask = np.zeros((a, p), bool)
    visible = np.zeros((a, nv), bool)
    for i in range(a):
        dist = np.linalg.norm(vehicles[:, :2] - poses[i, :2], axis=-1)
        dropped = rng.uniform(size=nv) <= spec.occlusion_prob if occl is None else occl[i]
        vis = (dist < spec.lidar_range) & ~dropped
        visible[i] = vis
        chunks = [
            _box_perimeter_points(vehicles[v], spec.points_per_vehicle, rng)
            for v in np.nonzero(vis)[0]
        ]
        n_ground = int(p * spec.ground_fraction)
        ang = rng.uniform(-np.pi, np.pi, n_ground)
        rad = rng.uniform(1.0, spec.lidar_range, n_ground)
        ground = np.stack(
            [
                poses[i, 0] + rad * np.cos(ang),
                poses[i, 1] + rad * np.sin(ang),
                rng.uniform(-2.1, -1.9, n_ground),
            ],
            -1,
        )
        chunks.append(ground)
        world_pts = np.concatenate(chunks)[:p]
        # world -> agent frame
        hom = np.concatenate(
            [world_pts, np.ones((len(world_pts), 1))], -1
        )
        local = (w2a[i] @ hom.T).T[:, :3]
        points[i, : len(local)] = local
        point_mask[i, : len(local)] = True

    # Per-agent GT: every vehicle inside the agent's BEV extents (in the
    # agent's frame), visible or not — collaboration should recover the
    # occluded ones.
    gt_boxes = np.zeros((a, m, 5), np.float32)
    gt_mask = np.zeros((a, m), bool)
    gt_vehicle = np.full((a, m), -1, np.int32)  # world vehicle id per GT slot
    for i in range(a):
        r = _rot2d(poses[i, 2])
        centers = (vehicles[:, :2] - poses[i, :2]) @ r  # world->agent rotation^T
        yaws = vehicles[:, 4] - poses[i, 2]
        local = np.stack(
            [centers[:, 0], centers[:, 1], vehicles[:, 2], vehicles[:, 3], yaws],
            -1,
        )
        inside = (
            (local[:, 0] > x0 + 1)
            & (local[:, 0] < x1 - 1)
            & (local[:, 1] > y0 + 1)
            & (local[:, 1] < y1 - 1)
        )
        sel = np.nonzero(inside)[0][:m]
        gt_boxes[i, : len(sel)] = local[sel]
        gt_mask[i, : len(sel)] = True
        gt_vehicle[i, : len(sel)] = sel

    return {
        "points": points,
        "point_mask": point_mask,
        "trans": trans.astype(np.float32),
        "agent_mask": agent_mask,
        "gt_boxes": gt_boxes,
        "gt_mask": gt_mask,
        "gt_vehicle": gt_vehicle,
        "visible": visible,
    }


def generate_batch(config: dict, spec: SceneSpec, seeds) -> Dict[str, np.ndarray]:
    """Stack the scenes of ``seeds`` (one scene a seed) into a batch."""
    scenes = [generate_scene(config, spec, s) for s in seeds]
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
