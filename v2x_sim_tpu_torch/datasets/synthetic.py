"""Synthetic multi-agent LiDAR scene generator.

The port's own copy of ``v2x_sim_tpu/datasets/synthetic.py`` (the same
seeds give the same scenes). It generates worlds of rotated vehicle
boxes, places A agents (1 RSU + vehicles), simulates per-agent LiDAR
point clouds with range limits and per-agent occlusion dropout, and emits
the padded numpy Scene contract:

  points (B, A, P, 3)       point_mask (B, A, P)
  trans (B, A, A, 4, 4)     agent_mask (B, A)
  gt_boxes (B, A, M, 5)     gt_mask (B, A, M)        (per-agent frame)
  seg_labels (B, A, H, W)   (BEV semantic classes)

``generate_sequence`` gives the tracking task's frames: moving vehicles
with persistent identities (``gt_ids``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from v2x_sim_tpu_torch.configs.config import Config

VEHICLE_CLASS = 1  # index into Config.seg_class_names


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    """Knobs for the generator."""

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


def generate_scene(
    config: Config, spec: SyntheticSpec, seed: int
) -> Dict[str, np.ndarray]:
    """Generate one multi-agent scene (unbatched)."""
    rng = np.random.default_rng(seed)
    a = config.num_agents
    (x0, x1), (y0, y1) = config.grid.area_extents[0], config.grid.area_extents[1]
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
    config: Config,
    spec: SyntheticSpec,
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
    a = config.num_agents
    p = spec.points_per_agent
    m = spec.max_gt
    nv = len(vehicles)
    (x0, x1), (y0, y1) = config.grid.area_extents[0], config.grid.area_extents[1]
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
    h, w = config.grid.bev_shape
    seg_labels = np.zeros((a, h, w), np.int32)
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cx, cy = config.grid.cell_center_xy(rows, cols)
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
        # BEV seg: rasterize vehicle footprints.
        for b in local[sel]:
            d = np.stack([cx - b[0], cy - b[1]], -1) @ _rot2d(b[4])
            hit = (np.abs(d[..., 0]) < b[2] / 2) & (np.abs(d[..., 1]) < b[3] / 2)
            seg_labels[i][hit] = VEHICLE_CLASS

    return {
        "points": points,
        "point_mask": point_mask,
        "trans": trans.astype(np.float32),
        "agent_mask": agent_mask,
        "gt_boxes": gt_boxes,
        "gt_mask": gt_mask,
        "gt_vehicle": gt_vehicle,
        "seg_labels": seg_labels,
        "visible": visible,
    }


def generate_batch(
    config: Config, spec: SyntheticSpec, batch_size: int, seed: int, rows: slice = slice(None)
) -> Dict[str, np.ndarray]:
    """Stack `batch_size` scenes into a batched Scene pytree; with `rows`,
    only those rows of it (each scene drawn from its own seed)."""
    scenes = [
        generate_scene(config, spec, seed * 10_007 + b) for b in range(batch_size)[rows]
    ]
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}



def generate_sequence(
    config: Config,
    spec: SyntheticSpec,
    seed: int,
    num_frames: int,
    dt: float = 0.5,
    speed_range: Tuple[float, float] = (1.0, 8.0),
    yaw_rate_max: float = 0.25,
) -> List[Dict[str, np.ndarray]]:
    """A temporal multi-agent sequence for the tracking task: vehicles move
    at a constant speed with a bounded yaw rate and keep their identities,
    agents ride their host vehicles (the RSU stays at the origin), and
    occlusion is drawn once per (agent, vehicle) for the whole sequence,
    so that an occluded vehicle stays hidden from that agent. Vehicles that
    leave the world bounds turn around and are clipped back in.

    Returns ``num_frames`` scene dicts (``generate_scene``'s keys) with
    ``gt_ids`` (A, M) int64 added: the world-vehicle index of each GT slot,
    -1 where padded. The same seed gives the JAX package's frames.
    """
    rng = np.random.default_rng(seed)
    a = config.num_agents
    world_lim = min(config.grid.area_extents[0][1] - 4, config.grid.area_extents[1][1] - 4)

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
    speeds = rng.uniform(*speed_range, nv)
    yaw_rates = rng.uniform(-yaw_rate_max, yaw_rate_max, nv)
    occl = rng.uniform(size=(a, nv)) <= spec.occlusion_prob

    frames = []
    for _ in range(num_frames):
        poses = np.zeros((a, 3))  # the RSU, and agents without a host, at the origin
        for i in range(1, min(a, nv + 1)):
            poses[i] = vehicles[i - 1, [0, 1, 4]]
        frame = _render_scene(config, spec, rng, vehicles, poses, occl=occl)
        # gt_vehicle holds each slot's world-vehicle index, stable across
        # frames because the in-extents selection is index-ordered.
        frame["gt_ids"] = frame["gt_vehicle"].astype(np.int64)
        frames.append(frame)

        vehicles[:, 0] += speeds * np.cos(vehicles[:, 4]) * dt
        vehicles[:, 1] += speeds * np.sin(vehicles[:, 4]) * dt
        vehicles[:, 4] += yaw_rates * dt
        out = (np.abs(vehicles[:, 0]) > world_lim) | (np.abs(vehicles[:, 1]) > world_lim)
        vehicles[out, 4] += np.pi
        vehicles[:, 0] = np.clip(vehicles[:, 0], -world_lim, world_lim)
        vehicles[:, 1] = np.clip(vehicles[:, 1], -world_lim, world_lim)
    return frames
