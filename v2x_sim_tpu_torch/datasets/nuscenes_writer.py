"""Synthetic scenes written as a nuScenes-format dataset root.

Port of ``v2x_sim_tpu/datasets/nuscenes_writer.py`` (host-only numpy and
JSON; the port keeps its own copy): the v1.0-style JSON tables, the
map-expansion file and ``.pcd.bin`` sweeps for synthetic scenes from
``datasets/synthetic.py``, so ``datasets/nuscenes.py`` and the tools run
on a nuScenes-format root without the real V2X-Sim download. Tokens are
``uuid4``: two writes of one seed hold the same content under other
tokens.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Dict, List

import numpy as np

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_scene


def _tok() -> str:
    return uuid.uuid4().hex


def _rect(x0: float, y0: float, x1: float, y1: float) -> List[List[float]]:
    return [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]


def _write_map_expansion(out_root: str, location: str) -> None:
    """Write maps/expansion/{location}.json with all five polygon layers.

    Geometry is in the world frame (== agent-0 frame): a road cross
    through the origin, sidewalks beside it, terrain to the south, one
    building block and one vegetation patch, all inside the 64 m BEV
    window so every seg class appears. The road layer uses the canonical
    node/polygon token-reference schema; the other layers use inline
    `exterior` records, so both parser paths run
    (datasets/nuscenes_map.py::NuScenesMapExpansion).
    """
    nodes: List[dict] = []
    polygons: List[dict] = []

    def poly_token(rect: List[List[float]]) -> str:
        toks = []
        for x, y in rect:
            t = _tok()
            nodes.append({"token": t, "x": x, "y": y})
            toks.append(t)
        pt = _tok()
        polygons.append({"token": pt, "exterior_node_tokens": toks, "holes": []})
        return pt

    road_ns = poly_token(_rect(-40, -4, 40, 4))  # east-west strip
    road_ew = poly_token(_rect(-4, -40, 4, 40))  # north-south strip
    data = {
        "node": nodes,
        "polygon": polygons,
        "road_segment": [{"token": _tok(), "polygon_token": road_ns}],
        "drivable_area": [{"token": _tok(), "polygon_tokens": [road_ew]}],
        "walkway": [
            {"token": _tok(), "exterior": _rect(-40, 4, 40, 8)},
            {"token": _tok(), "exterior": _rect(-40, -8, 40, -4)},
        ],
        "terrain": [{"token": _tok(), "exterior": _rect(-40, -40, 40, -12)}],
        "building": [{"token": _tok(), "exterior": _rect(10, 10, 24, 24)}],
        "vegetation": [{"token": _tok(), "exterior": _rect(-26, 12, -12, 27)}],
    }
    path = os.path.join(out_root, "maps", "expansion", f"{location}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)


def _yaw_quat(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def write_synthetic_nuscenes(
    out_root: str,
    config: Config,
    spec: SyntheticSpec,
    num_scenes: int = 1,
    frames_per_scene: int = 2,
    version: str = "v1.0-mini",
    seed: int = 0,
    present_agents=None,
    sweep_rows: int = 0,
    duplicate_keyframes: bool = False,
) -> str:
    """Write a synthetic dataset in nuScenes format. Returns out_root.

    Each frame re-generates a synthetic world (for simplicity, static
    identities across frames within a scene: vehicles drift slightly so
    tracking has something to follow).

    Irregular-record knobs (real V2X-Sim logs hold such records):
      present_agents: only these agent ids get lidar rows (e.g. (1, 2) =
        RSU-absent scene with fewer than 5 vehicles).
      sweep_rows: emit N extra `is_key_frame=False` intermediate-sweep
        sample_data rows per (sample, agent), pointing at a decoy file —
        the reader must index keyframes only.
      duplicate_keyframes: emit a second, EARLIER-timestamp keyframe row
        per (sample, agent) pointing at an EMPTY point file — the reader
        must deterministically pick the newest keyframe.
    """
    base = os.path.join(out_root, version)
    os.makedirs(base, exist_ok=True)

    tables: Dict[str, List[dict]] = {n: [] for n in (
        "scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
        "sample_annotation", "sensor", "category", "instance", "log", "map",
    )}

    cat_token = _tok()
    tables["category"].append({"token": cat_token, "name": "vehicle.car"})
    ped_cat_token = _tok()
    tables["category"].append(
        {"token": ped_cat_token, "name": "human.pedestrian.adult"}
    )

    # Map tables: one log/location shared by every scene, pointing at a
    # map-expansion file with all five polygon layers (datasets.
    # nuscenes_map) so offline fixtures exercise the full 8-class seg GT.
    log_token = _tok()
    location = "synthetic"
    tables["log"].append(
        {"token": log_token, "logfile": "synthetic", "location": location}
    )
    tables["map"].append(
        {
            "token": _tok(),
            "log_tokens": [log_token],
            "category": "semantic_prior",
            "filename": f"maps/expansion/{location}.json",
        }
    )
    _write_map_expansion(out_root, location)

    # Two static pedestrians near the world origin (world frame ==
    # agent-0 frame), inside every agent's 64 m BEV window.
    ped_world = [(6.0, -5.0), (-8.0, 7.5)]
    ped_instances = []
    for _ in ped_world:
        t = _tok()
        ped_instances.append(t)
        tables["instance"].append(
            {"token": t, "category_token": ped_cat_token}
        )

    sensor_tokens = {}
    for k in range(config.num_agents):
        st = _tok()
        sensor_tokens[k] = st
        tables["sensor"].append(
            {"token": st, "channel": f"LIDAR_TOP_id_{k}", "modality": "lidar"}
        )

    for si in range(num_scenes):
        scene_token = _tok()
        sample_tokens = [_tok() for _ in range(frames_per_scene)]
        instance_tokens: Dict[int, str] = {}
        base_seed = seed * 977 + si * 131

        for fi, sample_token in enumerate(sample_tokens):
            scene_dict = generate_scene(config, spec, seed=base_seed)
            # Small per-frame drift so consecutive frames differ.
            drift = fi * 0.4

            tables["sample"].append(
                {
                    "token": sample_token,
                    "scene_token": scene_token,
                    "timestamp": 1_000_000 * fi,
                    "prev": sample_tokens[fi - 1] if fi > 0 else "",
                    "next": sample_tokens[fi + 1]
                    if fi + 1 < frames_per_scene
                    else "",
                }
            )

            # Reconstruct world-frame data from the generator internals:
            # agent 0 is at the origin, so agent-0-frame == world frame.
            gt0 = scene_dict["gt_boxes"][0][scene_dict["gt_mask"][0]]
            for vi, box in enumerate(gt0):
                if vi not in instance_tokens:
                    instance_tokens[vi] = _tok()
                    tables["instance"].append(
                        {
                            "token": instance_tokens[vi],
                            "category_token": cat_token,
                        }
                    )
                tables["sample_annotation"].append(
                    {
                        "token": _tok(),
                        "sample_token": sample_token,
                        "instance_token": instance_tokens[vi],
                        "translation": [
                            float(box[0] + drift),
                            float(box[1]),
                            0.0,
                        ],
                        "size": [float(box[3]), float(box[2]), 1.6],
                        "rotation": _yaw_quat(float(box[4])),
                    }
                )

            for pi, (px, py) in enumerate(ped_world):
                tables["sample_annotation"].append(
                    {
                        "token": _tok(),
                        "sample_token": sample_token,
                        "instance_token": ped_instances[pi],
                        "translation": [float(px + drift * 0.5), float(py), 0.0],
                        "size": [0.6, 0.6, 1.8],
                        "rotation": _yaw_quat(0.0),
                    }
                )

            for k in range(config.num_agents):
                if not scene_dict["agent_mask"][k]:
                    continue
                if present_agents is not None and k not in present_agents:
                    continue
                # Agent pose in world frame = trans from agent-0 (world).
                a2w = scene_dict["trans"][0, k]  # T_{0<-k} = world_from_k
                yaw = float(np.arctan2(a2w[1, 0], a2w[0, 0]))
                ego_token = _tok()
                cs_token = _tok()
                tables["ego_pose"].append(
                    {
                        "token": ego_token,
                        "translation": [
                            float(a2w[0, 3] + drift),
                            float(a2w[1, 3]),
                            0.0,
                        ],
                        "rotation": _yaw_quat(yaw),
                        "timestamp": 1_000_000 * fi,
                    }
                )
                tables["calibrated_sensor"].append(
                    {
                        "token": cs_token,
                        "sensor_token": sensor_tokens[k],
                        "translation": [0.0, 0.0, 0.0],
                        "rotation": _yaw_quat(0.0),
                    }
                )
                rel = f"sweeps/LIDAR_TOP_id_{k}/{scene_token}_{fi}.pcd.bin"
                path = os.path.join(out_root, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                pts = scene_dict["points"][k][scene_dict["point_mask"][k]]
                full = np.zeros((len(pts), 5), np.float32)
                full[:, :3] = pts
                full.tofile(path)
                tables["sample_data"].append(
                    {
                        "token": _tok(),
                        "sample_token": sample_token,
                        "ego_pose_token": ego_token,
                        "calibrated_sensor_token": cs_token,
                        "filename": rel,
                        "fileformat": "pcd",
                        "is_key_frame": True,
                        "timestamp": 1_000_000 * fi,
                        "channel": f"LIDAR_TOP_id_{k}",
                    }
                )
                decoy_rel = None
                if sweep_rows or duplicate_keyframes:
                    # Decoy file: empty point payload. Reading it instead
                    # of the keyframe file is detectable (zero points).
                    decoy_rel = (
                        f"sweeps/LIDAR_TOP_id_{k}/{scene_token}_{fi}_decoy"
                        ".pcd.bin"
                    )
                    np.zeros((0, 5), np.float32).tofile(
                        os.path.join(out_root, decoy_rel)
                    )
                for sw in range(sweep_rows):
                    tables["sample_data"].append(
                        {
                            "token": _tok(),
                            "sample_token": sample_token,
                            "ego_pose_token": ego_token,
                            "calibrated_sensor_token": cs_token,
                            "filename": decoy_rel,
                            "fileformat": "pcd",
                            "is_key_frame": False,
                            "timestamp": 1_000_000 * fi + 50_000 * (sw + 1),
                            "channel": f"LIDAR_TOP_id_{k}",
                        }
                    )
                if duplicate_keyframes:
                    tables["sample_data"].append(
                        {
                            "token": _tok(),
                            "sample_token": sample_token,
                            "ego_pose_token": ego_token,
                            "calibrated_sensor_token": cs_token,
                            "filename": decoy_rel,
                            "fileformat": "pcd",
                            "is_key_frame": True,
                            "timestamp": 1_000_000 * fi - 10_000,
                            "channel": f"LIDAR_TOP_id_{k}",
                        }
                    )

        tables["scene"].append(
            {
                "token": scene_token,
                "name": f"scene-{si:04d}",
                "log_token": log_token,
                "first_sample_token": sample_tokens[0],
                "last_sample_token": sample_tokens[-1],
                "nbr_samples": frames_per_scene,
            }
        )

    for name, rows in tables.items():
        with open(os.path.join(base, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return out_root
