"""nuScenes-format V2X-Sim dataset reader (devkit-free).

The port's own copy of ``v2x_sim_tpu/datasets/nuscenes.py`` (numpy only).

The V2X-Sim dataset ships in nuScenes format with per-agent lidar
channels ``LIDAR_TOP_id_{k}``: JSON tables scene / sample / sample_data /
sample_annotation / ego_pose / calibrated_sensor linked by tokens, plus
``.pcd.bin`` float32 sweeps.

  * ``NuScenesTables`` loads the JSON tables once into token-keyed dicts
    and builds the scene -> ordered samples -> per-agent sample_data index.
  * ``V2XSimDataset`` extracts per (sample, agent) padded points in the
    agent's sensor frame, the pairwise T_{i<-j} transform stack, GT
    vehicle boxes per agent frame and, with ``with_seg_labels``, the
    8-class BEV label map per agent: the scene dict of
    ``datasets/synthetic.py``, so training code does not depend on the
    source.

Everything here is host-side indexing and numpy I/O; voxelization and
target assignment run on the device downstream.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.datasets.nuscenes_map import NuScenesMapExpansion, transform_polygons
from v2x_sim_tpu_torch.utils.mapping import build_seg_labels

TABLE_NAMES = (
    "scene",
    "sample",
    "sample_data",
    "ego_pose",
    "calibrated_sensor",
    "sample_annotation",
    "sensor",
    "category",
    "instance",
    "log",
    "map",
)

#: nuScenes .pcd.bin layout: x, y, z, intensity, ring (float32 each).
PCD_FLOATS = 5

VEHICLE_CATEGORY_PREFIX = "vehicle"
PEDESTRIAN_CATEGORY_PREFIX = "human.pedestrian"


def quat_to_yaw(q: Sequence[float]) -> float:
    """Heading from a nuScenes [w, x, y, z] quaternion."""
    w, x, y, z = q
    return float(np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)))


def pose_matrix(translation: Sequence[float], rotation: Sequence[float]) -> np.ndarray:
    """4x4 transform from [w,x,y,z] quaternion + translation."""
    w, x, y, z = rotation
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    t = np.eye(4)
    t[:3, :3] = r
    t[:3, 3] = translation
    return t


class NuScenesTables:
    """Token-indexed nuScenes tables + the V2X multi-agent frame index."""

    def __init__(self, dataroot: str, version: str = "v1.0-mini"):
        self.dataroot = dataroot
        self.version = version
        base = os.path.join(dataroot, version)
        self.tables: Dict[str, Dict[str, dict]] = {}
        for name in TABLE_NAMES:
            path = os.path.join(base, f"{name}.json")
            if os.path.exists(path):
                with open(path) as f:
                    rows = json.load(f)
                self.tables[name] = {r["token"]: r for r in rows}
            else:
                self.tables[name] = {}

        self._category_name = {
            t: r["name"] for t, r in self.tables["category"].items()
        }
        self._instance_category = {
            t: r["category_token"] for t, r in self.tables["instance"].items()
        }
        # Stable small-int track identity per instance_token (sorted for
        # run-to-run determinism) — real MOT GT ids, not NN-synthesized.
        self._instance_id = {
            t: i for i, t in enumerate(sorted(self.tables["instance"]))
        }
        self._build_index()

    # ------------------------------------------------------------------ #

    def _build_index(self) -> None:
        """scene -> ordered sample tokens; sample -> {agent_id: sample_data}."""
        self.scene_samples: Dict[str, List[str]] = {}
        for token, scene in self.tables["scene"].items():
            order = []
            cur = scene["first_sample_token"]
            while cur:
                order.append(cur)
                cur = self.tables["sample"][cur]["next"]
            self.scene_samples[token] = order

        self.sample_scene: Dict[str, str] = {}
        for token, samples in self.scene_samples.items():
            for s in samples:
                self.sample_scene[s] = token

        # Deterministic keyframe pick per (sample, agent): real V2X-Sim
        # logs can carry several lidar sample_data rows per agent per
        # sample (intermediate sweeps with is_key_frame=False, or
        # duplicate keyframes from resimulated segments). Sorting by
        # (timestamp, token) and letting the last row win selects the
        # newest keyframe, with a stable token tiebreak — instead of
        # whatever JSON row order the file happened to have.
        self.sample_lidars: Dict[str, Dict[int, dict]] = {}
        rows = sorted(
            self.tables["sample_data"].values(),
            key=lambda r: (r.get("timestamp", 0), r["token"]),
        )
        for sd in rows:
            channel = sd.get("channel")
            if channel is None:
                cs = self.tables["calibrated_sensor"][sd["calibrated_sensor_token"]]
                sensor = self.tables["sensor"].get(cs["sensor_token"], {})
                channel = sensor.get("channel", "")
            if not channel.startswith("LIDAR_TOP_id_"):
                continue
            if not sd.get("is_key_frame", True):
                continue  # non-keyframe sweeps never index a frame
            try:
                agent_id = int(channel.rsplit("_", 1)[1])
            except ValueError:
                continue  # malformed channel suffix — skip, don't crash
            self.sample_lidars.setdefault(sd["sample_token"], {})[agent_id] = sd

        self.sample_annotations: Dict[str, List[dict]] = {}
        for ann in self.tables["sample_annotation"].values():
            self.sample_annotations.setdefault(ann["sample_token"], []).append(ann)

    # ------------------------------------------------------------------ #

    def global_from_sensor(self, sd: dict) -> np.ndarray:
        """4x4: sensor frame -> global frame for one sample_data row."""
        ego_pose = self.tables["ego_pose"][sd["ego_pose_token"]]
        cs = self.tables["calibrated_sensor"][sd["calibrated_sensor_token"]]
        g_from_e = pose_matrix(ego_pose["translation"], ego_pose["rotation"])
        e_from_s = pose_matrix(cs["translation"], cs["rotation"])
        return g_from_e @ e_from_s

    def category_of(self, ann: dict) -> str:
        cat_token = self._instance_category.get(ann["instance_token"])
        return self._category_name.get(cat_token, ann.get("category_name", ""))

    def is_vehicle(self, ann: dict) -> bool:
        return self.category_of(ann).startswith(VEHICLE_CATEGORY_PREFIX)

    def global_boxes(
        self, sample_token: str, prefix: str = VEHICLE_CATEGORY_PREFIX
    ):
        """GT boxes of one category prefix for a sample, global frame.

        Returns ((M, 5) x,y,l,w,yaw float64, (M,) int32 instance ids).
        The ids are stable small integers derived from the instance table
        (one per `instance_token`): the real track identities the dataset
        carries, which the tracking tools use as MOT ground truth.
        nuScenes size is [width, length, height]; heading along length.
        """
        out, ids = [], []
        for ann in self.sample_annotations.get(sample_token, []):
            if not self.category_of(ann).startswith(prefix):
                continue
            w, l = ann["size"][0], ann["size"][1]
            yaw = quat_to_yaw(ann["rotation"])
            out.append([ann["translation"][0], ann["translation"][1], l, w, yaw])
            ids.append(self._instance_id.get(ann["instance_token"], -1))
        return (
            np.asarray(out, np.float64).reshape(-1, 5),
            np.asarray(ids, np.int32),
        )

    def map_location(self, sample_token: str) -> Optional[str]:
        """Map-expansion location of a sample's scene, via scene -> log."""
        scene_token = self.sample_scene.get(sample_token)
        if scene_token is None:
            return None
        log_token = self.tables["scene"][scene_token].get("log_token")
        log = self.tables["log"].get(log_token)
        return log.get("location") if log else None


def _scene_split(scene_token: str) -> str:
    """Deterministic 80/10/10 scene partition (stable across runs and
    machines: md5 of the token, not Python's salted hash)."""
    import hashlib

    h = int(hashlib.md5(scene_token.encode()).hexdigest(), 16) % 10
    return "train" if h < 8 else ("val" if h == 8 else "test")


class V2XSimDataset:
    """Multi-agent frame extraction over a nuScenes-format V2X-Sim root.

    Produces the same per-scene dict as datasets.synthetic.generate_scene:
    padded per-agent points (sensor frame), pairwise trans, per-agent GT
    boxes, agent mask, and the GT instance ids. It streams from the root;
    the offline cache of ``tools/create_data_det.py`` is optional.
    """

    def __init__(
        self,
        dataroot: str,
        config: Config,
        version: str = "v1.0-mini",
        max_points: Optional[int] = None,
        max_gt: int = 64,
        use_rsu: bool = True,
        with_seg_labels: bool = False,
        split: Optional[str] = None,
    ):
        """`split`: None (all scenes) or train/val/test — a deterministic
        80/10/10 SCENE-level partition by scene-token hash. V2X-Sim ships
        official per-split roots; when a root holds every scene this
        keeps train and test caches disjoint."""
        self.nusc = NuScenesTables(dataroot, version)
        self.config = config
        self.max_points = max_points or config.max_points
        self.max_gt = max_gt
        self.use_rsu = use_rsu
        self.with_seg_labels = with_seg_labels
        self._maps: Dict[str, Optional[NuScenesMapExpansion]] = {}  # location -> its map
        self.frames: List[str] = []  # sample tokens with >=1 agent lidar
        for scene_token in sorted(self.nusc.scene_samples):
            if split is not None and _scene_split(scene_token) != split:
                continue
            for s in self.nusc.scene_samples[scene_token]:
                if s in self.nusc.sample_lidars:
                    self.frames.append(s)

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample_token = self.frames[idx]
        a = self.config.num_agents
        p = self.max_points
        m = self.max_gt
        lidars = self.nusc.sample_lidars[sample_token]

        points = np.zeros((a, p, 3), np.float32)
        point_mask = np.zeros((a, p), bool)
        agent_mask = np.zeros(a, bool)
        g_from_s = np.tile(np.eye(4), (a, 1, 1))

        paths, slots = [], []
        for agent_id, sd in lidars.items():
            if agent_id >= a or (agent_id == 0 and not self.use_rsu):
                continue
            paths.append(os.path.join(self.nusc.dataroot, sd["filename"]))
            slots.append(agent_id)
            agent_mask[agent_id] = True
            g_from_s[agent_id] = self.nusc.global_from_sensor(sd)
        if paths:
            # The threaded native reader (native/loader.py), or its numpy
            # fallback.
            from v2x_sim_tpu_torch.native.loader import read_pcd_batch

            pts, msk = read_pcd_batch(paths, max_points=p)
            points[slots] = pts
            point_mask[slots] = msk

        s_from_g = np.linalg.inv(g_from_s)
        # trans[i, j] = T_{i<-j} = sensor_i_from_global @ global_from_sensor_j
        trans = np.einsum("iab,jbc->ijac", s_from_g, g_from_s)

        gboxes, gids = self.nusc.global_boxes(sample_token)
        gt_boxes = np.zeros((a, m, 5), np.float32)
        gt_mask = np.zeros((a, m), bool)
        gt_ids = np.full((a, m), -1, np.int32)  # real instance-track ids
        (x0, x1), (y0, y1) = (
            self.config.grid.area_extents[0],
            self.config.grid.area_extents[1],
        )
        for i in range(a):
            if not agent_mask[i] or len(gboxes) == 0:
                continue
            local = self._boxes_to_agent(gboxes, s_from_g[i], g_from_s[i])
            inside = (
                (local[:, 0] > x0)
                & (local[:, 0] < x1)
                & (local[:, 1] > y0)
                & (local[:, 1] < y1)
            )
            sel = np.nonzero(inside)[0][:m]
            gt_boxes[i, : len(sel)] = local[sel]
            gt_mask[i, : len(sel)] = True
            gt_ids[i, : len(sel)] = gids[sel]

        out = {
            "points": points,
            "point_mask": point_mask,
            "trans": trans.astype(np.float32),
            "agent_mask": agent_mask,
            "gt_boxes": gt_boxes,
            "gt_mask": gt_mask,
            "gt_ids": gt_ids,
        }
        if self.with_seg_labels:
            # The 8-class BEV label map: map-expansion polygons (road,
            # sidewalk, terrain, building, vegetation), then pedestrian
            # footprints, then vehicle footprints on top.
            class_polys = self._map_class_polygons(sample_token)
            pboxes, _ = self.nusc.global_boxes(sample_token, PEDESTRIAN_CATEGORY_PREFIX)
            extents = (self.config.grid.area_extents[0], self.config.grid.area_extents[1])
            seg = np.zeros((a,) + self.config.grid.bev_shape, np.int32)
            for i in range(a):
                if not agent_mask[i]:
                    continue
                seg[i] = build_seg_labels(
                    self.config,
                    gt_boxes[i][gt_mask[i]],
                    layer_polygons=transform_polygons(class_polys, s_from_g[i], extents),
                    pedestrian_boxes=self._boxes_to_agent(pboxes, s_from_g[i], g_from_s[i]),
                )
            out["seg_labels"] = seg
        return out

    def _map_class_polygons(self, sample_token: str):
        """Global-frame (class, polygons) of the sample's map location; none
        where the scene names no location or the root has no map for it."""
        location = self.nusc.map_location(sample_token)
        if location is None:
            return []
        if location not in self._maps:
            try:
                self._maps[location] = NuScenesMapExpansion(self.nusc.dataroot, location)
            except FileNotFoundError:
                self._maps[location] = None
        exp = self._maps[location]
        return [] if exp is None else exp.class_polygons(self.config.seg_class_names)

    @staticmethod
    def _boxes_to_agent(
        gboxes: np.ndarray, s_from_g: np.ndarray, g_from_s: np.ndarray
    ) -> np.ndarray:
        """Global-frame (M, 5) boxes -> one agent's frame."""
        if len(gboxes) == 0:
            return np.zeros((0, 5), np.float64)
        hom = np.concatenate(
            [gboxes[:, :2], np.zeros((len(gboxes), 1)), np.ones((len(gboxes), 1))],
            -1,
        )
        local_xy = (s_from_g @ hom.T).T[:, :2]
        sensor_yaw = np.arctan2(g_from_s[1, 0], g_from_s[0, 0])
        return np.stack(
            [
                local_xy[:, 0],
                local_xy[:, 1],
                gboxes[:, 2],
                gboxes[:, 3],
                gboxes[:, 4] - sensor_yaw,
            ],
            -1,
        )

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                shard: Tuple[int, int] = (0, 1)):
        """Yield stacked batches (host numpy) over the whole index; under
        ``shard=(i, n)`` data rank i's rows of each (``iter_batches``)."""
        from v2x_sim_tpu_torch.datasets.cache import iter_batches

        yield from iter_batches(self, batch_size, shuffle, seed, shard=shard)
