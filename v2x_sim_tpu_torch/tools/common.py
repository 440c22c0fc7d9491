"""Shared CLI plumbing for the tools.

Port of ``v2x_sim_tpu/tools/common.py``: the reference's flag surface
(``--com``, ``--layer``, ``--rsu``, ``--warp_flag``, ``--resume``, ...),
the config and mode they select, the baked-target staleness guard and the
batch sources (synthetic scenes, a nuScenes-format root, an .npz cache).

Every tool runs on the CUDA card unless ``--cpu`` is given; without a card
and without ``--cpu`` it raises. ``--bf16`` selects bf16 activations; the
tools run with TF32 off in cuDNN and in matrix products, so that fp32
means fp32. ``--use_vis 1`` feeds the det model the visibility maps (baked
by ``create_data_det --vis 1``, else carved on the device each batch);
the seg tools reject it.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
from typing import Iterator, Tuple

import numpy as np
import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.cache import NpzCacheDataset
from v2x_sim_tpu_torch.datasets.nuscenes import V2XSimDataset
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import FUSION_KEYWORDS
from v2x_sim_tpu_torch.ops.assign import sparse_cell_capacity, target_fingerprint

#: The reference's --com spellings -> internal mode names.
COM_ALIASES = {
    "none": "lowerbound",
    "lowerbound": "lowerbound",
    "upperbound": "upperbound",
    "when2com": "when2com",
    "who2com": "who2com",
    "v2v": "v2v",
    "v2vnet": "v2v",
    "disco": "disco",
    "disconet": "disco",
    "sum": "sum",
    "mean": "mean",
    "max": "max",
    "cat": "cat",
    "agent": "agent",
}

#: The 64x64x8 BEV grid of ``--grid small`` (CPU runs).
SMALL_VOXEL = (1.0, 1.0, 0.625)


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--data",
        default="synthetic",
        help="nuScenes-format V2X-Sim root, .npz cache dir from create_data_det, or 'synthetic'",
    )
    p.add_argument(
        "--com", default="lowerbound", choices=sorted(COM_ALIASES),
        help="collaboration strategy (reference --com)",
    )
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--layer", type=int, default=3, help="fusion encoder stage")
    p.add_argument("--rsu", type=int, default=1, help="include the RSU agent")
    p.add_argument("--warp_flag", type=int, default=1)
    p.add_argument("--logpath", default="runs/default")
    p.add_argument("--resume", default="", help="checkpoint path to resume, or 'auto'")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    p.add_argument(
        "--grid", default="full", choices=["full", "small"],
        help="small = 64x64 BEV for CPU smoke runs",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bfloat16 activations")
    p.add_argument(
        "--width_mult", type=float, default=1.0,
        help="uniform channel scale on the backbone stages (1.0 = reference "
        "widths; 0.25 = CI-cost model, same architecture)",
    )
    p.add_argument(
        "--use_vis", type=int, default=0,
        help="feed visibility maps (the reference's vis_maps) as extra input "
        "channels; bake them with create_data_det --vis 1 for full-speed runs",
    )


#: A fusion setting (``FUSION_KEYWORDS``) -> the tools' flag that sets it
#: and the flag's type: ``--warp_flag``, and bench_table's
#: ``--v2v_rounds`` and ``--v2v_msg_norm``.
SETTING_FLAGS = {"warp_flag": ("warp_flag", bool), "rounds": ("v2v_rounds", int),
                 "msg_norm": ("v2v_msg_norm", bool)}


def fusion_settings(args, mode: str) -> dict:
    """``DetModule``'s ``fusion`` for ``mode`` from the flags ``args``
    has: only the settings ``FUSION_KEYWORDS[mode]`` lists."""
    known = FUSION_KEYWORDS.get(mode, {})
    return {key: kind(getattr(args, flag)) for key, (flag, kind) in SETTING_FLAGS.items()
            if key in known and hasattr(args, flag)}


def reject_use_vis(p: argparse.ArgumentParser, args) -> None:
    """The seg tools' guard: the segmenter takes no visibility input, so
    ``--use_vis 1`` exits with a usage error (the JAX seg tools ignore it)."""
    if args.use_vis:
        p.error("--use_vis: the segmenter takes no visibility input")


def grid_config(name: str) -> GridConfig:
    """The BEV grid of ``--grid full`` (256x256x13) or ``small`` (64x64x8)."""
    return GridConfig(voxel_size=SMALL_VOXEL) if name == "small" else GridConfig()


def build_config(args) -> Config:
    return Config(grid=grid_config(args.grid), fusion_layer=args.layer)


def resolve_mode(args) -> str:
    return COM_ALIASES[args.com]


def tool_device(cpu: bool) -> torch.device:
    """The card, or the CPU when ``cpu`` (raises without a card
    otherwise); turns TF32 off."""
    device = resolve_device("cpu" if cpu else None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def device_and_dtype(args) -> Tuple[torch.device, torch.dtype]:
    """The device (``tool_device(args.cpu)``) and the activation dtype."""
    return tool_device(args.cpu), torch.bfloat16 if args.bf16 else torch.float32


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device: torch.device) -> str:
    """What a timing was taken on: ``CPU``, or the (first) card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    if device.type != "cuda":
        return "CPU"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def strip_stale_targets(raw: dict, config: Config) -> dict:
    """Guard for baked anchor targets (create_data_det --targets 1).

    Compares the cache's ``tgt_meta`` = [H, W, K, Pc, crc], where crc is
    ``ops.assign.target_fingerprint`` (the anchor table and assignment
    thresholds), against the live config. On a mismatch every ``tgt_*``
    key is dropped, so training assigns targets on the device instead of
    optimizing against another config's. Metas without the crc are stale
    too: they cannot prove their anchor table. ``tgt_meta`` itself is
    always removed: it is host-side metadata, not a device input."""
    if "tgt_meta" not in raw:
        return raw
    h, w = config.grid.bev_shape
    k = config.anchors.num_anchors
    arr = np.asarray(raw["tgt_meta"])
    meta = tuple(int(x) for x in arr.reshape(-1, arr.shape[-1])[0])
    want = (h, w, k, sparse_cell_capacity(config), target_fingerprint(config))
    if meta == want:
        return {key: v for key, v in raw.items() if key != "tgt_meta"}
    return {key: v for key, v in raw.items() if not key.startswith("tgt_")}


def make_batches(
    args, config: Config, split_seed: int = 0, num_batches: int = 8, shuffle: bool = True,
    shard: Tuple[int, int] = (0, 1),
) -> Iterator[dict]:
    """Yield host batches from synthetic scenes, an .npz cache, or a
    nuScenes-format root.

    ``num_batches`` and ``split_seed`` apply to every source. Evaluation
    passes shuffle=False so dumped detections stay in temporal order for
    tracking. ``shard=(r, n)`` makes and loads only data rank r's rows
    ``[r·B/n, (r+1)·B/n)`` of each batch of B (``parallel/mesh.py::
    shard_batch``'s rows), and raises when B does not split over n.
    """
    if args.data == "synthetic":
        spec = SyntheticSpec(points_per_agent=2048 if args.grid == "small" else 8192)
        r, n = shard
        if args.batch % n:
            raise ValueError(f"a batch of {args.batch} scenes does not split over {n} ranks")
        rows = slice(r * args.batch // n, (r + 1) * args.batch // n)
        for i in range(num_batches):
            batch = generate_batch(config, spec, args.batch, seed=args.seed + split_seed + i,
                                   rows=rows)
            if not args.rsu:
                # Reference --rsu 0: drop the road-side unit (agent 0).
                batch["agent_mask"] = batch["agent_mask"].copy()
                batch["agent_mask"][:, 0] = False
            yield batch
    elif os.path.isdir(os.path.join(args.data, "v1.0-mini")) or any(
        d.startswith("v1.0") for d in os.listdir(args.data)
    ):
        version = next(d for d in sorted(os.listdir(args.data)) if d.startswith("v1.0"))
        ds = V2XSimDataset(args.data, config, version=version, use_rsu=bool(args.rsu))
        yield from itertools.islice(
            ds.batches(args.batch, shuffle=shuffle, seed=args.seed + split_seed, shard=shard),
            num_batches)
    else:
        ds = NpzCacheDataset(args.data)
        yield from itertools.islice(
            ds.batches(args.batch, shuffle=shuffle, seed=args.seed + split_seed, shard=shard),
            num_batches)
