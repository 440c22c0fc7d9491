"""Offline preprocessing CLI.

Port of ``v2x_sim_tpu/tools/create_data_det.py``: walks a nuScenes-format
V2X-Sim root (or generates synthetic scenes) and writes one .npz scene
frame per sample into a cache directory that training and evaluation
stream from (``datasets/cache.py``; the same files as the JAX tool's).
With ``--targets 1`` it also bakes each frame's sparse anchor assignment,
computed with the frame's agents as the batch, so training skips the
assignment; with ``--vis 1`` it bakes each agent's visibility map
(``ops/visibility.py``) as int8 ``vis_maps``, which ``--use_vis 1``
training and evaluation read instead of carving them each batch. Like
every tool, it runs on the card unless ``--cpu`` is given.

    python -m v2x_sim_tpu_torch.tools.create_data_det --savepath CACHE --targets 1 --vis 1
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.datasets.cache import save_frame
from v2x_sim_tpu_torch.datasets.nuscenes import V2XSimDataset
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_scene
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.ops.assign import (
    assign_targets_batched,
    label_counts,
    sparse_label_idx,
    target_fingerprint,
)
from v2x_sim_tpu_torch.ops.visibility import DEFAULT_NUM_SAMPLES, visibility_batch
from v2x_sim_tpu_torch.tools.common import grid_config


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="synthetic", help="nuScenes-format root or 'synthetic'")
    p.add_argument("--split", default="train")
    p.add_argument("--savepath", required=True)
    p.add_argument("--scenes", type=int, default=4, help="synthetic scene count")
    p.add_argument("--frames", type=int, default=10, help="synthetic frames/scene")
    p.add_argument("--grid", default="full", choices=["full", "small"])
    p.add_argument("--rsu", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--uncompressed", action="store_true",
        help="write plain (uncompressed) .npz frames: ~3x the bytes, no zlib "
        "decompression on the read path",
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    p.add_argument(
        "--vis", type=int, default=0,
        help="also bake per-agent visibility maps (ops/visibility.py) into the "
        "cache, like the reference's vis_maps",
    )
    p.add_argument(
        "--vis_samples", type=int, default=None,
        help=f"ray samples per point (default {DEFAULT_NUM_SAMPLES}, the on-device "
        "fallback's count)",
    )
    p.add_argument(
        "--targets", type=int, default=0,
        help="also bake the sparse anchor-assignment targets into the cache; "
        "training then skips the per-batch rotated-IoU assignment. A geometry "
        "fingerprint (tgt_meta) lets training drop them if the grid or anchor "
        "config changed since baking",
    )
    return p.parse_args(argv)


def add_vis(frame: dict, config, device: torch.device, num_samples: Optional[int]) -> dict:
    """Bake the visibility maps of one frame's agents on ``device``, as
    (A, H, W, D) int8 ``vis_maps`` in {0, 1, 2}."""
    vis = visibility_batch(
        torch.from_numpy(frame["points"]).to(device),
        torch.from_numpy(frame["point_mask"]).to(device),
        config.grid,
        num_samples=DEFAULT_NUM_SAMPLES if num_samples is None else num_samples,
    )
    return dict(frame, vis_maps=vis.to(torch.int8).cpu().numpy())


def add_targets(frame: dict, config, anchors: torch.Tensor, caps: dict) -> dict:
    """Bake the sparse anchor assignment of one frame, its agents as the
    batch, on the device of ``anchors``.

    The dense label map is stored as padded positive and ignore flat-index
    lists (``tgt_pos_idx``, ``tgt_ign_idx``; ``DetModule.targets`` rebuilds
    it). ``caps`` holds the lists' capacities, sized off the first frame
    (twice its largest counts, rounded up to 128) and checked on every
    later frame, so that all frames stack into batches.
    """
    dev = anchors.device
    sp = assign_targets_batched(
        torch.from_numpy(frame["gt_boxes"]).to(dev),  # (A, M, 5)
        torch.from_numpy(frame["gt_mask"]).to(dev),
        anchors,
        config,
        flat="sparse",
    )
    h, w, k, _ = anchors.shape
    if "caps" not in caps:
        caps["caps"] = tuple(max(128, -(-2 * c // 128) * 128) for c in label_counts(sp.labels))
    cap_pos, cap_ign = caps["caps"]
    pos, ign, npos, nign = sparse_label_idx(sp.labels, cap_pos, cap_ign)
    if npos > cap_pos or nign > cap_ign:
        raise RuntimeError(
            f"label index capacity exceeded (pos {npos}/{cap_pos}, ign {nign}/{cap_ign}): this "
            "frame has far more positive or ignored anchors than the first one")
    frame = dict(frame)
    frame["tgt_pos_idx"] = pos.cpu().numpy()
    frame["tgt_ign_idx"] = ign.cpu().numpy()
    frame["tgt_cells"] = sp.cells.to(torch.int32).cpu().numpy()
    frame["tgt_wts"] = sp.wts.cpu().numpy().astype(np.float32)
    frame["tgt_reg"] = sp.reg.cpu().numpy().astype(np.float32)
    frame["tgt_meta"] = np.array(
        [h, w, k, sp.cells.shape[-1], target_fingerprint(config)], np.int32)
    return frame


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Write the cache; returns the number of frames written."""
    args = parse_args(argv)
    config = Config(grid=grid_config(args.grid))
    device = resolve_device("cpu" if args.cpu else None)
    anchors = torch.from_numpy(anchor_grid(config)).to(device) if args.targets else None
    caps: dict = {}

    def bake(frame):
        if args.vis:
            frame = add_vis(frame, config, device, args.vis_samples)
        return add_targets(frame, config, anchors, caps) if args.targets else frame

    out = os.path.join(args.savepath, args.split)
    count = 0
    if args.root == "synthetic":
        spec = SyntheticSpec(points_per_agent=2048 if args.grid == "small" else 8192)
        for si in range(args.scenes):
            for fi in range(args.frames):
                frame = generate_scene(config, spec, seed=args.seed + si * 10_007 + fi)
                save_frame(out, f"scene{si:04d}_frame{fi:03d}", bake(frame),
                           compress=not args.uncompressed)
                count += 1
    else:
        version = next(d for d in sorted(os.listdir(args.root)) if d.startswith("v1.0"))
        ds = V2XSimDataset(
            args.root, config, version=version, use_rsu=bool(args.rsu),
            # A scene-level partition, not only an output directory name:
            # the train and test caches hold disjoint scenes.
            split=args.split if args.split in ("train", "val", "test") else None,
        )
        for i in range(len(ds)):
            save_frame(out, f"frame{i:06d}", bake(ds[i]), compress=not args.uncompressed)
            count += 1
    print(f"wrote {count} frames to {out}")
    return count


if __name__ == "__main__":
    main()
