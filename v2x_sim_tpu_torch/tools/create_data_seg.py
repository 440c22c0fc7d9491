"""Offline preprocessing for segmentation.

Port of ``v2x_sim_tpu/tools/create_data_seg.py``: the frames of
``create_data_det`` (synthetic scenes, or each sample of a nuScenes-format
V2X-Sim root) with their BEV semantic label maps (``seg_labels``: vehicle
footprints on synthetic scenes; map-expansion polygons, pedestrians and
vehicles on a nuScenes root), one .npz per frame, the same files as the
JAX tool's. Host work only: it uses no device.

    python -m v2x_sim_tpu_torch.tools.create_data_seg --savepath CACHE
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.datasets.cache import save_frame
from v2x_sim_tpu_torch.datasets.nuscenes import V2XSimDataset
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_scene
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
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Write the cache; returns the number of frames written."""
    args = parse_args(argv)
    config = Config(grid=grid_config(args.grid))
    out = os.path.join(args.savepath, args.split)
    count = 0
    if args.root == "synthetic":
        spec = SyntheticSpec(points_per_agent=2048 if args.grid == "small" else 8192)
        for si in range(args.scenes):
            for fi in range(args.frames):
                frame = generate_scene(config, spec, seed=args.seed + si * 10_007 + fi)
                save_frame(out, f"scene{si:04d}_frame{fi:03d}", frame,
                           compress=not args.uncompressed)
                count += 1
    else:
        version = next(d for d in sorted(os.listdir(args.root)) if d.startswith("v1.0"))
        ds = V2XSimDataset(
            args.root, config, version=version, use_rsu=bool(args.rsu), with_seg_labels=True,
            split=args.split if args.split in ("train", "val", "test") else None,
        )
        for i in range(len(ds)):
            save_frame(out, f"frame{i:06d}", ds[i], compress=not args.uncompressed)
            count += 1
    print(f"wrote {count} frames to {out}")
    return count


if __name__ == "__main__":
    main()
