"""Host-side reader throughput: the native C++ loader against numpy, and
the .npz frame cache's read path.

Port of ``v2x_sim_tpu/tools/bench_loader.py``, with its flags and its JSON.
The default run writes a farm of synthetic ``.pcd.bin`` sweeps to a
temporary directory and times batched reads (read, truncate or pad, 4x4
transform) through ``native/loader.py::read_pcd_batch`` and its numpy
fallback. ``--cache`` times the cache instead: production-geometry frames
with their sparse targets baked (``tools/create_data_det.py::add_targets``,
on the card unless ``--cpu``) are written compressed and uncompressed and
read back serially and with 4 threads.

    python -m v2x_sim_tpu_torch.tools.bench_loader
    python -m v2x_sim_tpu_torch.tools.bench_loader --files 96 --points 30000
    python -m v2x_sim_tpu_torch.tools.bench_loader --cache --files 16
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.cache import NpzCacheDataset, save_frame
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_scene
from v2x_sim_tpu_torch.native.loader import _read_pcd_batch_numpy, native_available, read_pcd_batch
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.tools.common import tool_device
from v2x_sim_tpu_torch.tools.create_data_det import add_targets


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--files", type=int, default=48, help="sweeps per epoch (one per (scene, agent))")
    p.add_argument("--points", type=int, default=30_000,
                   help="points per sweep (V2X-Sim sweeps are ~20-35k)")
    p.add_argument("--max_points", type=int, default=8192)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--cache", action="store_true",
                   help="benchmark the .npz frame-cache read path instead (compressed vs "
                   "uncompressed x serial vs threaded batch reads)")
    p.add_argument("--cpu", action="store_true",
                   help="--cache: bake the targets on the CPU instead of the CUDA card")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark; prints and returns its JSON."""
    args = parse_args(argv)
    if args.cache:
        return bench_cache(args)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="v2x_loader_bench_") as d:
        paths = []
        for i in range(args.files):
            path = os.path.join(d, f"sweep_{i:04d}.pcd.bin")
            rng.standard_normal((args.points, 5)).astype(np.float32).tofile(path)
            paths.append(path)
        transforms = np.tile(np.eye(4, dtype=np.float32), (args.files, 1, 1))

        def timed(fn):
            fn()  # warm the page cache: steady-state epochs re-read it
            t0 = time.perf_counter()
            for _ in range(args.epochs):
                fn()
            return args.files * args.epochs / (time.perf_counter() - t0)

        native_sps = (
            timed(lambda: read_pcd_batch(paths, args.max_points, transforms=transforms))
            if native_available() else 0.0
        )
        numpy_sps = timed(lambda: _read_pcd_batch_numpy(paths, args.max_points, 5, transforms))
    out = {
        "files": args.files,
        "points_per_file": args.points,
        "max_points": args.max_points,
        "native_sweeps_per_sec": round(native_sps, 1),
        "numpy_sweeps_per_sec": round(numpy_sps, 1),
        "native_available": native_available(),
        "mb_per_sec_native": round(native_sps * args.points * 5 * 4 / 1e6, 1),
    }
    print(json.dumps(out))
    return out


def bench_cache(args) -> dict:
    """Frame-cache read throughput across the wire-format knobs: zlib
    decompression (``create_data_det --uncompressed`` drops it) against
    serial reads (``batches(workers=...)`` threads them), on
    production-geometry det frames with baked sparse targets."""
    device = tool_device(args.cpu)
    cfg = Config(grid=GridConfig())
    spec = SyntheticSpec()
    anchors = torch.from_numpy(anchor_grid(cfg)).to(device)
    out = {}
    with tempfile.TemporaryDirectory(prefix="v2x_cache_bench_") as d:
        caps: dict = {}
        frames = []
        for i in range(args.files):
            frame = generate_scene(cfg, spec, seed=60_000 + i)
            for k in ("visible", "gt_vehicle", "seg_labels"):
                frame.pop(k, None)
            frames.append(add_targets(frame, cfg, anchors, caps))
        for comp, tag in ((True, "compressed"), (False, "uncompressed")):
            sub = os.path.join(d, tag)
            for i, f in enumerate(frames):
                save_frame(sub, f"f{i:05d}", f, compress=comp)
            ds = NpzCacheDataset(sub)
            size_mb = sum(os.path.getsize(p) for p in ds.files) / 1e6
            for workers in (0, 4):
                next(iter(ds.batches(8, workers=workers)))  # warm the page cache
                t0 = time.perf_counter()
                for _ in range(args.epochs):
                    for _b in ds.batches(8, workers=workers):
                        pass
                out[f"{tag}_w{workers}_frames_per_sec"] = round(
                    args.files * args.epochs / (time.perf_counter() - t0), 1)
            out[f"{tag}_mb"] = round(size_mb, 1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
