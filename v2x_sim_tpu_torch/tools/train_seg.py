"""Segmentation training CLI.

Port of ``v2x_sim_tpu/tools/train_seg.py`` (the reference's
``train_seg.py``): the reference's flag names, Adam without gradient
clipping, per-epoch checkpoints (``train/checkpoint.py``), ``--resume``
(a path, or ``auto`` for the newest under ``--logpath``; the run restarts
at epoch step // batches_per_epoch), a ``log.txt`` and structured
``metrics.jsonl`` in the run directory, and scenes/sec.

    python -m v2x_sim_tpu_torch.tools.train_seg --com disco --data CACHE --batch 16

Fresh weights are drawn as flax's defaults (``SegModule.init_weights``).
Batches go through ``datasets/loader.py::device_prefetch`` (upload and
voxelization in the prefetch thread, on its own CUDA stream); the loss is
read on the host every step, as the JAX tool does. A nuScenes root is read
without seg labels, as the JAX tool reads it: train from a
``create_data_seg`` cache.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

from v2x_sim_tpu_torch.datasets.loader import device_prefetch
from v2x_sim_tpu_torch.tools.common import (
    add_common_args,
    build_config,
    device_and_dtype,
    make_batches,
    reject_use_vis,
    resolve_mode,
)
from v2x_sim_tpu_torch.tools.train_det import TrainRun
from v2x_sim_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from v2x_sim_tpu_torch.train.seg_module import BATCH_KEYS, SegModule
from v2x_sim_tpu_torch.utils.meters import RunLogger, StepTimer


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--nepoch", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batches_per_epoch", type=int, default=8)
    args = p.parse_args(argv)
    reject_use_vis(p, args)
    return args


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    config = build_config(args)
    mode = resolve_mode(args)
    device, dtype = device_and_dtype(args)
    logger = RunLogger(args.logpath)
    try:
        return _train(args, config, mode, device, dtype, logger)
    finally:
        logger.close()


def _train(args, config, mode, device, dtype, logger) -> TrainRun:
    logger.log(f"train_seg mode={mode} grid={config.grid.grid_shape} device={device} args={vars(args)}")
    module = SegModule(config, mode, dtype, device, learning_rate=args.lr,
                       width_mult=args.width_mult)
    module.init_weights(args.seed)
    start_epoch = 0
    if args.resume:
        path = args.resume if args.resume != "auto" else latest_checkpoint(args.logpath)
        if path:
            restore_checkpoint(path, module)
            start_epoch = module.step // args.batches_per_epoch
            logger.log(f"resumed from {path} at epoch {start_epoch} (step {module.step})")
    start_step = module.step

    def host_batches(epoch):
        for raw in make_batches(args, config, split_seed=epoch * 1000,
                                num_batches=args.batches_per_epoch):
            yield {k: v for k, v in raw.items() if k in BATCH_KEYS}

    timer = StepTimer(scenes_per_step=args.batch)
    epoch_rates: List[float] = []
    vals: dict = {}
    for epoch in range(start_epoch, args.nepoch):
        t0, scenes = time.perf_counter(), 0
        for prepared in device_prefetch(host_batches(epoch), module.prepare_batch, device=device):
            metrics = module.train_step(prepared)
            scenes += prepared["agent_mask"].shape[0]
            vals = {k: float(v) for k, v in metrics.items()}  # waits for the device
            rate = timer.tick()
            if rate:
                vals["scenes_per_sec"] = rate
            logger.metrics(module.step, vals)
        if not scenes:
            raise RuntimeError(f"epoch {epoch}: the data source yielded no batch")
        epoch_rates.append(scenes / (time.perf_counter() - t0))
        logger.log(f"epoch {epoch}: loss={vals['loss']:.4f} scenes/s={epoch_rates[-1]:.2f}")
        logger.log(f"saved {save_checkpoint(args.logpath, module, epoch)}")
    return TrainRun(start_epoch, start_step, module.step, vals, epoch_rates)


if __name__ == "__main__":
    main()
