"""Detection training CLI.

Port of ``v2x_sim_tpu/tools/train_det.py`` (the reference's
``train_codet.py``): the reference's flag names, Adam, per-epoch
checkpoints (``train/checkpoint.py``), ``--resume`` (a path, or ``auto``
for the newest under ``--logpath``), DiscoNet's KD teacher, a ``log.txt``
and structured ``metrics.jsonl`` in the run directory, and scenes/sec.

    python -m v2x_sim_tpu_torch.tools.train_det --com disco --data CACHE --batch 16

Fresh weights are drawn as flax's defaults (``DetModule.init_weights``).
Batches go through ``datasets/loader.py::device_prefetch``: the host
batch's upload and ``DetModule.prepare_batch`` (voxelize, and the anchor
assignment unless the cache holds baked targets) run in the prefetch
thread on their own CUDA stream, overlapping the previous step. Metrics
are read on the host only every ``--log_every`` steps and at the end of
each epoch. ``--MGDA`` balances the cls, loc and KD task gradients by
MGDA (``utils/mgda.py``); ``--use_vis 1`` feeds the visibility maps.

``--dp N`` trains data-parallel on N ranks that this command spawns, one
CUDA card a rank over NCCL (``--cpu``: N CPU processes over gloo).
``--batch`` stays the global batch: each rank makes or loads only its
rows of every batch (``make_batches``' ``shard``, the rows of
``parallel/mesh.py::shard_batch``), so ``--dp N`` trains on the same
scenes as ``--dp 0``, and the step is the single-process step on
the global batch (``DetModule``'s ``process_group``). Rank 0 logs and
writes the checkpoints; ``--resume`` loads on every rank, then rank 0's
state is broadcast. It raises when the batch does not split into N, and
when the host has fewer than N cards without ``--cpu``.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from datetime import timedelta
from typing import List, NamedTuple, Optional, Sequence

import torch

from v2x_sim_tpu_torch.datasets.loader import device_prefetch
from v2x_sim_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT, Mesh, make_mesh, replicate, spawn
from v2x_sim_tpu_torch.tools.common import (
    add_common_args,
    build_config,
    device_and_dtype,
    fusion_settings,
    make_batches,
    resolve_mode,
    strip_stale_targets,
    tool_device,
)
from v2x_sim_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    restore_teacher,
    save_checkpoint,
)
from v2x_sim_tpu_torch.train.det_module import BATCH_KEYS, DetModule
from v2x_sim_tpu_torch.utils.meters import RunLogger, StepTimer


#: Seconds a --dp run's ranks may take in all, and that each rendezvous
#: and collective may wait (None: no limit on the run, and make_mesh's
#: default wait).
DP_TIMEOUT: Optional[float] = None


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--nepoch", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument(
        "--grad_clip", type=float, default=0.0,
        help="global-norm gradient clip before Adam (0 = off)",
    )
    p.add_argument("--kd_flag", type=int, default=0)
    p.add_argument("--kd_weight", type=float, default=1e5)
    p.add_argument("--teacher", default="", help="checkpoint of the early-fusion (upperbound) teacher")
    p.add_argument("--MGDA", dest="mgda", action="store_true",
                   help="balance the task gradients by MGDA (the reference's --MGDA)")
    p.add_argument("--batches_per_epoch", type=int, default=8)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks, one card each (0 = one process); --batch is global")
    p.add_argument(
        "--log_every", type=int, default=20,
        help="read metrics on the host every N steps (and at the end of each "
        "epoch). Each read waits for the device; 1 logs every batch",
    )
    return p.parse_args(argv)


class TrainRun(NamedTuple):
    """What a run did: the epoch and step count it started from, the step
    count it ended at, the last metrics read, and each epoch's scenes/sec
    (its batches over the host clock from its start to the end-of-epoch
    metrics read, which waits for the device)."""

    start_epoch: int
    start_step: int
    step: int
    metrics: dict
    epoch_scenes_per_sec: List[float]


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    if args.dp:
        return _spawn_ranks(args)
    device, dtype = device_and_dtype(args)
    logger = RunLogger(args.logpath)
    try:
        return _train(args, device, dtype, logger)
    finally:
        logger.close()


def _spawn_ranks(args) -> TrainRun:
    """Check the layout, spawn the --dp ranks, return rank 0's run."""
    if args.batch % args.dp:
        raise ValueError(f"--batch {args.batch} does not split over --dp {args.dp} ranks")
    if not args.cpu:
        tool_device(False)  # raises without a card
        if torch.cuda.device_count() < args.dp:
            raise RuntimeError(f"--dp {args.dp} needs {args.dp} CUDA cards, this host has "
                               f"{torch.cuda.device_count()}; pass --cpu to run on the CPU")
    with tempfile.TemporaryDirectory() as store:
        return spawn(_rank_main, args.dp, (args, DP_TIMEOUT), store_dir=store,
                     timeout=DP_TIMEOUT)[0]


def _rank_main(rank: int, world: int, init_method: str, args,
               timeout: Optional[float]) -> Optional[TrainRun]:
    """One --dp rank: its mesh, then the training loop on its rows."""
    if args.cpu:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    mesh = make_mesh(world, rank=rank, init_method=init_method, device="cpu" if args.cpu else None,
                     timeout=DEFAULT_TIMEOUT if timeout is None else timedelta(seconds=timeout))
    _, dtype = device_and_dtype(args)
    logger = RunLogger(args.logpath) if rank == 0 else _Silent()
    try:
        run = _train(args, mesh.device, dtype, logger, mesh)
    finally:
        logger.close()
    return run if rank == 0 else None


class _Silent:
    """The logger of the ranks other than 0."""

    def log(self, msg: str) -> None:
        pass

    def metrics(self, step: int, values: dict, prefix: str = "") -> None:
        pass

    def close(self) -> None:
        pass


def _train(args, device, dtype, logger, mesh: Optional[Mesh] = None) -> TrainRun:
    config = build_config(args)
    mode = resolve_mode(args)
    kd_weight = args.kd_weight if args.kd_flag else 0.0
    logger.log(f"train_det mode={mode} grid={config.grid.grid_shape} device={device} args={vars(args)}")
    module = DetModule(
        config, mode, dtype, device, learning_rate=args.lr, grad_clip=args.grad_clip,
        width_mult=args.width_mult, kd_weight=kd_weight, fusion=fusion_settings(args, mode),
        use_vis=bool(args.use_vis), mgda=args.mgda,
        process_group=None if mesh is None else mesh.data_group,
    )
    module.init_weights(args.seed)
    if kd_weight > 0.0:
        if args.teacher:
            restore_teacher(args.teacher, module)
            logger.log(f"loaded teacher from {args.teacher}")
        else:
            module.init_teacher_weights(args.seed + 1)
            logger.log(f"no --teacher: KD against a teacher with fresh weights (seed {args.seed + 1})")

    start_epoch = 0
    if args.resume:
        path = args.resume if args.resume != "auto" else latest_checkpoint(args.logpath)
        if path:
            restore_checkpoint(path, module)
            start_epoch = module.step // args.batches_per_epoch
            logger.log(f"resumed from {path} at epoch {start_epoch} (step {module.step})")
    if mesh is not None:
        replicate(module, mesh)
    start_step = module.step

    def host_batches(epoch):
        """The epoch's host batches, stale targets dropped, only the keys
        the module reads (they are uploaded as they are); under --dp only
        this rank's rows of them are made or loaded."""
        shard = (0, 1) if mesh is None else (mesh.data_index, mesh.shape[0])
        for raw in make_batches(args, config, split_seed=epoch * 1000,
                                num_batches=args.batches_per_epoch, shard=shard):
            raw = strip_stale_targets(raw, config)
            yield {k: v for k, v in raw.items() if k in BATCH_KEYS}

    timer = StepTimer(scenes_per_step=args.batch)
    epoch_rates: List[float] = []
    vals: dict = {}
    for epoch in range(start_epoch, args.nepoch):
        t0, scenes, metrics = time.perf_counter(), 0, None
        for bi, prepared in enumerate(
            device_prefetch(host_batches(epoch), module.prepare_batch, device=device)
        ):
            metrics = module.train_step(prepared)
            scenes += prepared["agent_mask"].shape[0] * (1 if mesh is None else mesh.shape[0])
            rate = timer.tick()
            if bi % max(1, args.log_every) == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                if rate:
                    vals["scenes_per_sec"] = rate
                logger.metrics(module.step, vals)
        if metrics is None:
            raise RuntimeError(f"epoch {epoch}: the data source yielded no batch")
        vals = {k: float(v) for k, v in metrics.items()}  # waits for the device
        epoch_rates.append(scenes / (time.perf_counter() - t0))
        logger.metrics(module.step, vals)
        logger.log(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in vals.items())
                   + f" scenes/s={epoch_rates[-1]:.2f}")
        if mesh is None or mesh.rank == 0:
            logger.log(f"saved {save_checkpoint(args.logpath, module, epoch)}")
    return TrainRun(start_epoch, start_step, module.step, vals, epoch_rates)


if __name__ == "__main__":
    main()
