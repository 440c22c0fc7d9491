"""Convert a JAX-package checkpoint into a checkpoint of the PyTorch port.

The JAX package's ``train_det`` and ``train_seg`` save their whole
``TrainState`` (params, BatchNorm statistics, optax's Adam state, step
count) as an orbax directory ``<logpath>/epoch_<n>``. This script
restores one against the ``TrainState`` of a JAX ``DetModule`` or
``SegModule`` built with the same task, mode and options (a restore
without that target yields plain dicts and lists, in which no Adam state
can be found), and writes the port's ``{"model", "optimizer", "step"}``
file ``<out>/epoch_<n>`` through ``v2x_sim_tpu_torch.bridge`` and
``v2x_sim_tpu_torch/train/checkpoint.py``. The port's ``train_det`` or
``train_seg`` then resumes it (``--resume <out>/epoch_<n>``, or
``--resume auto --logpath <out>``) and continues the JAX run step for
step; a converted upperbound checkpoint is the port's ``train_det
--teacher``.

Reading orbax needs JAX, so this is the one file that imports both
packages. It is not part of the port: run it where the JAX package is
installed, on the CPU (the machine with the card has no JAX):

    JAX_PLATFORMS=cpu python convert_jax_checkpoint.py det runs/jax/epoch_3 runs/torch \\
        --com disco --grid small

The options must be those the JAX run was trained with: ``--com``,
``--grad_clip`` (det: a clipped run's optimizer state has another
structure), ``--depth`` (seg), the grid and model flags ``--grid``,
``--layer``, ``--width_mult`` and ``--use_vis`` (det), and ``--lr``,
which the port's optimizer state carries into the resumed run.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Optional, Sequence

import jax
import numpy as np

from v2x_sim_tpu.datasets.synthetic import SyntheticSpec as JaxSpec
from v2x_sim_tpu.datasets.synthetic import generate_batch as jax_generate_batch
from v2x_sim_tpu.tools.common import COM_ALIASES
from v2x_sim_tpu.tools.common import build_config as jax_build_config
from v2x_sim_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.train.seg_module import SegModule as JaxSegModule
from v2x_sim_tpu_torch.bridge import adam_state_from_optax
from v2x_sim_tpu_torch.tools.common import build_config
from v2x_sim_tpu_torch.train.checkpoint import save_checkpoint
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.train.seg_module import SegModule


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("task", choices=["det", "seg"])
    p.add_argument("src", help="the JAX run's orbax checkpoint directory, epoch_<n>")
    p.add_argument("out", help="directory for the port's epoch_<n> file")
    p.add_argument("--com", default="lowerbound", choices=sorted(COM_ALIASES))
    p.add_argument("--grid", default="full", choices=["full", "small"])
    p.add_argument("--layer", type=int, default=3, help="fusion encoder stage")
    p.add_argument("--width_mult", type=float, default=1.0)
    p.add_argument("--use_vis", type=int, default=0, help="det: visibility input channels")
    p.add_argument("--grad_clip", type=float, default=0.0, help="det: the run's global-norm clip")
    p.add_argument("--depth", type=int, default=4, help="seg: UNet depth")
    p.add_argument("--lr", type=float, default=1e-3)
    return p.parse_args(argv)


def _modules(args, mode: str):
    """The JAX module whose TrainState the checkpoint holds, and the
    port's module of the same configuration on the CPU."""
    jcfg, cfg = jax_build_config(args), build_config(args)
    if args.task == "det":
        kw = dict(learning_rate=args.lr, width_mult=args.width_mult, use_vis=bool(args.use_vis),
                  grad_clip=args.grad_clip)
        return JaxDetModule(jcfg, mode=mode, **kw), DetModule(cfg, mode, device="cpu", **kw)
    kw = dict(learning_rate=args.lr, width_mult=args.width_mult, depth=args.depth)
    return JaxSegModule(jcfg, mode=mode, **kw), SegModule(cfg, mode, device="cpu", **kw)


def convert(args: argparse.Namespace) -> str:
    """Convert ``args.src`` into ``<args.out>/epoch_<n>``; returns its path."""
    match = re.fullmatch(r"epoch_(\d+)", os.path.basename(os.path.normpath(args.src)))
    if match is None:
        raise ValueError(f"{args.src}: not an epoch_<n> checkpoint directory")
    mode = COM_ALIASES[args.com]
    jmod, port = _modules(args, mode)
    # The target's shapes come from an init on one small synthetic scene.
    scene = jax_generate_batch(jmod.config, JaxSpec(points_per_agent=256), batch_size=1, seed=0)
    target = jmod.init(jax.random.PRNGKey(0), {k: v for k, v in scene.items() if k != "visible"})
    state = jax.tree.map(np.asarray, jax_restore_checkpoint(args.src, target))
    port.load_flax_variables({"params": state.params, "batch_stats": state.batch_stats})
    adam_state_from_optax(state.opt_state, port)
    port.step = int(state.step)
    return save_checkpoint(args.out, port, int(match.group(1)))


def main(argv: Optional[Sequence[str]] = None) -> str:
    path = convert(parse_args(argv))
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
