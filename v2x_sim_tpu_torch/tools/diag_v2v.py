"""V2VNet numerical-health diagnostic.

Port of ``v2x_sim_tpu/tools/diag_v2v.py``, with its flags and its JSON
records. It trains v2v for ``--steps`` and, every ``--probe_every`` steps,
records the ConvGRU gate statistics of one eval-mode forward of a fixed
probe batch (``models/convrnn.py::gru_diagnostics``: the update gate's
mean and saturated shares, the reset gate's mean, the candidate, hidden
and input magnitudes; one row per GNN round) beside the training loss.
Healthy training keeps the gates off the rails (saturated shares << 1)
and the hidden magnitudes stable over rounds. Runs on the card unless
``--cpu`` is given.

    python -m v2x_sim_tpu_torch.tools.diag_v2v --grid full --agents 6 --steps 600 --probe_every 100
    python -m v2x_sim_tpu_torch.tools.diag_v2v --cpu --grid tiny --agents 2 \\
        --width_mult 0.25 --steps 60 --probe_every 20
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import torch

from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
from v2x_sim_tpu_torch.models.convrnn import GRU_STATS, gru_diagnostics
from v2x_sim_tpu_torch.tools.bench_table import build_config, build_spec
from v2x_sim_tpu_torch.tools.common import fusion_settings, tool_device
from v2x_sim_tpu_torch.train.det_module import DetModule


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid", default="full", choices=["tiny", "tiny1m", "small", "medium", "full"])
    p.add_argument("--agents", type=int, default=6)
    p.add_argument("--width_mult", type=float, default=1.0)
    p.add_argument("--rounds", dest="v2v_rounds", type=int, default=3)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--probe_every", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--occlusion", type=float, default=0.45)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    return p.parse_args(argv)


def gru_probe(module: DetModule, probe: dict) -> torch.Tensor:
    """(rounds, 7) float32 gate statistics of one eval-mode forward of the
    prepared ``probe`` (``occupancy``, ``trans``, ``agent_mask``)."""
    with torch.no_grad(), gru_diagnostics(module.model) as rows:
        module.model(probe["occupancy"], probe["trans"], probe["agent_mask"].to(torch.bool))
    return torch.stack(rows)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Train and probe; returns the printed records."""
    args = parse_args(argv)
    device = tool_device(args.cpu)
    config = build_config(args)
    spec = build_spec(args)
    mod = DetModule(config, mode="v2v", device=device, learning_rate=args.lr,
                    width_mult=args.width_mult, fusion=fusion_settings(args, "v2v"))
    mod.init_weights(args.seed)
    bt = mod.to_device(generate_batch(config, spec, batch_size=args.batch, seed=990_000))
    probe = {"occupancy": mod.model_input(bt), "trans": bt["trans"], "agent_mask": bt["agent_mask"]}

    records = []
    loss = float("nan")
    for s in range(args.steps + 1):
        if s % args.probe_every == 0:
            stats = gru_probe(mod, probe).cpu().numpy()
            records.append({
                "step": s,
                "loss": None if s == 0 else round(float(loss), 4),
                "gru_rounds": [{c: round(float(v), 4) for c, v in zip(GRU_STATS, row)}
                               for row in stats],
            })
            print(json.dumps(records[-1]), flush=True)
        if s == args.steps:
            break
        raw = generate_batch(config, spec, batch_size=args.batch, seed=10_000 + s)
        loss = mod.train_step(mod.prepare_batch(raw))["loss"]
    return records


if __name__ == "__main__":
    main()
