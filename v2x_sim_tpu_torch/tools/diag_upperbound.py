"""Upperbound-at-production-geometry diagnostic.

Port of ``v2x_sim_tpu/tools/diag_upperbound.py``, with its flags and its
JSONL records. Each mode of ``--modes`` trains under bench_table's pool
regime (same generator, same baked sparse targets, same schedule), and
every ``--probe_every`` steps a probe records:

  * the BatchNorm train/eval gap: held-out cls and loc losses under the
    running statistics (``_run``) and under the batch statistics
    (``_bat``);
  * the gradient's global norm on a held-out batch, and per subtree
    (``g_encoder``, ``g_decoder``, ``g_cls_head``, ``g_reg_head``);
  * anchor score statistics: the mean and max predicted vehicle
    probability at positive and at background anchors, and the anchors a
    scene above ``--score_threshold``;
  * mAP@0.5 on held-out scenes and on two training-pool batches.

A probe leaves the run it observes exactly as it found it: the port's
train-mode BatchNorm updates the running statistics in place (JAX's
probe throws its mutated ``batch_stats`` away), so the batch-statistics
loss and the gradient run on a snapshot of every buffer that is put
back after; gradients come from ``torch.autograd.grad``, which leaves
``.grad`` and the optimizer alone. Runs on the card unless ``--cpu``.

    python -m v2x_sim_tpu_torch.tools.diag_upperbound --steps 3000 \\
        --probe_every 500 --data_pool 150 --cosine
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from v2x_sim_tpu_torch.datasets.synthetic import generate_batch
from v2x_sim_tpu_torch.tools.bench_table import (
    OUT_DIR,
    _host,
    _learning_rate,
    _train_stream,
    build_config,
    build_spec,
)
from v2x_sim_tpu_torch.tools.common import tool_device
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.utils.mean_ap import eval_map_agents

#: The subtrees whose gradient norms a probe reports beside the global one.
SUBTREES = ("encoder", "decoder", "cls_head", "reg_head")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--modes", default="upperbound,lowerbound,disco")
    p.add_argument("--grid", default="full", choices=["tiny", "tiny1m", "small", "medium", "full"])
    p.add_argument("--agents", type=int, default=6)
    p.add_argument("--width_mult", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--probe_every", type=int, default=500)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--cosine", action="store_true")
    p.add_argument("--grad_clip", type=float, default=0.0)
    p.add_argument("--occlusion", type=float, default=0.45)
    p.add_argument("--lidar_range", type=float, default=0.0, help="see bench_table --lidar_range")
    p.add_argument("--data_pool", type=int, default=150)
    p.add_argument("--bake_pool", type=int, default=1)
    p.add_argument("--task", default="det")  # bench_table._train_stream's contract
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_batches", type=int, default=3)
    p.add_argument("--score_threshold", type=float, default=0.05)
    p.add_argument("--nms_iou", type=float, default=0.1)
    p.add_argument("--max_boxes", type=int, default=16)
    p.add_argument("--out", default=os.path.join(OUT_DIR, "diag_upperbound.jsonl"))
    p.add_argument(
        "--arms", default="",
        help="semicolon list of LR:CLIP:SCHED arms (SCHED in {const,cosine}), e.g. "
        "'3e-3:0:const;1e-3:0:const;3e-3:1.0:const'. Each arm trains every --modes mode "
        "with that optimizer config, sharing the pool. Empty = one arm from "
        "--lr/--cosine/--grad_clip",
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    return p.parse_args(argv)


@contextlib.contextmanager
def preserved_buffers(model: torch.nn.Module) -> Iterator[None]:
    """Put every buffer of ``model`` (BatchNorm's running statistics) back
    as it was on entry, whatever the block ran in BatchNorm's training mode."""
    saved = [(b, b.detach().clone()) for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def held_losses(mod: DetModule, prepared: dict, train: bool) -> dict:
    """cls and loc losses of a prepared batch, BatchNorm on the running
    (``train=False``) or the batch statistics; moves no state."""
    with torch.no_grad(), preserved_buffers(mod.model):
        _, metrics = mod.loss(prepared, train=train)
    return {k: float(metrics[k]) for k in ("cls_loss", "loc_loss")}


def grad_norms(mod: DetModule, prepared: dict) -> dict:
    """Global and per-subtree norms of the train-mode loss's gradient;
    moves no state (no ``.grad`` is written)."""
    named = list(mod.model.named_parameters())
    with preserved_buffers(mod.model):
        loss, _ = mod.loss(prepared, train=True)
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)

    def norm(keep: Callable[[str], bool]) -> float:
        sq = [g.double().square().sum() for (n, _), g in zip(named, grads) if g is not None and keep(n)]
        return float(torch.stack(sq).sum().sqrt()) if sq else 0.0

    out = {"grad_norm": norm(lambda n: True)}
    for key in SUBTREES:
        if any(n.startswith(key + ".") for n, _ in named):
            out[f"g_{key}"] = norm(lambda n, key=key: n.startswith(key + "."))
    return out


@torch.no_grad()
def score_stats(mod: DetModule, prepared: dict, score_threshold: float) -> dict:
    """Predicted vehicle probability at positive and background anchors of
    a prepared batch, BatchNorm on the running statistics."""
    am = prepared["agent_mask"]
    out = mod.model(prepared["occupancy"], prepared["trans"], am.to(torch.bool))
    b, a = am.shape
    x = out.cls_logits.reshape(b, a, -1).float()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    p1 = torch.exp(x1 - torch.logaddexp(x0, x1))
    lab = prepared["labels"].reshape(b, a, -1)
    pos, bg = lab > 0, lab == 0
    npos = pos.sum().clamp(min=1)
    nbg = bg.sum().clamp(min=1)
    above = p1 > score_threshold
    return {
        "pos_p_mean": float((p1 * pos).sum() / npos),
        "pos_p_max": float(torch.where(pos, p1, 0.0).max()),
        "bg_p_mean": float((p1 * bg).sum() / nbg),
        "bg_p_max": float(torch.where(bg, p1, 0.0).max()),
        "n_above_thr": float(above.sum() / (b * a)),
        "n_pos_above_thr": float((above & pos).sum() / (b * a)),
    }


def eval_map(mod: DetModule, batches, args) -> float:
    """mAP@0.5 (rotated IoU) of ``mod``'s predictions over ``batches``."""
    det_b, det_s, det_v, gt_b, gt_m, am = [], [], [], [], [], []
    for raw in batches:
        res = mod.predict(raw, args.max_boxes, args.nms_iou, args.score_threshold)
        det_b.append(_host(res.boxes))
        det_s.append(_host(res.scores))
        det_v.append(_host(res.valid))
        gt_b.append(_host(raw["gt_boxes"]))
        gt_m.append(_host(raw["gt_mask"]))
        am.append(_host(raw["agent_mask"]))
    maps = eval_map_agents(
        np.concatenate(det_b), np.concatenate(det_s), np.concatenate(det_v),
        np.concatenate(gt_b), np.concatenate(gt_m), np.concatenate(am),
        iou_thresholds=(0.5,), match="iou", device=mod.device,
    )
    return float(maps["mAP@0.5"])


def probe_record(mod: DetModule, held: list, held_prep: list, pool_probe: list, args) -> dict:
    """Every probe of one step (without the mode, step and train losses)."""
    rec = {}
    ev = [held_losses(mod, b, train=False) for b in held_prep]
    tv = [held_losses(mod, b, train=True) for b in held_prep]
    for key in ("cls_loss", "loc_loss"):
        rec[f"held_{key}_run"] = round(float(np.mean([m[key] for m in ev])), 4)
        rec[f"held_{key}_bat"] = round(float(np.mean([m[key] for m in tv])), 4)
    # Sorted keys, as the JAX tool's jitted dicts come back.
    rec.update({k: round(v, 3) for k, v in sorted(grad_norms(mod, held_prep[0]).items())})
    stats = score_stats(mod, held_prep[0], args.score_threshold)
    rec.update({k: round(v, 4) for k, v in sorted(stats.items())})
    rec["map_held"] = round(eval_map(mod, held, args), 4)
    rec["map_pool"] = round(eval_map(mod, pool_probe, args), 4)
    return rec


def run_modes(modes, args, arm_tag, config, spec, shared, held, emit) -> None:
    for mode in modes.split(","):
        mode = mode.strip()
        mod = DetModule(config, mode=mode, device=args.device, learning_rate=_learning_rate(args),
                        width_mult=args.width_mult, grad_clip=args.grad_clip)
        mod.init_weights(args.seed)
        stream = _train_stream(args, config, spec, args.seed, shared)
        # Held-out probe batches, prepared once (targets + occupancy).
        held_prep = [mod.prepare_batch(h) for h in held]
        pool_probe = [stream(s) for s in range(2)]  # training scenes

        def probe(step, last_metrics):
            rec = {"mode": mode + arm_tag, "step": step}
            if last_metrics is not None:
                rec["train_cls"] = round(float(last_metrics["cls_loss"]), 4)
                rec["train_loc"] = round(float(last_metrics["loc_loss"]), 4)
            rec.update(probe_record(mod, held, held_prep, pool_probe, args))
            emit(rec)

        t0 = time.time()
        metrics = None
        probe(0, None)
        for s in range(args.steps):
            metrics = mod.train_step(mod.prepare_batch(stream(s)))
            if (s + 1) % args.probe_every == 0 or s + 1 == args.steps:
                probe(s + 1, metrics)
        print(f"{mode} done in {time.time() - t0:.0f}s", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Train and probe every arm and mode; returns the records."""
    args = parse_args(argv)
    args.device = tool_device(args.cpu)
    config = build_config(args)
    spec = build_spec(args)
    shared: dict = {}
    held = [generate_batch(config, spec, batch_size=args.batch, seed=900_000 + e)
            for e in range(args.eval_batches)]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    open(args.out, "w").close()
    records: List[dict] = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")

    if args.arms:
        arms = []
        for arm_spec in args.arms.split(";"):
            lr, clip, sched = arm_spec.strip().split(":")
            arms.append((float(lr), float(clip), sched))
    else:
        arms = [(args.lr, args.grad_clip, "cosine" if args.cosine else "const")]
    for arm_lr, arm_clip, arm_sched in arms:
        a = argparse.Namespace(**vars(args))
        a.lr, a.grad_clip, a.cosine = arm_lr, arm_clip, arm_sched == "cosine"
        arm_tag = f"@lr={arm_lr:g},clip={arm_clip:g},{arm_sched}" if args.arms else ""
        run_modes(args.modes, a, arm_tag, config, spec, shared, held, emit)
    return records


if __name__ == "__main__":
    main()
