"""Tracking benchmark sweep -> a BENCH_TABLE_TRACK markdown table.

Port of ``v2x_sim_tpu/tools/bench_table_track.py``, with its flags and its
row JSON. It loads the per-mode weights a det sweep saved (``bench_table
--save_states``: this package's ``<mode>_seed<seed>.pt``, or the JAX
tool's ``.pkl``), runs the detector frame by frame over synthetic
temporal sequences (``datasets/synthetic.py::generate_sequence``, seeds
950k+: persistent vehicle ids, per-sequence occlusion), tracks each
(sequence, agent) stream with SORT, and reports MOTA / MOTP / HOTA per
mode. Runs on the card unless ``--cpu`` is given; SORT and the metrics run
on the host, as in JAX.

    python -m v2x_sim_tpu_torch.tools.bench_table --grid full --save_states runs/states ...
    python -m v2x_sim_tpu_torch.tools.bench_table_track --states runs/states --grid full --agents 6
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time
from typing import List, Optional, Sequence

import numpy as np

from v2x_sim_tpu_torch.datasets.synthetic import generate_sequence
from v2x_sim_tpu_torch.tools.bench_table import (
    ALL_MODES,
    OUT_DIR,
    build_config,
    build_spec,
    load_state_file,
)
from v2x_sim_tpu_torch.tools.common import tool_device
from v2x_sim_tpu_torch.tracking.mot_metrics import evaluate_hota, evaluate_mot
from v2x_sim_tpu_torch.tracking.sort import track_sequence
from v2x_sim_tpu_torch.train.det_module import DetModule

STATE_EXTS = (".pt", ".pkl")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--states", required=True,
                   help="dir of <mode>_seed<seed>.pt (or the JAX tool's .pkl) from bench_table "
                   "--save_states")
    p.add_argument("--modes", default="all", help="comma list or 'all'")
    p.add_argument("--seed", type=int, default=0, help="which saved seed")
    p.add_argument("--grid", default="full", choices=["tiny", "tiny1m", "small", "medium", "full"])
    p.add_argument("--agents", type=int, default=2)
    p.add_argument("--occlusion", type=float, default=0.45)
    p.add_argument("--width_mult", type=float, default=1.0)
    p.add_argument("--seqs", type=int, default=8, help="independent sequences (eval seeds 950k+)")
    p.add_argument("--frames", type=int, default=20, help="frames/sequence")
    p.add_argument("--dt", type=float, default=0.5)
    p.add_argument("--batch", type=int, default=4, help="frames per predict() launch")
    p.add_argument("--score_threshold", type=float, default=0.3)
    p.add_argument("--nms_iou", type=float, default=0.1)
    p.add_argument("--max_boxes", type=int, default=16)
    p.add_argument("--max_age", type=int, default=3)
    p.add_argument("--min_hits", type=int, default=2)
    p.add_argument("--assoc_iou", type=float, default=0.1, help="SORT association gate")
    p.add_argument("--eval_iou", type=float, default=0.5, help="CLEAR-MOT matching threshold")
    p.add_argument("--out", default=os.path.join(OUT_DIR, "BENCH_TABLE_TRACK.md"))
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    return p.parse_args(argv)


def run_mode_track(mode, args, module: DetModule, sequences) -> dict:
    """One mode's row: the mean of each metric over the (sequence, agent)
    streams. ``row["streams"]`` is not printed: it holds each stream's
    full metrics dict (MOT counts included)."""
    t0 = time.time()
    per_stream = []
    for frames in sequences:
        tlen = len(frames)
        # The frames of one sequence batched along B (scenes are independent
        # in predict): the tail chunk padded by repetition, sliced off after.
        boxes_l, valid_l = [], []
        for s0 in range(0, tlen, args.batch):
            idx = [min(s0 + i, tlen - 1) for i in range(args.batch)]
            chunk = {k: np.stack([frames[i][k] for i in idx])
                     for k in ("points", "point_mask", "trans", "agent_mask")}
            res = module.predict(chunk, args.max_boxes, args.nms_iou, args.score_threshold)
            keep = tlen - s0 if s0 + args.batch > tlen else args.batch
            boxes_l.append(res.boxes.cpu().numpy()[:keep])
            valid_l.append(res.valid.cpu().numpy()[:keep])
        boxes = np.concatenate(boxes_l)  # (T, A, K, 5)
        valid = np.concatenate(valid_l)
        for ai in range(boxes.shape[1]):
            det_frames = [boxes[t, ai][valid[t, ai]] for t in range(tlen)]
            gt = []
            for t in range(tlen):
                keep = frames[t]["gt_mask"][ai]
                gt.append(np.concatenate(
                    [frames[t]["gt_boxes"][ai][keep],
                     frames[t]["gt_ids"][ai][keep, None].astype(np.float64)], -1))
            tracks = track_sequence(det_frames, max_age=args.max_age, min_hits=args.min_hits,
                                    iou_threshold=args.assoc_iou)
            m = evaluate_mot(gt, tracks, iou_threshold=args.eval_iou)
            m.update(evaluate_hota(gt, tracks))
            per_stream.append(m)

    row = {"mode": mode}
    for k in ("mota", "motp", "hota", "det_a", "ass_a"):
        vals = [m[k] for m in per_stream if k in m]
        row[k] = round(float(np.mean(vals)), 4) if vals else float("nan")
    row["eval_s"] = round(time.time() - t0, 1)
    print(json.dumps(row), flush=True)
    row["streams"] = per_stream
    return row


def state_path(states: str, mode: str, seed: int) -> str:
    """``<mode>_seed<seed>.pt`` under ``states``, else the ``.pkl``."""
    for ext in STATE_EXTS:
        path = os.path.join(states, f"{mode}_seed{seed}{ext}")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {mode}_seed{seed}.pt or .pkl under {states}")


def load_state(path: str, mode: str, args, config, device) -> DetModule:
    """The DetModule of ``mode`` with the saved weights (disco+kd's are a
    plain disco model's: the KD tap adds no parameters)."""
    module = DetModule(config, mode="disco" if mode == "disco+kd" else mode, device=device,
                       width_mult=args.width_mult)
    module.model.load_state_dict(load_state_file(path, mode), strict=True)
    return module


def write_table(rows, args, path) -> None:
    lines = [
        "# Tracking benchmark (SORT over per-mode detections, synthetic "
        "temporal sequences)",
        "",
        f"Generated by `python -m v2x_sim_tpu_torch.tools.bench_table_track "
        f"--states {args.states} --grid {args.grid} --agents {args.agents} "
        f"--seqs {args.seqs} --frames {args.frames} --dt {args.dt} "
        f"--occlusion {args.occlusion} --score_threshold "
        f"{args.score_threshold} --seed {args.seed}`.",
        "",
        "Each mode's det weights come from the det sweep "
        "(`bench_table --save_states`); the detector runs frame-by-frame "
        f"over {args.seqs} held-out sequences x {args.frames} frames "
        "(persistent vehicle ids, per-sequence occlusion), SORT links "
        "detections per (sequence, agent) stream, and CLEAR-MOT/HOTA "
        "score against the persistent GT identities. **Absolute numbers "
        "are not comparable to the reference's published table** (short "
        "synthetic training budget) — the per-mode ordering is the "
        "signal, and it should follow the det table's.",
        "",
    ]
    cols = [c for c in rows[0] if c not in ("eval_s", "streams")]
    lines.append("| " + " | ".join(cols) + " |")
    lines.append("|" + "---|" * len(cols))
    for r in rows:
        cells = [str(r[c]) if isinstance(r[c], str) else f"{r[c]:g}" for c in cols]
        lines.append("| " + " | ".join(cells) + " |")
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {path}")


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Score every mode and write the table; returns the rows."""
    args = parse_args(argv)
    device = tool_device(args.cpu)
    if args.modes == "all":
        # Every mode with a saved state for this seed, in table order.
        have = {
            re.sub(rf"_seed{args.seed}\.(pt|pkl)$", "", os.path.basename(f))
            for ext in STATE_EXTS
            for f in glob.glob(os.path.join(args.states, f"*_seed{args.seed}{ext}"))
        }
        modes = [m for m in ALL_MODES if m in have]
        if not modes:
            raise FileNotFoundError(f"no *_seed{args.seed}.pt or .pkl under {args.states}")
    else:
        modes = [m.strip() for m in args.modes.split(",")]

    config = build_config(args)
    spec = build_spec(args)
    sequences = [
        generate_sequence(config, spec, seed=950_000 + s, num_frames=args.frames, dt=args.dt)
        for s in range(args.seqs)
    ]
    rows = []
    for mode in modes:
        module = load_state(state_path(args.states, mode, args.seed), mode, args, config, device)
        rows.append(run_mode_track(mode, args, module, sequences))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_table(rows, args, args.out)
    return rows


if __name__ == "__main__":
    main()
