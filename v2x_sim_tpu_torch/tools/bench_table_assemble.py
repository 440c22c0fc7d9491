"""Assemble one benchmark table from several bench_table part-sweeps.

Port of ``v2x_sim_tpu/tools/bench_table_assemble.py`` (host only). A long
det study runs as several bench_table part-sweeps sharing the pool and
protocol; each part prints one JSON row per mode and appends per-mode
convergence records to its ``*_curves.jsonl``. This tool folds the parts
back into one table and one curves file (either package's sweeps):

  python -m v2x_sim_tpu_torch.tools.bench_table_assemble \
      --logs runs/torch/part_a.log,runs/torch/part_b.log \
      --curves runs/torch/A_curves.jsonl,runs/torch/B_curves.jsonl \
      --header "python -m v2x_sim_tpu_torch.tools.bench_table ... (protocol)" \
      --out runs/torch/BENCH_TABLE_FULL.md --curves_out runs/torch/BENCH_TABLE_FULL_curves.jsonl

Rows are ordered by bench_table.ALL_MODES (suffix variants directly
after their base mode); later parts override earlier rows of the same
label (re-runs win). A `steps` column is added when parts trained with
different budgets so mixed-budget tables stay self-describing.
"""

from __future__ import annotations

import argparse
import json
import re
from typing import Optional, Sequence

from v2x_sim_tpu_torch.tools.bench_table import ALL_MODES


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--logs", required=True, help="comma list of part logs")
    p.add_argument("--curves", required=True,
                   help="comma list of part curves jsonl files")
    p.add_argument("--header", required=True,
                   help="the 'Generated by' protocol line")
    p.add_argument("--preamble", default="",
                   help="markdown file appended between header and table")
    p.add_argument("--out", required=True)
    p.add_argument("--curves_out", required=True)
    return p.parse_args(argv)


def load_rows(log_paths):
    """Last JSON row per mode label across the logs, in log order."""
    rows = {}
    for path in log_paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith('{"mode"'):
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                rows[row["mode"]] = row
    return rows


def load_curves(curve_paths):
    recs = {}
    for path in curve_paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rec = json.loads(line)
                    recs[(rec["mode"], rec.get("seed", 0))] = rec
    return recs


def mode_order(labels):
    def key(label):
        base = re.split(r"[\[@]", label)[0]
        try:
            i = ALL_MODES.index(base)
        except ValueError:
            i = len(ALL_MODES)
        return (i, label != base, label)

    return sorted(labels, key=key)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    rows = load_rows(args.logs.split(","))
    curves = load_curves(args.curves.split(","))
    if not rows:
        raise SystemExit("no JSON rows found in the given logs")

    # Budget column from the curve records' final step (mixed-budget
    # parts must stay distinguishable in the committed table).
    steps_by_mode = {}
    for (mode, _seed), rec in curves.items():
        if rec["curve"]:
            steps_by_mode[mode] = max(
                steps_by_mode.get(mode, 0), rec["curve"][-1]["step"]
            )
    budgets = set(steps_by_mode.values())
    add_steps = len(budgets) > 1

    labels = mode_order(rows)
    cols = [c for c in rows[labels[0]] if c != "eval_s"]
    if add_steps:
        cols = cols[:1] + ["steps"] + cols[1:]
    lines = [
        "# Collaboration-mode benchmark (synthetic, per-agent occlusion)",
        "",
        f"Generated by `{args.header}`.",
        "",
    ]
    if args.preamble:
        lines += [open(args.preamble).read().rstrip(), ""]
    lines.append("| " + " | ".join(cols) + " |")
    lines.append("|" + "---|" * len(cols))
    for label in labels:
        row = dict(rows[label])
        if add_steps:
            row["steps"] = steps_by_mode.get(label, "?")
        lines.append(
            "| " + " | ".join(str(row.get(c, "")) for c in cols) + " |"
        )
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")

    with open(args.curves_out, "w") as f:
        for label in labels:
            for (mode, seed), rec in sorted(
                curves.items(), key=lambda kv: kv[0][1]
            ):
                if mode == label:
                    f.write(json.dumps(rec) + "\n")
    print(f"wrote {args.out} ({len(labels)} rows) and {args.curves_out}")


if __name__ == "__main__":
    main()
