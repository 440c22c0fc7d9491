"""Merge independently-launched bench_table sweeps into one multi-seed table.

Port of ``v2x_sim_tpu/tools/bench_table_merge.py`` (host only). Long det
sweeps run one seed a process (``--seed N``) rather than in-process via
``--seeds``, so that a crash loses one seed. Each sweep appends per-mode
convergence records to ``<out>_curves.jsonl`` (bench_table.py
``run_mode``, either package's); this tool folds any number of those
files into a single markdown artifact:

  - per mode: final-milestone mAP@0.5 / mAP@0.7 / task loss per seed,
    plus mean±std across seeds (error bars, in the CI-scale table's
    format);
  - per mode: the mAP@0.5 trajectory at every eval milestone, the
    convergence evidence for the signature-ordering claim.

Reference parity: the reference's tables are single-run README markdown
(† coperception/tools/det/README.md); the multi-seed fold mirrors how
BENCH_TABLE.md (CI scale) reports 3-seed error bars.

Usage:
  python -m v2x_sim_tpu_torch.tools.bench_table_merge \
      --curves BENCH_TABLE_FULL_curves.jsonl,runs/torch/BENCH_TABLE_curves.jsonl \
      --out runs/torch/BENCH_TABLE_FULL_SEEDS.md
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--curves", required=True,
        help="comma list of *_curves.jsonl files, one per sweep/seed",
    )
    p.add_argument("--out", default=os.path.join("runs", "torch", "BENCH_TABLE_FULL_SEEDS.md"))
    p.add_argument(
        "--note", default="",
        help="extra provenance line for the table header",
    )
    return p.parse_args(argv)


def load_records(paths):
    """-> {mode: {seed: curve}} with curves sorted by step. A mode/seed
    appearing in several files keeps the last occurrence (reruns win)."""
    by_mode = defaultdict(dict)
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                curve = sorted(rec["curve"], key=lambda c: c["step"])
                by_mode[rec["mode"]][rec.get("seed", 0)] = curve
    return by_mode


def _mean_std(vals):
    n = len(vals)
    if n == 0:
        return "—"
    mean = sum(vals) / n
    std = (sum((v - mean) ** 2 for v in vals) / n) ** 0.5
    return f"{mean:.4g}±{std:.2g}" if n > 1 else f"{mean:.4g}"


#: Task loss (cls+loc) in these sweeps never exceeds ~2; curves written
#: before the e3c6d5c final_loss fix recorded the kd_weight-scaled TOTAL
#: (task + 1e5×KD MSE ≈ 1e2–1e4) for disco+kd rows. Anything above this
#: is that legacy bookkeeping, not a task loss — exclude it from the
#: task_loss fold and say so, instead of laundering it into a labeled
#: "task_loss" cell.
_LEGACY_LOSS_CUTOFF = 10.0


def render(by_mode, curves_paths, note=""):
    seeds = sorted({s for m in by_mode.values() for s in m})
    lines = [
        "# Production-geometry det benchmark — multi-seed fold",
        "",
        "Merged from: " + ", ".join(f"`{p}`" for p in curves_paths)
        + (f" — {note}" if note else ""),
        "",
        "Each seed is an independent full sweep (fresh pool, fresh init,"
        " identical held-out eval scenes). Cells are the final-milestone"
        " value; ± is the population std across seeds. **Absolute numbers"
        " are NOT comparable to the reference's published tables** (short"
        " synthetic budget) — the per-mode ordering and its stability"
        " across seeds are the signal.",
        "",
    ]
    head = (
        ["mode"]
        + [f"mAP@0.5 s{s}" for s in seeds]
        + ["mAP@0.5 mean±std", "mAP@0.7 mean±std", "task_loss mean±std", "seeds"]
    )
    lines.append("| " + " | ".join(head) + " |")
    lines.append("|" + "---|" * len(head))
    footnotes = []
    for mode, per_seed in by_mode.items():
        finals = {s: c[-1] for s, c in per_seed.items()}
        # Seeds stopped at different --steps must not silently fold into
        # one mean±std cell: tag each per-seed cell
        # with its final step and footnote the mismatch.
        final_steps = {f["step"] for f in finals.values()}
        uneven = len(final_steps) > 1
        row = [mode]
        row += [
            (
                f"{finals[s]['mAP@0.5']:g}"
                + (f" @{finals[s]['step']}" if uneven else "")
            )
            if s in finals
            else "—"
            for s in seeds
        ]
        if uneven:
            footnotes.append(
                f"- **{mode}**: seeds reached different final steps "
                f"({', '.join(str(s) for s in sorted(final_steps))}); the "
                "mean±std cells fold unequal budgets."
            )
        for key in ("mAP@0.5", "mAP@0.7"):
            row.append(_mean_std([f[key] for f in finals.values()]))
        losses = [f["loss"] for f in finals.values()]
        ok_losses = [v for v in losses if v <= _LEGACY_LOSS_CUTOFF]
        if len(ok_losses) < len(losses):
            footnotes.append(
                f"- **{mode}**: {len(losses) - len(ok_losses)} seed(s) "
                "carry a pre-e3c6d5c kd_weight-scaled total instead of the "
                "task loss; excluded from the task_loss cell."
            )
        row.append(_mean_std(ok_losses))
        row.append(str(len(finals)))
        lines.append("| " + " | ".join(row) + " |")
    if footnotes:
        lines += ["", "### Data caveats", ""] + footnotes
    lines += [
        "",
        "## Convergence (mAP@0.5 at each eval milestone)",
        "",
    ]
    for mode, per_seed in by_mode.items():
        for s, curve in sorted(per_seed.items()):
            traj = " → ".join(
                f"{c['mAP@0.5']:g}@{c['step']}" for c in curve
            )
            lines.append(f"- **{mode}** seed {s}: {traj}")
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    paths = [p.strip() for p in args.curves.split(",") if p.strip()]
    by_mode = load_records(paths)
    if not by_mode:
        raise SystemExit("no records found in " + ", ".join(paths))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(render(by_mode, paths, args.note))
    print(f"wrote {args.out} ({len(by_mode)} modes)")


if __name__ == "__main__":
    main()
