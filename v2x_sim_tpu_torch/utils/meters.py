"""Metrics tracking and run logging.

The port's own copy of ``v2x_sim_tpu/utils/meters.py``: the reference's
``AverageMeter`` and flat ``log.txt``, plus structured per-step JSONL
metrics (losses, scenes/sec).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class AverageMeter:
    """Running average of a scalar (the reference's surface)."""

    def __init__(self, name: str = "", fmt: str = ":.4f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:{self.fmt[1:]}} ({self.avg:{self.fmt[1:]}})"


class RunLogger:
    """Writes a human ``log.txt`` and a machine ``metrics.jsonl`` into a run
    directory."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._txt = open(os.path.join(logdir, "log.txt"), "a")
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, msg: str):
        line = f"[{time.time() - self._t0:9.1f}s] {msg}"
        print(line, flush=True)
        self._txt.write(line + "\n")
        self._txt.flush()

    def metrics(self, step: int, values: Dict[str, float], prefix: str = ""):
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 3)}
        rec.update({f"{prefix}{k}": float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._txt.close()
        self._jsonl.close()


class StepTimer:
    """Per-step timing with scenes/sec, on the host clock between ticks."""

    def __init__(self, scenes_per_step: int):
        self.scenes_per_step = scenes_per_step
        self._last: Optional[float] = None
        self.meter = AverageMeter("scenes/sec")

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        rate = None
        if self._last is not None:
            dt = now - self._last
            rate = self.scenes_per_step / dt
            self.meter.update(rate)
        self._last = now
        return rate
