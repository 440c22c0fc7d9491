"""A short traced stretch and what is read from it.

``torch.profiler`` with the CPU and CUDA activities records the stretch
inside the harness's ``bench.window`` span, with the harness's spans
(``bench.<call>``) around each call into the entry. Its chrome trace is
read for:

  * the device's busy time: the union of the kernel, memcpy and memset
    intervals inside the window (the arithmetic of
    ``v2x_sim_tpu_torch/tools/xprof_det.py``'s report, commit 73ef7cd);
  * each kernel's launches and device seconds, by name;
  * the device's idle gaps, each named by the innermost harness span and
    the innermost operator open on the harness's thread when it began;
  * the program's ``det.`` spans: each span path's calls, device seconds,
    kernel launches and blocking syncs (``harness/spans.py``).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from benchmark.harness.spans import DEVICE_CATS, span_totals

WINDOW = "bench.window"


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    #: kernel name -> [launches, device seconds]
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    #: "span | operator" -> idle device seconds that began there
    idle: Dict[str, float] = field(default_factory=dict)
    #: ``det.`` span path -> calls, host_s, device_s, launches, syncs
    spans: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def kernel_time(self, fragment: str) -> Tuple[int, float]:
        """Launches and device seconds of every kernel whose name holds
        ``fragment``."""
        hits = [v for k, v in self.kernels.items() if fragment in k]
        return int(sum(v[0] for v in hits)), sum(v[1] for v in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v[1]] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The sorted, disjoint union of (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(events: List[dict], times: List[float]) -> List[str]:
    """For each of the sorted ``times``, the name of the innermost of the
    nested ``events`` (one thread's) open at it, or "-"."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    names, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i]["ts"] <= t:
            e = events[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
            stack.pop()
        names.append(stack[-1]["name"] if stack else "-")
    return names


def summarize(events: List[dict]) -> TraceSummary:
    """The summary of one trace's complete ('X') events; raises when the
    trace holds no window span or no device event in it."""
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("the trace holds no bench.window span")
    win = windows[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    clipped = [(s, e) for s, e in clipped if e > s]
    if not clipped:
        raise RuntimeError("the trace holds no device event in its window: CUDA activity "
                           "was not recorded")
    busy = union(clipped)
    summary = TraceSummary(sum(e - s for s, e in busy) / 1e6, (w1 - w0) / 1e6)
    for e in dev:
        if w0 <= e["ts"] < w1:
            k = summary.kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e6
    gaps = [(s, e) for s, e in zip([w0] + [b for _, b in busy], [a for a, _ in busy] + [w1])
            if e > s]
    starts = [s for s, _ in gaps]
    host = [e for e in events if e.get("tid") == win.get("tid") and e.get("pid") == win.get("pid")]
    spans = [e for e in host if e.get("cat") == "user_annotation" and e["name"] != WINDOW]
    ops = [e for e in host if e.get("cat") == "cpu_op"]
    for (s, e), span, op in zip(gaps, _innermost(spans, starts), _innermost(ops, starts)):
        key = f"{span} | {op}"
        summary.idle[key] = summary.idle.get(key, 0.0) + (e - s) / 1e6
    summary.spans = span_totals(events)
    return summary


def traced(fn, device: torch.device) -> TraceSummary:
    """Run ``fn`` (the stretch's calls, ending in a synchronize) under the
    profiler inside the window span, and summarize its trace. The chrome
    trace passes through a file under the temporary directory, removed
    after it is read."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)
    return summarize(events)
