"""Kernel-level profile of one detection step, on ``torch.profiler``.

Port of ``v2x_sim_tpu/tools/xprof_det.py``: DiscoNet in bf16 at the
production geometry (``--grid small`` for CPU runs), B=``--batch``;
``--what`` picks the step: ``predict`` (points in, NMS'd boxes out),
``prepare`` (voxelize and the anchor assignment, from a batch already on
the device) or ``train`` (one step on a prepared batch). After two warm
calls, a window of 3 calls ending in ``torch.cuda.synchronize()`` is
traced with the CPU and CUDA activities and exported as a chrome trace
to ``--trace_dir/<what>.json``. The report reads that trace:

  * self time a step by category (cuDNN conv, GEMM, elementwise/reduce:
    every other kernel of PyTorch's own, BatchNorm, resize, cat, gather
    and scatter among them; the port's ``rotated_iou*`` kernels,
    memcpy/memset, other: CUB's sorts and the rest) and the ``--top``
    kernels;
  * the device busy share: the union of the kernel and memcpy/memset
    intervals over the window from the first launch to the end of the
    final synchronize; the idle share is the rest;
  * by span: the port's ``det.`` spans (``utils/spans.py``), each keyed by
    its path from its entry (``det.train_step/det.backward``), with its
    calls, host ms, and the device ms, kernel launches and blocking host
    syncs it caused, a call of the entry (``span_totals``).

A trace with no device events is an error (exit 1): the tool never
reports a CPU number as a device one. With ``--cpu`` it profiles the CPU
only, prints the CPU ops' self time under the label CPU, reports no busy
share, and gives the spans' calls and host ms alone. The first line
names the device.

    python -m v2x_sim_tpu_torch.tools.xprof_det [--what train] [--batch 16] [--top 30]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.tools.bench_table import OUT_DIR
from v2x_sim_tpu_torch.tools.common import device_label, grid_config, synchronize, tool_device
from v2x_sim_tpu_torch.train.det_module import DetModule

#: Calls in the traced window.
STEPS = 3
#: Predict's decode and NMS settings (the JAX tool's).
TOPK, SCORE_THRESHOLD, NMS_IOU = 128, 0.3, 0.1
#: Chrome-trace categories of device activity.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Categories of the host's calls into CUDA, which carry the correlation.
API_CATS = ("cuda_runtime", "cuda_driver")
#: Runtime calls that block the host until the device has drained.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
CATEGORIES = ("cuDNN conv", "GEMM", "elementwise/reduce", "rotated_iou (K1, K2)",
              "memcpy/memset", "other")


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--trace_dir", default=os.path.join(OUT_DIR, "xtrace"))
    p.add_argument("--what", default="predict", choices=("predict", "train", "prepare"),
                   help="which step to trace")
    p.add_argument("--report_only", action="store_true",
                   help="report an existing trace without capturing")
    p.add_argument("--grid", default="full", choices=["full", "small"],
                   help="small = 64x64 BEV for CPU runs")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    return p.parse_args(argv)


def category(name: str, cat: str = "kernel") -> str:
    """The report's category of a kernel (or, on the CPU, an op) name."""
    if cat in ("gpu_memcpy", "gpu_memset") or re.search(r"memcpy|memset|aten::copy_", name, re.I):
        return "memcpy/memset"
    n = name.lower()
    if "rotated_iou" in n:
        return "rotated_iou (K1, K2)"
    if re.search(r"conv|cudnn|fprop|dgrad|wgrad", n):
        return "cuDNN conv"
    if re.search(r"gemm|cutlass|matmul|aten::(mm|addmm|bmm)\b", n):
        return "GEMM"
    if re.search(r"at::native::|elementwise|reduce|aten::", n):
        return "elementwise/reduce"
    return "other"


def setup(batch: int, grid: str, device: torch.device):
    """The bf16 DiscoNet module with seeded weights and B=``batch`` scenes
    of the production synthetic spec, uploaded once."""
    cfg = Config(grid=grid_config(grid))
    spec = SyntheticSpec(points_per_agent=8192 if grid == "full" else 2048,
                         num_vehicles=12, max_gt=32)
    raw = generate_batch(cfg, spec, batch_size=batch, seed=0)
    module = DetModule(cfg, mode="disco", compute_dtype=torch.bfloat16, device=device)
    module.init_weights(0)
    return module, module.to_device(raw)


def step_fn(module, batch: dict, what: str):
    """The call ``what`` names, on a batch already on the device."""
    if what == "train":
        prepared = module.prepare_batch(batch)
        return lambda: module.train_step(prepared)
    if what == "prepare":
        return lambda: module.prepare_batch(batch)
    return lambda: module.predict(batch, TOPK, NMS_IOU, SCORE_THRESHOLD)


def capture(args, device: torch.device) -> torch.profiler.profile:
    """Trace STEPS warm calls of the step; writes ``<trace_dir>/<what>.json``."""
    module, batch = setup(args.batch, args.grid, device)
    fn = step_fn(module, batch, args.what)
    for _ in range(2):
        fn()
    synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            fn()
        synchronize(device)
    shutil.rmtree(args.trace_dir, ignore_errors=True)
    os.makedirs(args.trace_dir)
    prof.export_chrome_trace(trace_path(args))
    return prof


def trace_path(args) -> str:
    return os.path.join(args.trace_dir, f"{args.what}.json")


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def read_events(path: str) -> List[dict]:
    """The complete ('X') events of a chrome trace."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def span_paths(spans: List[dict]) -> List[Tuple[float, float, str]]:
    """(start, end, path) of each of one thread's nested ``det.`` spans, in
    order of start; a path joins the names of the spans open around a span,
    outermost first, and its own, by "/"."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, float, str]] = []
    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1][1] <= e["ts"]:
            stack.pop()
        item = (e["ts"], e["ts"] + e["dur"], (stack[-1][2] + "/" if stack else "") + e["name"])
        stack.append(item)
        out.append(item)
    return out


def innermost(paths: List[Tuple[float, float, str]], times: List[float]) -> List[Optional[str]]:
    """For each of the sorted ``times``, the path of the innermost span of
    ``paths`` (``span_paths``') open at it, or None."""
    out: List[Optional[str]] = []
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for t in times:
        while i < len(paths) and paths[i][0] <= t:
            while stack and stack[-1][1] <= paths[i][0]:
                stack.pop()
            stack.append(paths[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def span_totals(events: List[dict]) -> Dict[str, Dict[str, float]]:
    """Each ``det.`` span path's calls, host seconds, and, inclusive of the
    spans under it, the device seconds, kernel launches and blocking syncs
    it caused, from a trace's complete events.

    The spans are those of the entry's thread, the thread of the first
    ``det.`` span. A device event (kernel, memcpy, memset) belongs to the
    innermost span open on that thread when the runtime or driver call
    that launched it began, the two matched by ``args.correlation``: by
    time, not by thread, since the backward's kernels are launched from the
    autograd engine's thread while the entry's thread waits inside
    ``det.backward``. A blocking sync is a call of ``SYNCS`` that begins
    inside a span. A span's self time is its value less its children's."""
    det = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("det.")]
    if not det:
        return {}
    first = min(det, key=lambda e: e["ts"])
    paths = span_paths([e for e in det if (e.get("pid"), e.get("tid"))
                        == (first.get("pid"), first.get("tid"))])
    totals: Dict[str, Dict[str, float]] = {}
    for s, e, p in paths:
        t = totals.setdefault(p, dict.fromkeys(("calls", "host_s", "device_s", "launches",
                                                "syncs"), 0))
        t["calls"] += 1
        t["host_s"] += (e - s) / 1e6
    api = [e for e in events if e.get("cat") in API_CATS]
    launched = {e["args"]["correlation"]: e["ts"] for e in api
                if "correlation" in e.get("args", {})}
    hits = [(launched[e["args"]["correlation"]], e) for e in events
            if e.get("cat") in DEVICE_CATS and e.get("args", {}).get("correlation") in launched]
    hits += [(e["ts"], e) for e in api if e["name"] in SYNCS]
    hits.sort(key=lambda h: h[0])
    for (_, e), path in zip(hits, innermost(paths, [t for t, _ in hits])):
        if path is None:
            continue
        parts = path.split("/")
        for n in range(1, len(parts) + 1):
            t = totals["/".join(parts[:n])]
            if e["cat"] in DEVICE_CATS:
                t["device_s"] += e["dur"] / 1e6
                t["launches"] += e["cat"] == "kernel"
            else:
                t["syncs"] += 1
    return totals


def span_report(events: List[dict], device: bool) -> Dict[str, Dict[str, Optional[float]]]:
    """``span_totals`` a call of each path's entry (its first span), in
    ms; the device columns None for a CPU trace."""
    totals = span_totals(events)
    rep = {}
    for path, t in totals.items():
        n = totals[path.split("/")[0]]["calls"]
        rep[path] = {"calls": t["calls"] / n, "host_ms": 1e3 * t["host_s"] / n,
                     "device_ms": 1e3 * t["device_s"] / n if device else None,
                     "launches": t["launches"] / n if device else None,
                     "syncs": t["syncs"] / n if device else None}
    return rep


def device_report(path: str, top: int) -> Optional[dict]:
    """Per-step device self time by category and by kernel, the busy
    share and the spans, from a chrome trace; None if it holds no device
    event."""
    events = read_events(path)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    cats: Dict[str, float] = dict.fromkeys(CATEGORIES, 0.0)
    kernels: Dict[str, float] = {}
    for e in dev:
        cats[category(e["name"], e["cat"])] += e["dur"]
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    launches = [e["ts"] for e in runtime if re.search(r"Launch|Memcpy|Memset", e["name"])]
    syncs = [e["ts"] + e["dur"] for e in runtime if "Synchronize" in e["name"]]
    start = min(launches + [s for s, _ in intervals])
    end = max(syncs) if syncs else max(e for _, e in intervals)
    busy = _union_us(intervals) / (end - start)
    ms = lambda us: us / STEPS / 1e3
    return {
        "total_ms": ms(sum(cats.values())),
        "categories_ms": {c: ms(t) for c, t in cats.items()},
        "top_ms": [(n, ms(t)) for n, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]],
        "window_ms": ms(end - start),
        "busy": busy,
        "idle": 1.0 - busy,
        "spans": span_report(events, device=True),
    }


def cpu_report(prof: torch.profiler.profile, top: int) -> dict:
    """Per-step CPU self time of the traced ops, by category and by op."""
    ops = [(e.key, e.self_cpu_time_total) for e in prof.key_averages()]
    cats: Dict[str, float] = dict.fromkeys(CATEGORIES, 0.0)
    for name, us in ops:
        cats[category(name, "cpu_op")] += us
    ms = lambda us: us / STEPS / 1e3
    return {
        "total_ms": ms(sum(cats.values())),
        "categories_ms": {c: ms(t) for c, t in cats.items()},
        "top_ms": [(n, ms(t)) for n, t in sorted(ops, key=lambda kv: -kv[1])[:top]],
    }


def print_report(rep: dict, kind: str, what: str) -> None:
    print(f"{what}: total {kind} self time: {rep['total_ms']:.3f} ms/step")
    for c, t in sorted(rep["categories_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {c:24s} {t:9.3f} ms")
    if "busy" in rep:
        print(f"device busy share: {rep['busy']:.4f}, idle share: {rep['idle']:.4f} "
              f"(window {rep['window_ms']:.3f} ms/step, first launch to the final synchronize)")
    else:
        print("device busy share: not measured (CPU run)")
    print(f"top {len(rep['top_ms'])} ({kind} self time, per step):")
    for n, t in rep["top_ms"]:
        print(f"  {t:9.3f} ms  {n[:160]}")
    print("by span, a call of its entry (device ms, launches and syncs include the spans below):")
    print(f"  {'path':56s} {'calls':>6s} {'host ms':>9s} {'device ms':>9s} {'launches':>8s} "
          f"{'syncs':>6s}")
    cell = lambda v, f: "-" if v is None else format(v, f)
    for path, r in rep["spans"].items():
        print(f"  {path:56s} {r['calls']:6.2f} {r['host_ms']:9.3f} "
              f"{cell(r['device_ms'], '9.3f'):>9s} {cell(r['launches'], '8.1f'):>8s} "
              f"{cell(r['syncs'], '6.1f'):>6s}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Capture (unless --report_only) and report; returns the report.
    Exits 1 when a device trace holds no device event."""
    args = parse_args(argv)
    if not args.report_only:
        device = tool_device(args.cpu)
        print(f"device: {device_label(device)}")
        prof = capture(args, device)
        if device.type != "cuda":
            rep = cpu_report(prof, args.top)
            rep["spans"] = span_report(read_events(trace_path(args)), device=False)
            print_report(rep, "CPU", args.what)
            return rep
    rep = device_report(trace_path(args), args.top)
    if rep is None:
        raise SystemExit(f"xprof_det: the trace {trace_path(args)} holds no device events "
                         "(kernel, memcpy, memset): CUDA activity was not recorded")
    print_report(rep, "device", args.what)
    print(f"trace: {trace_path(args)}")
    return rep


if __name__ == "__main__":
    main()
