"""One run of one cell: set-up, the measured window, the optional traced
stretch, the check against the reference, and the result's line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration's folder (``configs/<name>/``: the
settings, the fusion's reference and the FLOP count), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``) and each
per-layer metric's reader (``metrics/<name>.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark.harness import check, loops, program, trace
from benchmark.harness.scenes import SceneSpec, generate_batch
from benchmark.harness.weights import make_state_dict
from benchmark.reference import detect, train
from benchmark.reference.model import Reference

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
GIB = 1024 ** 3
#: Calls in a traced stretch.
TRACED_CALLS = {"train_stream": 3, "predict_closed": 8}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """A Python file of the benchmark's, imported by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell as its files define it."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    config_dir: Path

    @property
    def kind(self) -> str:
        return {"train_stream": "train", "predict_closed": "predict"}[self.traffic["loop"]]

    def fusion_reference(self):
        return load_file(self.config_dir / "reference.py", f"ref_{self.config['name']}")

    def flops(self):
        return load_file(self.config_dir / "flops.py", f"flops_{self.config['name']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path.name}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = ROOT / configs[w["config"]]["file"]
    return Cell(name, load_json(cfg_file), load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                load_json(BENCH / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], cfg_file.parent)


@dataclass
class Reading:
    """What per-layer metric readers read (``metrics/<name>.py``)."""

    config: dict
    traffic: dict
    batch: int
    calls: int
    window_s: float
    flops_per_call: int
    peaks: Optional[dict]
    spans_ms: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[trace.TraceSummary] = None


def make_pool(cell: Cell, seed: int, device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """The pool of distinct batches, made from the seed on the host and
    moved to the device once: batch p's scene b is drawn from seed
    ``seed * 10007 + p * B + b``."""
    t = cell.traffic
    spec = SceneSpec(**t["scene"])
    b = t["batch"]
    pool = []
    for p in range(t["pool_batches"]):
        batch = generate_batch(cell.config, spec, [seed * 10007 + p * b + i for i in range(b)])
        pool.append({k: torch.from_numpy(batch[k]).to(device) for k in program.INPUT_KEYS})
    return pool


def reference_model(cell: Cell, state_dict, device, rounding=None) -> Reference:
    model = Reference(cell.config, cell.fusion_reference().build_fusion(cell.config))
    model.load_state_dict(state_dict)
    model = model.to(device)
    if rounding is not None:
        model.precision.rounding = rounding
    return model


def skeleton(cell: Cell) -> Reference:
    with torch.device("meta"):
        return Reference(cell.config, cell.fusion_reference().build_fusion(cell.config))


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_numbers(cell: Cell, pool, state_dict, primed: Optional[dict],
                      samples: Optional[list], device, rounding=None) -> Dict[str, float]:
    """The cell's numbers: the program's outputs (``primed`` for training,
    ``samples`` for prediction) against the reference's, computed here
    from the same inputs and state dict."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model = reference_model(cell, state_dict, device, rounding)
    if cell.kind == "train":
        steps = cell.traffic["check_steps"]
        ref = train.train_steps(model, pool[:steps], cell.config)
        deltas = {k: primed["params"][k].to(device) - state_dict[k].to(device) for k in ref.deltas}
        grads = {k: v.to(device) for k, v in primed["grads"].items()}
        return check.train_numbers(primed["losses"], grads, deltas, ref)
    model.eval()
    t = cell.traffic
    refs, dense = [], []
    for batch in pool:
        r, d = detect.predict(model, batch, cell.config, t["max_boxes"], t["nms_iou"],
                              t["score_threshold"])
        refs.append(r)
        dense.append(d)
    return check.predict_numbers([detect.Detections(*s) for s in samples], refs, dense,
                                 cell.config, t)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: torch.device,
             t0: float, peaks: Optional[dict] = None, tweak: Optional[Callable] = None,
             log=sys.stderr, numbers_out: Optional[dict] = None,
             marks: Optional[list] = None) -> dict:
    """One run; returns the result's dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``traced`` ``breakdown``,
    then ``checks``). ``tweak(cell)`` may change the cell's files' values
    before anything runs (the harness's tests shrink it to the CPU);
    ``numbers_out`` receives every number the check computed. Set-up's
    phases go to ``log``, each as the seconds since the one before: those
    of ``marks`` ((name, time.time()) pairs from before the call), then the
    port's imports, the pool, the weights, the port's module and the
    warm-up."""
    marks = list(marks or [])
    cell = load_cell(name)
    if tweak is not None:
        tweak(cell)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = \
        bool(cell.config["precision"]["tf32"])
    dev = loops.Device(device)
    if dev.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    program.load()
    marks.append(("port_imports", time.time()))
    pool = make_pool(cell, seed, device)
    dev.sync()
    marks.append(("pool", time.time()))
    state_dict = make_state_dict(skeleton(cell), seed, device)
    dev.sync()
    marks.append(("weights", time.time()))
    module = program.build(cell.config, state_dict, device)
    dev.sync()
    marks.append(("module", time.time()))
    state_dict = {k: v.cpu() for k, v in state_dict.items()}
    batch = cell.traffic["batch"]
    if cell.kind == "train":
        loop = loops.TrainStream(module, pool, dev)
        primed = loop.prime(cell.traffic["check_steps"])
    else:
        loop = loops.PredictClosed(module, pool, dev, cell.traffic, seed)
        loop.prime()
        primed = None
    setup_s = time.time() - t0
    marks.append(("warm_up", t0 + setup_s))
    print("setup " + " ".join(f"{k} {t - b:.3f}" for (k, t), b in
                              zip(marks, [t0] + [t for _, t in marks])), file=log, flush=True)
    spans = loops.Spans(dev, traced)
    win = loop.window(seconds, spans)
    peak_bytes = torch.cuda.max_memory_allocated(device) if dev.cuda else 0
    summary = None
    if traced:
        def stretch():
            quiet = loops.Spans(dev, False)
            call = loop.step if cell.kind == "train" else loop.call
            for _ in range(TRACED_CALLS[cell.traffic["loop"]]):
                call(quiet)
            with torch.profiler.record_function("bench.sync"):
                dev.sync()
        summary = trace.traced(stretch, device)
    samples = getattr(loop, "slots", None)
    samples = [tuple(x.to(device) for x in s) for s in samples] if samples else None
    del loop, module
    _free(device)
    numbers = reference_numbers(cell, pool, state_dict, primed, samples, device)
    if numbers_out is not None:
        numbers_out.update(numbers)
    checks = check.judge(numbers, cell.limits)
    correct = check.passed(checks)
    failed = win["failed"] + (0 if correct else len(check.failed_names(checks)))

    if not traced:
        values = end_to_end_values(cell, win, setup_s, peak_bytes)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        flops = cell.flops()
        fn = flops.train_step if cell.kind == "train" else flops.predict
        reading = Reading(cell.config, cell.traffic, batch, win["calls"],
                          win["seconds"], fn(cell.config, batch), peaks, spans.ms(), summary)
        metrics = {}
        for m in cell.per_layer:
            value = load_file(BENCH / "metrics" / f"{m['name']}.py",
                              f"metric_{m['name']}").read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": win["calls"], "failed": failed,
              "metrics": metrics,
              "device": device_record(device, peak_bytes, summary)}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    for k in sorted(set(numbers) - set(checks)):
        print(f"reading {k} {numbers[k]!r} (not compared)", file=log, flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log, flush=True)
    return result


def end_to_end_values(cell: Cell, win: dict, setup_s: float, peak_bytes: int) -> dict:
    values = {"setup_s": setup_s, "peak_mem_gib": peak_bytes / GIB}
    if cell.kind == "train":
        values["train_scenes_per_sec"] = win["scenes"] / win["seconds"]
    else:
        values["predict_scenes_per_sec"] = win["scenes"] / win["seconds"]
        values["predict_p95_ms"] = 1e3 * percentile(win["latencies"], 95)
    return values


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    s = sorted(values)
    x = (len(s) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (x - lo)


def device_record(device: torch.device, peak_bytes: int, summary) -> dict:
    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak_bytes}
    if summary is not None:
        rec["busy_s"] = summary.busy_s
        rec["window_s"] = summary.window_s
    return rec

