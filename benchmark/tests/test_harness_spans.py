"""The program's spans in the trace summary: ``harness/spans.py`` against
the port's ``tools/xprof_det.py::span_totals``, of which it is a frozen
copy, on a canned training trace and a canned prediction trace; the
trace's busy time, idle gaps and kernels the same function of the trace
as before spans were read; and each span metric's reader on a
``Reading``, ``None`` where its span is missing."""

import dataclasses
import json
from itertools import count

import pytest

from benchmark.harness import spans, trace
from benchmark.harness.cell import BENCH, Reading, load_cell, load_file

ENTRY, AUTOGRAD, STREAM = 1, 2, 7


class Canned:
    """A chrome trace's complete events, written call by call."""

    def __init__(self):
        self.events = []
        self.ids = count(1)

    def span(self, name, ts, dur, cat="user_annotation", tid=ENTRY):
        self.events.append({"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
                            "pid": 1, "tid": tid})

    def launch(self, at, start, dur, name="k", tid=ENTRY, cat="kernel"):
        """A runtime call at ``at`` on ``tid`` and the device event it
        launches at ``start``, matched by their correlation."""
        c = next(self.ids)
        api = {"kernel": "cudaLaunchKernel", "gpu_memcpy": "cudaMemcpyAsync",
               "gpu_memset": "cudaMemsetAsync"}[cat]
        self.events.append({"name": api, "cat": "cuda_runtime", "ph": "X", "ts": at, "dur": 2,
                             "pid": 1, "tid": tid, "args": {"correlation": c}})
        self.events.append({"name": name, "cat": cat, "ph": "X", "ts": start, "dur": dur,
                            "pid": 0, "tid": STREAM, "args": {"correlation": c}})

    def sync(self, at, name="cudaStreamSynchronize", tid=ENTRY):
        self.events.append({"name": name, "cat": "cuda_runtime", "ph": "X", "ts": at, "dur": 5,
                            "pid": 1, "tid": tid, "args": {}})


def train_trace(steps=2):
    """``steps`` of the harness's training loop: prepare, then a step whose
    backward launches from the autograd engine's thread."""
    t = Canned()
    t.span("bench.window", 0, 1000 * steps + 10)
    for s in range(steps):
        o = 1000 * s
        t.span("bench.prepare_batch", o, 200)
        t.span("det.prepare_batch", o + 1, 198)
        t.span("det.voxelize", o + 2, 40)
        for i in range(3):
            t.launch(o + 3 + 10 * i, o + 5 + 10 * i, 4, "voxel_scatter")
            t.sync(o + 8 + 10 * i, "cudaMemcpy")
        t.span("det.assign", o + 50, 140)
        t.span("det.assign.nearest", o + 51, 40)
        t.launch(o + 52, o + 60, 30, "argmin")
        t.sync(o + 80)
        t.span("det.assign.iou", o + 95, 40)
        t.launch(o + 96, o + 100, 25, "rotated_iou_pairs_periodic_kernel")
        t.launch(o + 97, o + 125, 20, "rotated_iou_pairs_periodic_kernel")
        t.span("det.assign.forced", o + 140, 45)
        t.launch(o + 141, o + 150, 5, "rotated_iou_forced_anchor_kernel")
        t.launch(o + 142, o + 156, 3, "memset", cat="gpu_memset")
        t.span("bench.train_step", o + 200, 780)
        t.span("det.train_step", o + 201, 778)
        t.span("det.model", o + 202, 200)
        t.span("det.encode", o + 203, 60)
        t.launch(o + 204, o + 210, 50, "conv_fprop")
        t.span("det.fuse", o + 270, 60)
        t.launch(o + 271, o + 275, 40, "grid_sampler_2d")
        t.span("det.heads", o + 335, 60)
        t.launch(o + 336, o + 340, 45, "upsample_bilinear2d")
        t.span("det.loss", o + 405, 20)
        t.launch(o + 406, o + 410, 8, "focal")
        t.span("det.backward", o + 430, 300)
        for i in range(4):  # the autograd engine's launches while the entry waits
            t.launch(o + 440 + 50 * i, o + 450 + 50 * i, 45, "conv_dgrad", tid=AUTOGRAD)
        t.sync(o + 700)
        t.span("det.optimizer", o + 740, 230)
        t.launch(o + 741, o + 750, 12, "adam")
        t.launch(o + 990, o + 992, 3, "outside_any_span")  # the harness's own
        t.sync(o + 995, "cudaEventSynchronize")
    return t.events


def predict_trace(calls=3):
    t = Canned()
    t.span("bench.window", 0, 500 * calls + 10)
    for s in range(calls):
        o = 500 * s
        t.span("bench.predict", o, 480)
        t.span("det.predict", o + 1, 470)
        t.span("det.voxelize", o + 2, 30)
        for i in range(3):
            t.launch(o + 3 + 8 * i, o + 4 + 8 * i, 3, "voxel_scatter")
            t.sync(o + 7 + 8 * i)
        t.span("det.model", o + 40, 300)
        t.span("det.encode", o + 41, 50)
        t.launch(o + 42, o + 45, 40, "conv_fprop")
        t.span("det.fuse", o + 100, 100)
        for r in range(3):
            t.span("det.fuse.round", o + 101 + 30 * r, 28)
            t.launch(o + 102 + 30 * r, o + 110 + 30 * r, 25, "msg_conv")
        t.span("det.heads", o + 210, 120)
        t.launch(o + 211, o + 220, 100, "upsample_bilinear2d")
        t.span("det.decode", o + 345, 20)
        t.launch(o + 346, o + 350, 9, "topk")
        t.span("det.nms", o + 370, 95)
        t.span("det.nms.iou", o + 371, 20)
        t.launch(o + 372, o + 375, 6, "rotated_iou_matrix_kernel")
        t.span("det.nms.greedy", o + 395, 65)
        for i in range(5):
            t.launch(o + 396 + 12 * i, o + 400 + 12 * i, 2, "greedy_step")
        t.span("bench.sync", o + 480, 15)
        t.sync(o + 481, "cudaDeviceSynchronize")
    return t.events


TRACES = {"train": train_trace, "predict": predict_trace}


@pytest.mark.parametrize("kind", sorted(TRACES))
def test_spans_agree_with_the_ports_span_totals(kind):
    from v2x_sim_tpu_torch.tools.xprof_det import span_totals

    events = TRACES[kind]()
    got = spans.span_totals(events)
    assert got == span_totals(events)
    assert trace.summarize(events).spans == got


def test_the_canned_traces_read_as_written():
    t = spans.span_totals(train_trace(2))
    assert t["det.train_step"]["calls"] == 2
    assert t["det.train_step/det.backward"]["device_s"] == pytest.approx(2 * 4 * 45e-6)
    assert t["det.train_step/det.backward"]["launches"] == 8
    assert t["det.prepare_batch"]["syncs"] == 2 * 4 and t["det.train_step"]["syncs"] == 2
    assert t["det.prepare_batch/det.assign"]["device_s"] == pytest.approx(2 * 83e-6)
    assert t["det.prepare_batch/det.assign"]["launches"] == 2 * 4  # the memset is no kernel
    p = spans.span_totals(predict_trace(3))
    assert p["det.predict/det.model/det.fuse"]["device_s"] == pytest.approx(3 * 75e-6)
    assert p["det.predict/det.model/det.fuse/det.fuse.round"]["calls"] == 9
    assert p["det.predict/det.nms"]["launches"] == 3 * 6 and p["det.predict"]["syncs"] == 9
    assert spans.span_totals([e for e in predict_trace() if not e["name"].startswith("det.")]) == {}


def _summarize_before(events):
    """``harness/trace.py::summarize`` as it was before spans were read
    (commit 788702d), less the spans."""
    windows = [e for e in events if e.get("name") == trace.WINDOW
               and e.get("cat") == "user_annotation"]
    win = windows[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    busy = trace.union([(s, e) for s, e in clipped if e > s])
    summary = trace.TraceSummary(sum(e - s for s, e in busy) / 1e6, (w1 - w0) / 1e6)
    for e in dev:
        if w0 <= e["ts"] < w1:
            k = summary.kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e6
    gaps = [(s, e) for s, e in zip([w0] + [b for _, b in busy], [a for a, _ in busy] + [w1])
            if e > s]
    starts = [s for s, _ in gaps]
    host = [e for e in events if e.get("tid") == win.get("tid") and e.get("pid") == win.get("pid")]
    named = [e for e in host if e.get("cat") == "user_annotation" and e["name"] != trace.WINDOW]
    ops = [e for e in host if e.get("cat") == "cpu_op"]
    for (s, e), span, op in zip(gaps, trace._innermost(named, starts), trace._innermost(ops, starts)):
        key = f"{span} | {op}"
        summary.idle[key] = summary.idle.get(key, 0.0) + (e - s) / 1e6
    return summary


@pytest.mark.parametrize("kind", sorted(TRACES))
def test_busy_idle_and_kernels_are_read_as_before(kind):
    events = TRACES[kind]()
    s = trace.summarize(events)
    assert s.spans and dataclasses.replace(s, spans={}) == _summarize_before(events)


TRAIN = {"assign_ms.train": ("det.prepare_batch/det.assign", "device_s"),
         "forward_ms.train": ("det.train_step/det.model", "device_s"),
         "backward_ms.train": ("det.train_step/det.backward", "device_s"),
         "optimizer_ms.train": ("det.train_step/det.optimizer", "device_s")}
PREDICT = {"fusion_ms.predict": ("det.predict/det.model/det.fuse", "device_s"),
           "heads_ms.predict": ("det.predict/det.model/det.heads", "device_s"),
           "nms_ms.predict": ("det.predict/det.nms", "device_s"),
           "nms_launches.predict": ("det.predict/det.nms", "launches"),
           "host_syncs.predict": ("det.predict", "syncs")}


def _reading(cell, events):
    c = load_cell(cell)
    summary = trace.summarize(events) if events is not None else None
    return Reading(c.config, c.traffic, 16, 10, 2.0, 10 ** 14, None, {}, summary)


def _read(name, r):
    return load_file(BENCH / "metrics" / f"{name}.py", name).read(r)


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(PREDICT) + ["host_syncs.train"])
def test_each_span_metric_reads_its_span(name):
    train = name.endswith(".train")
    events = train_trace(2) if train else predict_trace(3)
    calls = 2 if train else 3
    t = spans.span_totals(events)
    if name == "host_syncs.train":
        want = (t["det.prepare_batch"]["syncs"] + t["det.train_step"]["syncs"]) / calls
        assert want == 5
    else:
        path, field = (TRAIN if train else PREDICT)[name]
        want = t[path][field] / calls * (1e3 if field == "device_s" else 1)
    cell = "disco_train" if train else "v2v_predict"
    assert _read(name, _reading(cell, events)) == pytest.approx(want)
    assert _read(name, _reading(cell, None)) is None
    # The span (or its entry) missing: nothing to read.
    path = {"host_syncs.train": "det.prepare_batch"}.get(name) or (TRAIN if train else PREDICT)[name][0]
    leaf = path.split("/")[-1]
    cut = [e for e in events if e["name"] != leaf]
    assert _read(name, _reading(cell, cut)) is None


def test_span_metrics_are_listed_with_their_cells():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in spec["per_layer"]}
    for name in list(TRAIN) + ["host_syncs.train"]:
        m = listed[name]
        assert m["source"] == "device_trace" and m["moves"] == "train_scenes_per_sec"
        assert m["workloads"] == ["disco_train", "v2v_train"]
    for name in PREDICT:
        m = listed[name]
        assert m["source"] == "device_trace" and m["moves"] == "predict_scenes_per_sec"
        assert m["workloads"] == ["v2v_predict", "disco_predict"]
