"""The trace's arithmetic on hand-made events (the busy union, the idle
gaps named by the harness's span and operator, kernel sums), the IoU
kernels' byte counts, the percentile, and the per-layer readers on a
hand-made reading."""

import pytest

from benchmark.harness import roofline, trace
from benchmark.harness.cell import BENCH, Reading, load_cell, load_file, percentile


def _ev(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X", "pid": 1, "tid": tid}


EVENTS = [
    _ev("bench.window", "user_annotation", 0, 100),
    _ev("bench.predict", "user_annotation", 0, 60),
    _ev("aten::conv", "cpu_op", 38, 12),
    _ev("bench.sync", "user_annotation", 60, 40),
    _ev("k1", "kernel", 10, 20, tid=7),
    _ev("k2", "kernel", 25, 15, tid=7),
    _ev("rotated_iou_matrix_kernel", "kernel", 70, 10, tid=7),
    _ev("memcpy", "gpu_memcpy", 90, 20, tid=7),  # runs past the window's end
]


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_busy_idle_and_kernels():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((30 + 10 + 10) * 1e-6)  # [10,40], [70,80], [90,100]
    assert s.kernel_time("rotated_iou_matrix") == (1, pytest.approx(10e-6))
    # Each gap is named by what the harness's thread had open when it began.
    assert s.idle["bench.predict | -"] == pytest.approx(10e-6)  # [0, 10]
    assert s.idle["bench.predict | aten::conv"] == pytest.approx(30e-6)  # [40, 70]
    assert s.idle["bench.sync | -"] == pytest.approx(10e-6)  # [80, 90]
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 3


def test_a_trace_without_device_events_raises():
    with pytest.raises(RuntimeError, match="no device event"):
        trace.summarize([e for e in EVENTS if e["cat"] not in trace.DEVICE_CATS])


def test_iou_bytes():
    assert roofline.matrix_bytes(2, 3, 4) == 4 * (5 * 2 * 7 + 2 * 12)
    assert roofline.periodic_bytes(10, 40) == 200 + 800
    assert roofline.forced_bytes(3, 6) == 21 * 3 + 24 * 18 + 17 * 3


def test_percentile():
    assert percentile([4.0, 1.0, 3.0, 2.0, 5.0], 50) == 3.0
    assert percentile(list(range(101)), 95) == 95.0
    assert percentile([1.0, 2.0], 95) == pytest.approx(1.95)


def test_readers_on_a_reading():
    c = load_cell("disco_predict")
    s = trace.summarize(EVENTS)
    peaks = {"bf16_flops": 1e15, "hbm_bytes_per_s": 1e12}
    r = Reading(c.config, c.traffic, 16, 10, 2.0, 10 ** 14, peaks, {}, s)
    read = lambda name: load_file(BENCH / "metrics" / f"{name}.py", name).read(r)
    assert read("mfu_pct.predict") == pytest.approx(100 * 1e14 * 10 / 2.0 / 1e15)
    assert read("device_idle_pct.predict") == pytest.approx(50.0)
    g = 16 * 6
    want = 100 * roofline.matrix_bytes(g, 128, 128) / 1e12 / 10e-6
    assert read("iou_roofline_pct.predict") == pytest.approx(want)
    # A pair's files share one body; BENCHMARK.json's workloads pick the cells.
    assert read("mfu_pct.train") == read("mfu_pct.predict")
    assert read("device_idle_pct.train") == read("device_idle_pct.predict")
    assert read("iou_roofline_pct.train") is None  # no assignment kernel in this trace
    assert read("prepare_ms.train") is None
