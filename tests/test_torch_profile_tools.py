"""The port's profiling and loader-benchmark tools, on the CPU.

  * ``xprof_det --cpu --grid small`` traces train, prepare and predict,
    labels its self times CPU, prints every category, reports no busy
    share, and prints its by-span table: each entry's span tree once a
    call, with host ms and no device column; ``--report_only`` on that
    trace (which holds no device event) exits non-zero and says so. The
    trace report's busy share is the union of the device intervals over
    the window from the first launch to the end of the final synchronize
    (a hand-made trace).
  * The by-span table of a hand-made device trace: kernels credited
    through ``args.correlation`` to the innermost ``det.`` span open on
    the entry's thread when their launch began, a launch from another
    thread inside ``det.backward`` among them; syncs counted by span, the
    harness-style synchronize outside every span left out.
  * ``bench_loader`` prints the JAX tool's JSON keys, for the reader and
    for ``--cache``.
  * Without ``--cpu`` and without a card, every new tool raises.
"""

import contextlib
import io
import json

import pytest
import torch

from v2x_sim_tpu_torch.tools import (
    bench_loader,
    bench_table,
    bench_table_track,
    diag_upperbound,
    diag_v2v,
    xprof_det,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

SMALL = ["--cpu", "--grid", "small", "--batch", "2"]


def _run(tool, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = tool.main(argv)
    return result, out.getvalue()


#: Each traced entry's span paths (DiscoNet, no KD, one process).
SPAN_TREES = {
    "train": ["det.train_step", "det.train_step/det.model", "det.train_step/det.model/det.encode",
              "det.train_step/det.model/det.fuse", "det.train_step/det.model/det.heads",
              "det.train_step/det.loss", "det.train_step/det.backward",
              "det.train_step/det.optimizer"],
    "prepare": ["det.prepare_batch", "det.prepare_batch/det.voxelize",
                "det.prepare_batch/det.assign", "det.prepare_batch/det.assign/det.assign.nearest",
                "det.prepare_batch/det.assign/det.assign.iou",
                "det.prepare_batch/det.assign/det.assign.forced"],
    "predict": ["det.predict", "det.predict/det.voxelize", "det.predict/det.model",
                "det.predict/det.model/det.encode", "det.predict/det.model/det.fuse",
                "det.predict/det.model/det.heads", "det.predict/det.decode", "det.predict/det.nms",
                "det.predict/det.nms/det.nms.iou", "det.predict/det.nms/det.nms.greedy"],
}


@pytest.mark.parametrize("what", ["train", "prepare", "predict"])
def test_xprof_det_reports_cpu_self_time(what, tmp_path):
    trace_dir = str(tmp_path / "xt")
    rep, text = _run(xprof_det, SMALL + ["--what", what, "--top", "5", "--trace_dir", trace_dir])
    lines = text.splitlines()
    assert lines[0] == "device: CPU"
    assert lines[1].startswith(f"{what}: total CPU self time:")
    for cat in xprof_det.CATEGORIES:
        assert any(line.strip().startswith(cat) for line in lines), cat
    assert "device busy share: not measured (CPU run)" in lines
    assert len(rep["top_ms"]) == 5 and rep["total_ms"] > 0 and "busy" not in rep
    # The by-span table: the entry's tree once a call, in order, with host
    # times that nest and no device column on the CPU.
    spans = rep["spans"]
    assert list(spans) == SPAN_TREES[what]
    assert all(r["calls"] == 1.0 and r["host_ms"] > 0 for r in spans.values())
    assert all(r["device_ms"] is r["launches"] is r["syncs"] is None for r in spans.values())
    entry = SPAN_TREES[what][0]
    assert sum(spans[p]["host_ms"] for p in spans if p.count("/") == 1) <= spans[entry]["host_ms"]
    table = lines[lines.index(next(x for x in lines if x.startswith("by span"))) + 2:]
    assert [row.split()[0] for row in table] == SPAN_TREES[what]
    assert all(row.split()[3:] == ["-", "-", "-"] for row in table)
    with pytest.raises(SystemExit, match="holds no device events"):
        _run(xprof_det, ["--report_only", "--what", what, "--trace_dir", trace_dir])


def test_trace_report_busy_share(tmp_path):
    """Two overlapping kernels (10-40 and 30-50 us) and a memcpy (70-80 us)
    over a 100 us window: busy 50 us."""
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1000, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void rotated_iou_pairs_periodic_kernel(...)",
         "ts": 1010, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_bf16", "ts": 1030, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 1070, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 1080, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 990, "dur": 200},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rep = xprof_det.device_report(str(path), top=2)
    steps = xprof_det.STEPS
    assert rep["busy"] == pytest.approx(0.5) and rep["idle"] == pytest.approx(0.5)
    assert rep["window_ms"] == pytest.approx(0.1 / steps)
    cats = rep["categories_ms"]
    assert cats["rotated_iou (K1, K2)"] == pytest.approx(0.03 / steps)
    assert cats["cuDNN conv"] == pytest.approx(0.02 / steps)
    assert cats["memcpy/memset"] == pytest.approx(0.01 / steps)
    assert [n for n, _ in rep["top_ms"]] == ["void rotated_iou_pairs_periodic_kernel(...)",
                                             "sm90_xmma_fprop_implicit_gemm_bf16"]
    assert xprof_det.device_report(str(path), 2) is not None
    assert rep["spans"] == {}  # no program span in this trace
    path.write_text(json.dumps({"traceEvents": events[-1:]}))
    assert xprof_det.device_report(str(path), 2) is None


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


#: Two steps on the entry's thread 1; the backward's launches come from
#: thread 2 (the autograd engine's) while thread 1 waits in det.backward.
SPAN_EVENTS = [
    _ev("bench.window", "user_annotation", 0, 1000),
    _ev("aten::add", "cpu_op", 0, 5),
    # Step 1.
    _ev("det.train_step", "user_annotation", 10, 400),
    _ev("det.model", "user_annotation", 20, 100),
    _ev("det.encode", "user_annotation", 25, 50),
    _ev("cudaLaunchKernel", "cuda_runtime", 30, 4, corr=1),
    _ev("conv_kernel", "kernel", 40, 60, tid=7, corr=1),
    _ev("cuLaunchKernel", "cuda_driver", 90, 4, corr=2),  # det.model's own
    _ev("gemm_kernel", "kernel", 100, 30, tid=7, corr=2),
    _ev("det.backward", "user_annotation", 150, 200),
    _ev("cudaLaunchKernel", "cuda_runtime", 160, 4, tid=2, corr=3),
    _ev("wgrad_kernel", "kernel", 170, 100, tid=7, corr=3),
    _ev("cudaMemsetAsync", "cuda_runtime", 200, 2, tid=2, corr=4),
    _ev("Memset (Device)", "gpu_memset", 280, 10, tid=7, corr=4),
    _ev("det.optimizer", "user_annotation", 360, 40),
    _ev("cudaMemcpyAsync", "cuda_runtime", 362, 3, corr=5),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 365, 1, tid=7, corr=5),
    _ev("cudaStreamSynchronize", "cuda_runtime", 366, 20, corr=6),
    _ev("cudaLaunchKernel", "cuda_runtime", 390, 4, corr=7),
    _ev("adam_kernel", "kernel", 395, 20, tid=7, corr=7),
    # Step 2: the model alone, then the harness's synchronize outside it.
    _ev("det.train_step", "user_annotation", 500, 100),
    _ev("det.model", "user_annotation", 510, 50),
    _ev("cudaLaunchKernel", "cuda_runtime", 520, 4, corr=8),
    _ev("gemm_kernel", "kernel", 530, 30, tid=7, corr=8),
    _ev("bench.sync", "user_annotation", 600, 100),
    _ev("cudaDeviceSynchronize", "cuda_runtime", 601, 90),
    _ev("cudaLaunchKernel", "cuda_runtime", 700, 4, corr=9),  # in no det. span
    _ev("other_kernel", "kernel", 710, 5, tid=7, corr=9),
]


def test_trace_report_credits_spans(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": SPAN_EVENTS}))
    spans = xprof_det.device_report(str(path), top=3)["spans"]
    assert list(spans) == ["det.train_step", "det.train_step/det.model",
                           "det.train_step/det.model/det.encode", "det.train_step/det.backward",
                           "det.train_step/det.optimizer"]
    row = lambda p: [spans[p][k] for k in ("calls", "launches", "syncs")]
    # A call of the entry: two steps.
    assert row("det.train_step") == [1.0, 2.5, 0.5]
    assert row("det.train_step/det.model") == [1.0, 1.5, 0.0]
    assert row("det.train_step/det.model/det.encode") == [0.5, 0.5, 0.0]
    assert row("det.train_step/det.backward") == [0.5, 0.5, 0.0]
    assert row("det.train_step/det.optimizer") == [0.5, 0.5, 0.5]
    ms = lambda p: spans[p]["device_ms"]
    assert ms("det.train_step/det.model/det.encode") == pytest.approx(0.060 / 2)
    assert ms("det.train_step/det.model") == pytest.approx((0.060 + 0.030 + 0.030) / 2)
    assert ms("det.train_step/det.backward") == pytest.approx((0.100 + 0.010) / 2)
    assert ms("det.train_step/det.optimizer") == pytest.approx((0.001 + 0.020) / 2)
    assert ms("det.train_step") == pytest.approx((0.120 + 0.110 + 0.021) / 2)
    assert spans["det.train_step"]["host_ms"] == pytest.approx((0.400 + 0.100) / 2)
    totals = xprof_det.span_totals(SPAN_EVENTS)
    assert totals["det.train_step"]["calls"] == 2
    assert sum(t["syncs"] for p, t in totals.items() if "/" not in p) == 1  # bench.sync's left out


def test_bench_loader_prints_the_jax_keys():
    out, text = _run(bench_loader, ["--files", "4", "--points", "2000", "--epochs", "1"])
    assert json.loads(text.splitlines()[-1]) == out
    assert list(out) == ["files", "points_per_file", "max_points", "native_sweeps_per_sec",
                         "numpy_sweeps_per_sec", "native_available", "mb_per_sec_native"]
    assert out["numpy_sweeps_per_sec"] > 0


def test_bench_loader_cache_reads_baked_frames():
    out, _ = _run(bench_loader, ["--cache", "--cpu", "--files", "1", "--epochs", "1"])
    keys = [f"{tag}_{k}" for tag in ("compressed", "uncompressed")
            for k in ("w0_frames_per_sec", "w4_frames_per_sec", "mb")]
    assert sorted(out) == sorted(keys)
    assert out["compressed_mb"] < out["uncompressed_mb"]


@pytest.mark.parametrize("tool,argv", [
    (bench_table, ["--steps", "1"]),
    (bench_table_track, ["--states", "."]),
    (diag_v2v, ["--steps", "1"]),
    (diag_upperbound, ["--steps", "1"]),
    (xprof_det, []),
    (bench_loader, ["--cache"]),
])
def test_tools_raise_without_a_card(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
