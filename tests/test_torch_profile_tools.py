"""The port's profiling and loader-benchmark tools, on the CPU.

  * ``profile_det --cpu --grid small --train 1`` prints its device line
    (CPU) and every row of the cumulative stage budget, with the deltas.
  * ``xprof_det --cpu --grid small`` traces train, prepare and predict,
    labels its self times CPU, prints every category and reports no busy
    share; ``--report_only`` on that trace (which holds no device event)
    exits non-zero and says so. The trace report's busy share is the
    union of the device intervals over the window from the first launch
    to the end of the final synchronize (a hand-made trace).
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
    profile_det,
    xprof_det,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

SMALL = ["--cpu", "--grid", "small", "--batch", "2"]


def _run(tool, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = tool.main(argv)
    return result, out.getvalue()


def test_profile_det_prints_every_row_on_cpu():
    rows, text = _run(profile_det, SMALL + ["--steps", "1", "--train", "1"])
    labels = ["vox", "+enc", "+fuse", "+dec", "+heads", "+decode", "+nms", "prepare", "train"]
    assert list(rows) == labels
    lines = text.splitlines()
    assert lines[0] == "device: CPU"
    assert "cumulative stage budget (bf16)" in lines[1]
    for label in labels:
        assert any(line.startswith(f"{label} ") and "ms/batch" in line for line in lines), label
    assert sum("delta" in line for line in lines) == 6
    assert all(ms > 0 for ms in rows.values())


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
    path.write_text(json.dumps({"traceEvents": events[-1:]}))
    assert xprof_det.device_report(str(path), 2) is None


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
    (profile_det, []),
    (xprof_det, []),
    (bench_loader, ["--cache"]),
])
def test_tools_raise_without_a_card(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
