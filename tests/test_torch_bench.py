"""The port's headline bench (``v2x_sim_tpu_torch/bench.py``, run by the
root ``bench_torch.py``) and its baseline, the reference graph's copy
(``v2x_sim_tpu_torch/baselines/torch_ref.py``), on the CPU.

The reference-graph copy is held bit for bit to the JAX package's
``baselines/torch_ref.py`` on one state dict and one seeded input. The
FLOP count behind ``mfu_pct``/``train_mfu_pct`` is held to an analytic
sum over the model's convolutions and the fusion's 1x1 products
(2·k²·C_in·C_out·H_out·W_out each), and the train step's to the same sum
with the backward's input and weight gradients. The bench itself runs at
tests/test_bench_cached_pipeline.py's CFG/SPEC: its JSON line carries
exactly the JAX bench's keys plus ``baseline_scenes_per_sec``; a failing
stage raises; the orchestrator prints an ``error`` line and returns 1.
"""

import ast
import json
import math
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from v2x_sim_tpu.baselines import torch_ref as jax_torch_ref
from v2x_sim_tpu_torch import bench
from v2x_sim_tpu_torch.baselines import torch_ref
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.backbone import width_mult as scaled_widths
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.test_reference_parity import _inputs, _randomize_bn_stats
from tests.test_torch_model import CFG as MODEL_CFG
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: tests/test_bench_cached_pipeline.py's: a 32x32x4 grid at 2 m, 2 agents.
CFG = Config(
    grid=GridConfig(voxel_size=(2.0, 2.0, 1.25), area_extents=((-32, 32), (-32, 32), (-3, 2))),
    num_agents=2,
    fusion_layer=1,
)
SPEC = SyntheticSpec(num_vehicles=4, points_per_agent=256, max_gt=8, occlusion_prob=0.3)
#: The dry run's grid (graft_entry._tiny_setup): 64x64x8 at 1 m, 6 agents.
TINY = Config(grid=GridConfig(voxel_size=(1.0, 1.0, 0.625)))
FLOP_CASES = {"bench_test_grid": (CFG, 0.25, 2), "dryrun_grid": (TINY, 0.25, 1)}


def _jax_bench_keys():
    """The keys of the JSON line the JAX package's root bench.py prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "train_mfu_pct" for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError("bench.py prints no dict with train_mfu_pct")


def test_reference_graph_copy_is_bit_equal_to_the_jax_packages():
    grid = MODEL_CFG.grid
    args = (grid.grid_shape, grid.area_extents, MODEL_CFG.anchors.num_anchors,
            MODEL_CFG.num_classes, MODEL_CFG.anchors.box_code_size, MODEL_CFG.fusion_layer)
    torch.manual_seed(5)
    ref = jax_torch_ref.build_model(*args)(mode="disco").eval()
    _randomize_bn_stats(ref)
    port = torch_ref.build_model(*args)(mode="disco").eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    occ, trans, mask = _inputs(seed=4)
    inputs = (torch.from_numpy(occ.transpose(0, 1, 4, 2, 3)), torch.from_numpy(trans),
              torch.from_numpy(mask))
    with torch.no_grad():
        want, got = ref(*inputs), port(*inputs)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert torch.equal(g, w)
    assert torch_ref.STAGE_CHANNELS == jax_torch_ref.STAGE_CHANNELS


def test_reference_measure_runs_on_a_bench_batch_and_restores_tf32():
    module = DetModule(CFG, "disco", device="cpu")
    batch = module.prepare_batch(generate_batch(CFG, SPEC, 2, seed=0))
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    rate = torch_ref.measure(batch["occupancy"], batch["trans"], batch["agent_mask"], "cpu",
                             steps=1, warmup=0, config=CFG)
    assert rate > 0 and math.isfinite(rate)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


def _analytic_flops(cfg, wm, b):
    """FLOPs of DetModel(cfg, "disco", wm)'s forward on b scenes, summed
    over its layers' shapes: 2·k²·C_in·C_out·H_out·W_out a conv (the 3x3
    pad-1 convs halve a map's size at stride 2, rounding up); the fusion's
    1x1 edge convs as products: the ego half of ``edge_hidden`` once an
    ego agent, its warped half and ``edge_score`` once a pair. Returns
    (forward, the stem conv's), the stem's input needing no gradient."""
    h, w, d = cfg.grid.grid_shape
    n, a = b * cfg.num_agents, cfg.num_agents
    chans = scaled_widths(wm)

    def conv(k, cin, cout, rows, cols):
        return 2 * k * k * cin * cout * rows * cols * n

    sizes = [(h, w)]
    for _ in chans[1:]:
        sizes.append((-(-sizes[-1][0] // 2), -(-sizes[-1][1] // 2)))
    stem = conv(3, d, chans[0], h, w)
    total, cin = 0, d
    for c, (rows, cols) in zip(chans, sizes):
        total += conv(3, cin, c, rows, cols) + conv(3, c, c, rows, cols)
        cin = c
    for i in range(len(chans) - 1):
        cout, (rows, cols) = chans[-2 - i], sizes[-2 - i]
        total += conv(3, chans[-1 - i] + cout, cout, rows, cols) + conv(3, cout, cout, rows, cols)
    k = cfg.anchors.num_anchors
    for out in (k * cfg.num_classes, k * cfg.anchors.box_code_size):
        total += conv(3, chans[0], 32, h, w) + conv(1, 32, out, h, w)
    c, (rows, cols), hidden = chans[cfg.fusion_layer], sizes[cfg.fusion_layer], 32
    cells = rows * cols
    total += 2 * b * a * cells * c * hidden + 2 * b * a * a * cells * (c * hidden + hidden)
    return total, stem


@pytest.mark.parametrize("case", list(FLOP_CASES))
def test_forward_flop_count_equals_the_analytic_sum(case):
    cfg, wm, b = FLOP_CASES[case]
    model = DetModel(cfg, "disco", wm).eval()
    occ, trans, mask = (torch.from_numpy(x) for x in _random_inputs(cfg, b))
    want, _ = _analytic_flops(cfg, wm, b)
    with torch.no_grad():
        assert bench.count_flops(lambda: model(occ, trans, mask)) == want
    # predict adds no convolution or product: the bench's count is the model's.
    module = DetModule(cfg, "disco", width_mult=wm, device="cpu")
    batch = generate_batch(cfg, SPEC, b, seed=0)
    assert bench.count_flops(lambda: module.predict(batch, 16, 0.1, 0.3)) == want


@pytest.mark.parametrize("case", list(FLOP_CASES))
def test_train_step_flop_count_adds_input_and_weight_gradients(case):
    cfg, wm, b = FLOP_CASES[case]
    module = DetModule(cfg, "disco", width_mult=wm, device="cpu")
    prepared = module.prepare_batch(generate_batch(cfg, SPEC, b, seed=1))
    forward, stem = _analytic_flops(cfg, wm, b)
    assert bench.count_flops(lambda: module.train_step(prepared)) == 3 * forward - stem


def test_count_flops_without_a_count_raises():
    with pytest.raises(RuntimeError, match="no FLOPs"):
        bench.count_flops(lambda: torch.ones(3) + 1)


def _random_inputs(cfg, b):
    rng = np.random.default_rng(0)
    a = cfg.num_agents
    h, w, d = cfg.grid.grid_shape
    occ = (rng.random((b, a, h, w, d)) < 0.05).astype(np.float32)
    trans = np.tile(np.eye(4, dtype=np.float32), (b, a, a, 1, 1))
    trans[..., :2, 3] = rng.uniform(-4, 4, (b, a, a, 2)).astype(np.float32)
    return occ, trans, np.ones((b, a), bool)


def test_cached_pipeline_stage_runs_and_reports_rate(capsys):
    module = DetModule(CFG, "disco", width_mult=0.25, device="cpu")
    module.init_weights(0)
    sps = bench._cached_pipeline_sps(module, CFG, SPEC, CPU, batch=2)
    assert sps > 0.0 and math.isfinite(sps)
    assert "cached-pipeline decomposition" in capsys.readouterr().err


def test_run_prints_one_line_with_the_jax_bench_keys(capsys):
    result = bench.run(CFG, SPEC, batch=2, steps=1, train_steps=1, device="cpu", peak_flops=1e12)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == result
    assert set(line) == _jax_bench_keys() | {"baseline_scenes_per_sec"}
    assert line["metric"] == bench.METRIC_NAME and line["unit"] == "scenes/sec"
    for key in ("value", "train_scenes_per_sec", "train_e2e_scenes_per_sec",
                "train_cached_scenes_per_sec", "baseline_scenes_per_sec", "vs_baseline",
                "tflops", "mfu_pct", "train_tflops", "train_mfu_pct"):
        assert line[key] > 0 and math.isfinite(line[key]), key
    assert line["vs_baseline"] == pytest.approx(line["value"] / line["baseline_scenes_per_sec"])
    assert line["mfu_pct"] == pytest.approx(100 * line["tflops"] * 1e12 / 1e12)
    assert "bench: CPU; bf16 peak 1.0 TFLOP/s" in out.err


def test_a_failing_cached_stage_makes_run_raise(monkeypatch):
    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(bench, "save_frame", full_disk)
    with pytest.raises(OSError, match="no space left"):
        bench.run(CFG, SPEC, batch=2, steps=1, train_steps=1, device="cpu", peak_flops=1e12)


@pytest.mark.parametrize("failure", ["preflight", "attempt", "none"])
def test_main_prints_one_line_and_exits_1_on_failure(monkeypatch, capsys, failure):
    good = json.dumps({"metric": bench.METRIC_NAME, "value": 1.0})
    attempts = []
    monkeypatch.setattr(bench, "_preflight",
                        lambda: "preflight failed rc=1: no card" if failure == "preflight" else "")
    monkeypatch.setattr(bench, "_attempt", lambda: attempts.append(1) or (
        (None, "rc=1; stderr tail: boom") if failure == "attempt" else (good, "")))
    rc = bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    if failure == "none":
        assert rc == 0 and lines[0] == good and attempts == [1]
        return
    assert rc == 1 and line["value"] == 0.0 and line["metric"] == bench.METRIC_NAME
    assert ("no card" if failure == "preflight" else "boom") in line["error"]
    assert attempts == ([] if failure == "preflight" else [1])  # one attempt, no retry


@pytest.mark.parametrize("outcome", ["ok", "rc", "no_line", "timeout"])
def test_attempt_reads_the_runs_last_line(monkeypatch, capsys, outcome):
    line = json.dumps({"metric": bench.METRIC_NAME, "value": 2.5})

    def fake_run(cmd, **kwargs):
        assert cmd[1:] == [str(ROOT / "bench_torch.py"), "--run"]
        assert kwargs["timeout"] == bench.ATTEMPT_TIMEOUT_S
        if outcome == "timeout":
            raise subprocess.TimeoutExpired(cmd, kwargs["timeout"], stderr=b"stuck")
        stdout = "noise\n" + (line if outcome != "no_line" else "done")
        return subprocess.CompletedProcess(cmd, 1 if outcome == "rc" else 0, stdout, "log\n")

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    got, err = bench._attempt()
    if outcome == "ok":
        assert (got, err) == (line, "")
        assert capsys.readouterr().err == "log\n"
    else:
        assert got is None and err
        assert ("timeout" in err) == (outcome == "timeout")


def test_an_unknown_card_raises():
    assert bench.peak_flops_of("NVIDIA H100 80GB HBM3") == 989.4e12
    with pytest.raises(ValueError, match="no bf16 peak"):
        bench.peak_flops_of("NVIDIA GeForce RTX 4090")
    with pytest.raises(ValueError, match="pass peak_flops"):
        bench.run(CFG, SPEC, device="cpu")
