"""Checkpoints, resume and fresh weights of the port (``train/checkpoint.py``,
``DetModule.step``, ``models/init.py``), on the CPU at the 64x64x8 grid
and width_mult 0.25.

  * save, ``latest_checkpoint`` and restore round-trip exactly (model,
    BatchNorm buffers, Adam state, step count);
  * k steps, a checkpoint, a restore into a fresh module and N - k more
    steps end with parameters, BatchNorm statistics and Adam moments
    bitwise equal to N uninterrupted steps;
  * ``restore_teacher`` loads an upperbound run's checkpoint as the KD
    teacher;
  * ``init_weights`` draws flax's defaults: zero biases, unit norm scales,
    running statistics at 0 and 1, and LeCun-normal kernels truncated at
    two standard deviations with a standard deviation within 5% of
    1/sqrt(fan_in), as ``jax.nn.initializers.lecun_normal`` draws them.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax

from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.models.init import TRUNC_STD, truncated_normal
from v2x_sim_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    restore_teacher,
    save_checkpoint,
)
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

CFG = Config(grid=GridConfig(voxel_size=(1.0, 1.0, 0.625)))
WIDTH = 0.25
N_STEPS = 3


def _module(seed, mode="disco", **kw):
    module = DetModule(CFG, mode, device="cpu", width_mult=WIDTH, **kw)
    module.init_weights(seed)
    return module


@pytest.fixture(scope="module")
def prepared():
    spec = SyntheticSpec(points_per_agent=1024, max_gt=16)
    preparer = DetModule(CFG, "disco", device="cpu", width_mult=WIDTH)
    return [preparer.prepare_batch(generate_batch(CFG, spec, 2, seed=s)) for s in range(N_STEPS)]


def _assert_same_state(got: DetModule, want: DetModule):
    gsd, wsd = got.model.state_dict(), want.model.state_dict()
    assert gsd.keys() == wsd.keys()
    for key in wsd:
        assert torch.equal(gsd[key], wsd[key]), key
    gopt, wopt = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert gopt["param_groups"] == wopt["param_groups"]
    assert gopt["state"].keys() == wopt["state"].keys() and wopt["state"]
    for idx, state in wopt["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(gopt["state"][idx][name], state[name]), (idx, name)
    assert got.step == want.step


def test_checkpoint_round_trip(tmp_path, prepared):
    module = _module(0)
    module.train_step(prepared[0])
    path = save_checkpoint(str(tmp_path), module, 4)
    assert path == str(tmp_path / "epoch_4") and module.step == 1
    fresh = _module(1)
    assert not torch.equal(fresh.model.state_dict()["encoder.blocks.0.conv1.weight"],
                           module.model.state_dict()["encoder.blocks.0.conv1.weight"])
    restore_checkpoint(path, fresh)
    _assert_same_state(fresh, module)
    assert not list(tmp_path.glob("*.tmp"))  # written under a temporary name, then renamed


def test_latest_checkpoint_picks_the_largest_epoch(tmp_path, prepared):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    module = _module(0)
    for epoch in (2, 10, 9):
        save_checkpoint(str(tmp_path), module, epoch)
    (tmp_path / "epoch_11.123.tmp").write_bytes(b"")  # a write cut off
    (tmp_path / "epoch_best").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_10")


@pytest.mark.parametrize("k", [1, 2])
def test_resume_is_bitwise_uninterrupted_training(tmp_path, prepared, k):
    straight = _module(0)
    for p in prepared:
        straight.train_step(p)

    first = _module(0)
    for p in prepared[:k]:
        first.train_step(p)
    save_checkpoint(str(tmp_path), first, 0)
    resumed = _module(5)
    restore_checkpoint(latest_checkpoint(str(tmp_path)), resumed)
    assert resumed.step == k
    for p in prepared[k:]:
        resumed.train_step(p)
    _assert_same_state(resumed, straight)
    assert resumed.step == N_STEPS


def test_restore_teacher_loads_an_upperbound_checkpoint(tmp_path, prepared):
    teacher_run = _module(7, mode="upperbound")
    path = save_checkpoint(str(tmp_path), teacher_run, 0)
    student = _module(0, kd_weight=1e5)
    restore_teacher(path, student)
    want = teacher_run.model.state_dict()
    got = student.teacher.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[key], want[key]) for key in want)
    assert not any(p.requires_grad for p in student.teacher.parameters())
    p = DetModule(CFG, "disco", device="cpu", width_mult=WIDTH, kd_weight=1e5).prepare_batch(
        generate_batch(CFG, SyntheticSpec(points_per_agent=1024, max_gt=16), 2, seed=0))
    metrics = student.train_step(p)
    assert math.isfinite(float(metrics["kd_loss"])) and float(metrics["kd_loss"]) > 0
    with pytest.raises(FileNotFoundError):
        restore_teacher(str(tmp_path / "epoch_99"), student)
    with pytest.raises(ValueError, match="kd_weight"):
        restore_teacher(path, _module(0))


def test_truncated_normal_draws_like_flax():
    """TRUNC_STD is the standard deviation of a unit normal cut at +-2;
    the draws and jax's lecun_normal agree in spread and support."""
    z = 2.0
    pdf = math.exp(-z * z / 2) / math.sqrt(2 * math.pi)
    mass = math.erf(z / math.sqrt(2))
    assert abs(TRUNC_STD - math.sqrt(1 - 2 * z * pdf / mass)) < 1e-12
    shape, fan_in = (64, 32, 3, 3), 32 * 9
    got = truncated_normal(shape, 1 / math.sqrt(fan_in), torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (3, 3, 32, 64)))
    for x in (got, want):
        assert abs(x.std() * math.sqrt(fan_in) - 1) < 0.03
        assert np.abs(x).max() * math.sqrt(fan_in) <= 2 / TRUNC_STD + 1e-5
        assert abs(x.mean()) * math.sqrt(fan_in) < 0.03
    assert abs(got.std() / want.std() - 1) < 0.04


@pytest.mark.parametrize("mode, opts", [
    ("disco", {}), ("when2com", {}), ("v2v", {"fusion": {"msg_norm": True}}),
], ids=["disco", "when2com", "v2v-groupnorm"])
def test_init_weights_draws_flax_defaults(mode, opts):
    module = DetModule(Config(), mode, device="cpu", **opts)  # full widths: 32..512
    module.init_weights(3)
    kinds = set()
    for name, mod in module.model.named_modules():
        if isinstance(mod, (nn.modules.conv._ConvNd, nn.Linear)):
            w = mod.weight.detach()
            scaled = w * math.sqrt(w[0].numel())
            assert float(scaled.abs().max()) <= 2 / TRUNC_STD + 1e-5, name
            if w.numel() >= 4096:
                assert abs(float(scaled.std()) - 1) < 0.05, (name, float(scaled.std()))
            if mod.bias is not None:
                assert not mod.bias.any(), name
            kinds.add(type(mod))
        elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
            assert bool((mod.weight == 1).all()) and not mod.bias.any(), name
            if isinstance(mod, nn.BatchNorm2d):
                assert not mod.running_mean.any() and bool((mod.running_var == 1).all()), name
            kinds.add(type(mod))
    want = {nn.Conv2d, nn.BatchNorm2d} | ({nn.Linear} if mode == "when2com" else set()) | (
        {nn.GroupNorm} if mode == "v2v" else set())
    assert want <= kinds
    again = DetModule(Config(), mode, device="cpu", **opts)
    again.init_weights(3)
    other = DetModel(Config(), mode, **opts)
    assert all(torch.equal(a, b) for a, b in zip(again.model.state_dict().values(),
                                                 module.model.state_dict().values()))
    assert not torch.equal(other.state_dict()["encoder.blocks.0.conv1.weight"],
                           module.model.state_dict()["encoder.blocks.0.conv1.weight"])


def test_init_teacher_weights_draws_flax_defaults():
    student = DetModule(CFG, "disco", device="cpu", width_mult=WIDTH, kd_weight=1e5)
    student.init_teacher_weights(1)
    conv = student.teacher.encoder.blocks[0].conv1.weight
    assert float((conv * math.sqrt(conv[0].numel())).abs().max()) <= 2 / TRUNC_STD + 1e-5
    heads = [m for m in student.teacher.modules() if isinstance(m, nn.Conv2d) and m.bias is not None]
    assert heads and not any(m.bias.any() for m in heads)
