"""The fused train-mode BatchNorm + ReLU of bf16 maps (ops/cuda/bn_cu.py)
against the form it replaces, ``torch.relu(models/backbone.py::_bn(...,
train=True))``, on the CPU, where the Function runs its passes' plain
versions.

Held: the outputs, with at most 1e-3 of them differing and those by one
bf16 ulp; the running mean and variance; the gradients of x, weight and
bias. The input gradient is a closed form of the old graph's, summed in
another order before its one bf16 rounding, and its terms cancel: at most
1e-3 of its elements differ, each by at most 2^-7 of its channel's
largest magnitude (two bf16 ulps of it). The weight and bias gradients are
float32 sums of the same products: within 1e-5 of the largest. Also on two
gloo ranks, the moments and the backward's sums all-reduced over the
group; float32, float64 and inference that records a graph never reach
the passes and give the old path's outputs bit for bit; bf16 inference
takes the normalize + ReLU pass alone, on the running stats. The kernels
themselves are held to these plain versions on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.models.backbone import BN_MOMENTUM, ConvBlock, _bn, bn_relu
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.ops.cuda import bn_cu
from tests import torch_dist
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

#: Shares of outputs and input gradients allowed to differ (by one ulp).
DIFFER = 1e-3
#: The input gradient's gap, relative to its channel's largest magnitude.
DX_RTOL = 2.0 ** -7
#: The weight and bias gradients, relative to the largest.
PARAM_RTOL = 1e-5
#: (N, H, W) of the cases; 3 * 33 * 35 elements a channel make a constant
#: channel of 1.3 (1.296875 in bf16) read E[x^2] - E[x]^2 < 0 in float32.
SPATIAL = (3, 33, 35)
CONSTANT = 1.3


def _case(c, seed, constant=False, n=SPATIAL[0]):
    """A channels-last bf16 map (x), its cotangent (dy) and an affine, as
    conv outputs look: mean and scale vary by channel."""
    rng = np.random.default_rng(seed)
    _, h, w = SPATIAL
    loc, scale = rng.normal(0.0, 0.8, c), rng.uniform(0.3, 2.0, c)
    x = torch.from_numpy((rng.normal(0.0, 1.0, (n, h, w, c)) * scale + loc).astype(np.float32))
    if constant:
        x[..., 3] = CONSTANT
    x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    dy = torch.from_numpy(rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32))
    dy = dy.to(torch.bfloat16).permute(0, 3, 1, 2)
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.3, c).astype(np.float32))
    return x, dy, weight, bias


def _bn_module(weight, bias):
    bn = torch.nn.BatchNorm2d(weight.shape[0], eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    return bn


def _run(fused: bool, x, dy, weight, bias, group=None):
    """One layer forward and backward: y, dx, dweight, dbias and the running stats."""
    bn = _bn_module(weight, bias)
    x = x.clone().requires_grad_(True)
    if fused:
        y = bn_cu.batch_norm_relu(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps,
                                  BN_MOMENTUM, group)
    else:
        y = torch.relu(_bn(x, bn, True, group))
    y.backward(dy)
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits), float32."""
    v = v.float().abs()
    return torch.where(v > 0, torch.exp2(torch.floor(torch.log2(v)) - 7), 0.0)


def _assert_one_ulp_apart(got, want, what, atol=0.0):
    differ = got != want
    assert differ.float().mean().item() <= DIFFER, (what, differ.float().mean().item())
    gap = (got.float() - want.float()).abs()
    ulp = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    assert bool((gap <= torch.clamp(ulp, min=atol)).all()), (what, gap.max().item())


def _assert_same_layer(got, want, y_atol=0.0):
    """``y_atol``: an output gap allowed beyond one ulp, where the two
    layers' moments differ (on the card) and outputs near 0 carry
    float32's error of x - mean."""
    assert got["y"].dtype == torch.bfloat16 and got["dx"].dtype == torch.bfloat16
    _assert_one_ulp_apart(got["y"], want["y"], "y", y_atol)
    dx, want_dx = got["dx"].float(), want["dx"].float()
    assert (dx != want_dx).float().mean().item() <= DIFFER
    scale = want_dx.abs().amax(dim=(0, 2, 3), keepdim=True)
    assert bool(((dx - want_dx).abs() <= DX_RTOL * scale).all())
    for key in ("dweight", "dbias"):
        scale = want[key].abs().max().item()
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=PARAM_RTOL * scale)
    for key in ("running_mean", "running_var"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("c", [32, 64, 128, 256, 512])
def test_fused_matches_the_unfused_layer(c):
    x, dy, weight, bias = _case(c, seed=c)
    _assert_same_layer(_run(True, x, dy, weight, bias), _run(False, x, dy, weight, bias))


@pytest.mark.parametrize("c", [32, 256])
def test_fused_matches_the_unfused_layer_with_a_constant_channel(c):
    """A constant channel: the variance clips at 0, and its gradient stops
    there."""
    x, dy, weight, bias = _case(c, seed=c + 1, constant=True)
    stats = bn_cu.moments_plain(x)
    assert (stats[1] - stats[0] ** 2)[3].item() < 0  # the clip is taken
    got, want = _run(True, x, dy, weight, bias), _run(False, x, dy, weight, bias)
    _assert_same_layer(got, want)
    assert bool((got["y"][:, 3] == got["y"][0, 3, 0, 0]).all())


def test_plain_passes_compose_the_layer():
    """The four plain passes by hand: moments, then normalize_relu on the
    (C,) vectors the Function computes, equal the Function's output; the
    backward's sums give its gradients."""
    x, dy, weight, bias = _case(64, seed=5)
    mean, msq = bn_cu.moments_plain(x).unbind()
    var = (msq - mean * mean).clamp(min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    inv = weight * rstd
    y = bn_cu.normalize_relu_plain(x, mean, inv, bias)
    got = _run(True, x, dy, weight, bias)
    assert torch.equal(y, got["y"])
    s1, s2 = bn_cu.backward_reduce_plain(dy, y, x, mean).unbind()
    count = x.numel() // x.shape[1]
    c2 = torch.where(msq - mean * mean >= 0, rstd * rstd * s2 / count, 0.0)
    dx = bn_cu.backward_dx_plain(dy, y, x, mean, inv, s1 / count, c2)
    assert torch.equal(dx, got["dx"])
    assert torch.equal(s2 * rstd, got["dweight"]) and torch.equal(s1, got["dbias"])


def test_fused_matches_the_unfused_layer_on_two_ranks(tmp_path):
    """Two gloo ranks, each its own half of the batch: the moments averaged
    and the backward's sums all-reduced over the group, against the old
    path on the same group; the ranks' running stats agree."""
    c = 64
    halves = [_case(c, seed=20 + r, n=2) for r in range(2)]
    x = np.stack([h[0].float().numpy() for h in halves])
    dy = np.stack([h[1].float().numpy() for h in halves])
    weight, bias = halves[0][2].numpy(), halves[0][3].numpy()
    out = torch_dist.run(torch_dist.bn_relu_ranks, 2, tmp_path,
                         {"x": x, "dy": dy, "weight": weight, "bias": bias})
    for rank in out:
        got = {k: torch.from_numpy(v) for k, v in rank["fused"].items()}
        want = {k: torch.from_numpy(v) for k, v in rank["unfused"].items()}
        for key in ("y", "dx"):
            got[key], want[key] = got[key].to(torch.bfloat16), want[key].to(torch.bfloat16)
        _assert_same_layer(got, want)
    np.testing.assert_array_equal(out[0]["fused"]["running_var"], out[1]["fused"]["running_var"])
    # Each rank's own moments differ, so an unsynced layer would store others.
    alone = _run(True, torch.from_numpy(x[0]).to(torch.bfloat16), torch.from_numpy(dy[0]).to(
        torch.bfloat16), halves[0][2], halves[0][3])
    assert not np.allclose(alone["running_var"].numpy(), out[0]["fused"]["running_var"])


def _count_calls(monkeypatch):
    """Counts the CPU calls of each pass (the launch counters count only
    the card's)."""
    calls = {}
    for fn in bn_cu.WRAPPERS:
        def counted(*args, _fn=fn):
            calls[_fn.__name__] = calls.get(_fn.__name__, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(bn_cu, fn.__name__, counted)
    return calls


#: Inference's running mean and variance, drawn from a case's bias and weight.
RUNNING = (lambda bias: 2.0 * bias, lambda weight: weight * weight)


def _layers(x, dy, weight, bias, dtype, train, records):
    """bn_relu and relu(_bn(...)) on one map, each with a fresh BatchNorm
    (parameters float64 for float64 maps, else float32): the outputs, the
    running stats and, where autograd ``records``, the gradients of x,
    weight and bias. Inference runs on running stats of :data:`RUNNING`;
    without ``records``, under ``torch.no_grad()``."""
    pdtype = torch.float64 if dtype == torch.float64 else torch.float32
    runs = []
    for layer in (bn_relu, lambda x, bn, train: torch.relu(_bn(x, bn, train))):
        bn = _bn_module(weight.to(pdtype), bias.to(pdtype)).to(pdtype)
        if not train:
            with torch.no_grad():
                bn.running_mean.copy_(RUNNING[0](bias))
                bn.running_var.copy_(RUNNING[1](weight))
        xi = x.to(dtype).requires_grad_(records)
        with torch.set_grad_enabled(records):
            y = layer(xi, bn, train)
        if records:
            y.backward(dy.to(dtype))
        runs.append([y.detach(), bn.running_mean, bn.running_var]
                    + ([xi.grad, bn.weight.grad, bn.bias.grad] if records else []))
    return runs


@pytest.mark.parametrize("dtype,train,records", [
    (torch.float32, True, True), (torch.float64, True, True), (torch.bfloat16, False, False),
    (torch.float32, False, False), (torch.bfloat16, False, True)],
    ids=["float32-train", "float64-train", "bf16-eval", "float32-eval", "bf16-eval-graph"])
def test_other_dtypes_and_inference_keep_the_unfused_layer(monkeypatch, dtype, train, records):
    """Float32 and float64 in training, float32 in inference, and bf16
    inference under a graph (a frozen BatchNorm that gradients pass
    through): bn_relu equals relu(_bn(...)) bit for bit, outputs,
    gradients and running stats, and no pass is called. bf16 in
    inference, where autograd records nothing, calls normalize_relu once a
    layer and no other pass, on the running stats, which stay as they
    were: flax's form of the affine against ATen's, at most DIFFER of the
    outputs one ulp apart."""
    calls = _count_calls(monkeypatch)
    bn_cu.reset_launches()
    x, dy, weight, bias = _case(32, seed=7)
    fused = dtype == torch.bfloat16 and not records
    (y, *got), (want_y, *want) = _layers(x, dy, weight, bias, dtype, train, records)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if fused:
        assert torch.equal(got[0], RUNNING[0](bias)) and torch.equal(got[1], RUNNING[1](weight))
        assert y.dtype == torch.bfloat16
        _assert_one_ulp_apart(y, want_y, "y")
    else:
        assert torch.equal(y, want_y)
    pdtype = torch.float64 if dtype == torch.float64 else torch.float32
    block = ConvBlock(16, 32).to(pdtype)
    with torch.set_grad_enabled(records):
        block(x[:, :16].to(dtype), train)
    assert calls == ({"normalize_relu": 3} if fused else {})  # bn_relu, then the block's two
    assert all(v == 0 for v in bn_cu.launches().values())


def test_bf16_training_reaches_the_function_in_every_conv_block(monkeypatch):
    """A bf16 train-mode DetModel forward and backward calls each pass 18
    times (10 BatchNorms in the encoder, 8 in the decoder); its inference
    calls normalize_relu 18 times and no other pass."""
    cfg = Config(grid=GridConfig(voxel_size=(2.0, 2.0, 1.25)))
    model = DetModel(cfg, "disco", width_mult=0.25)
    rng = np.random.default_rng(3)
    h, w, d = cfg.grid.grid_shape
    occ = torch.from_numpy((rng.random((1, cfg.num_agents, h, w, d)) < 0.05).astype(np.float32))
    trans = torch.eye(4).expand(1, cfg.num_agents, cfg.num_agents, 4, 4).contiguous()
    mask = torch.ones(1, cfg.num_agents, dtype=torch.bool)
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        model(occ.to(torch.bfloat16), trans, mask)
    assert calls == {"normalize_relu": 18}
    calls.clear()
    out = model(occ.to(torch.bfloat16), trans, mask, train=True)
    assert calls == {"moments": 18, "normalize_relu": 18}
    out.cls_logits.float().sum().backward()
    assert calls == {name: 18 for name in ("moments", "normalize_relu", "backward_reduce",
                                           "backward_dx")}
    assert all(v == 0 for v in bn_cu.launches().values())  # the CPU runs the plain versions


def test_fused_layer_rejects_other_dtypes_and_devices():
    x, _, weight, bias = _case(32, seed=9)
    bn = _bn_module(weight, bias)
    with pytest.raises(TypeError):
        bn_cu.batch_norm_relu(x.float(), bn.weight, bn.bias, bn.running_mean, bn.running_var,
                              bn.eps, BN_MOMENTUM)
    with pytest.raises(ValueError):
        bn_cu.normalize_relu(x, torch.zeros(32, device="meta"), weight, bias)
