"""bf16 against the JAX package: the port's DetModel forward in bfloat16
held to JAX's ``DetModel(dtype=jnp.bfloat16)`` on the same weights and
inputs, on the CPU.

Neither bf16 run can equal float32, so each is held by its distance from
JAX's float32 forward on the same inputs. With ``d(u, v)`` the max and
the mean of ``|u - v|`` over the logits (cls) or box codes (reg):

  * rule 1: d(port bf16, JAX f32) <= 1.25 x d(JAX bf16, JAX f32), max and
    mean, against both the plain (``s2d=False``) and the default
    space-to-depth JAX execution;
  * rule 2: d(port bf16, JAX bf16) <= max(d(JAX bf16, JAX f32),
    d(JAX s2d bf16, JAX bf16)), max and mean, against the plain
    execution, the one the port implements.

Rule 2's second term is JAX against itself: its two bf16 executions round
in different orders, and at eval-mode scale they lie farther from each
other than from float32 (disco cls 0.0391 / 0.00426 apart against 0.0298
/ 0.00379 from float32). Single-ulp flips of the convs' accumulation
order (1e-4 of a conv's outputs, between any two libraries) grow through
the depth, so no bf16 implementation follows JAX's roundings element for
element. For the same reason rule 2 is not applied against the s2d
execution, whose convs accumulate in blocked order; rule 1 holds the
port there. Disco eval, plain: the port stands 0.0322 / 0.00368 from
JAX f32 and 0.0313 / 0.00338 from JAX bf16.

Measured at this file's 64x64x8 grid, full widths, one padded agent
(max / mean, cls; ``python -m pytest tests/test_torch_bf16.py -s`` prints
every case): disco train, JAX's own 0.3064 / 0.0272; the port 0.2885 /
0.0263 from JAX f32 (allowed 0.3831 / 0.0339) and 0.1758 / 0.0172 from
JAX bf16 (allowed 0.3906 / 0.0334). With the earlier bf16 BatchNorm of
``models/backbone.py::_bn`` (the folded affine in bf16) the port stood
0.4542 / 0.0341 from JAX f32 and 0.5312 / 0.0372 from JAX bf16:
``test_bf16_train_batchnorm_rounds_once`` and the disco train case fail
on it. Every forward case here passes without the two other bf16
roundings the port copies from JAX (a conv's bias added after the conv's
rounding, the upsample's rows rounded before its columns); the step
tests of tests/test_torch_bf16_step.py and tests/test_torch_bf16_seg.py
need both, and ``test_bf16_conv_bias_and_upsample_round_as_jax`` pins
them.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu_torch.bridge import state_dict_from_flax
from v2x_sim_tpu_torch.models.backbone import _bn, _conv, upsample_bilinear
from v2x_sim_tpu_torch.models.det.net import DetModel
from tests.test_torch_model import CFG, JCFG, MODE_KW, _flax_variables, _inputs
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

#: Rule 1's factor on JAX's own bf16 distance from float32.
FACTOR = 1.25
BF16_MODES = ("disco", "lowerbound", "upperbound", "v2v", "when2com")


def dist(u, v):
    """(max, mean) of |u - v| in float64."""
    d = np.abs(np.asarray(u, np.float64) - np.asarray(v, np.float64))
    return float(d.max()), float(d.mean())


def hold_bf16(name, port_bf, jax_f32, own, jax_bf=None, apart=(0.0, 0.0)):
    """Rule 1, and rule 2 when ``jax_bf`` is given, of the module
    docstring on one output: ``own`` is JAX's bf16 distance from float32,
    ``apart`` JAX's two bf16 executions' distance from each other (each a
    (max, mean) pair). Prints the measured and allowed numbers."""
    got1 = dist(port_bf, jax_f32)
    allowed1 = tuple(FACTOR * o for o in own)
    line = (f"{name}: JAX own {own[0]:.4g}/{own[1]:.4g}; port vs JAX f32 {got1[0]:.4g}/"
            f"{got1[1]:.4g} (allowed {allowed1[0]:.4g}/{allowed1[1]:.4g})")
    ok = got1[0] <= allowed1[0] and got1[1] <= allowed1[1]
    if jax_bf is not None:
        got2 = dist(port_bf, jax_bf)
        allowed2 = tuple(max(o, s) for o, s in zip(own, apart))
        line += (f"; port vs JAX bf16 {got2[0]:.4g}/{got2[1]:.4g} (allowed "
                 f"{allowed2[0]:.4g}/{allowed2[1]:.4g})")
        ok &= got2[0] <= allowed2[0] and got2[1] <= allowed2[1]
    print(line)
    assert ok, line


def _jax_forward(mode, variables, occ, trans, mask, dtype, s2d, train):
    model = JaxDetModel(config=JCFG, mode=mode, s2d=s2d, dtype=dtype, **MODE_KW.get(mode, {}))
    args = (jnp.asarray(occ, dtype or jnp.float32), jnp.asarray(trans), jnp.asarray(mask))
    if train:
        out, _ = model.apply(variables, *args, train=True, mutable=["batch_stats"])
    else:
        out = model.apply(variables, *args, train=False)
    return np.asarray(out.cls_logits, np.float32), np.asarray(out.reg, np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", BF16_MODES)
def test_bf16_forward_within_jax_bf16_error(mode, train):
    variables = _flax_variables(mode)
    occ, trans, mask = _inputs(seed=1)
    jax_out = {(dt, s2d): _jax_forward(mode, variables, occ, trans, mask, dt, s2d, train)
               for dt in (None, jnp.bfloat16) for s2d in (False, True)}
    model = DetModel(CFG, mode, **MODE_KW.get(mode, {}))
    model.load_state_dict(state_dict_from_flax(variables, mode), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(occ).to(torch.bfloat16), torch.from_numpy(trans),
                    torch.from_numpy(mask), train=train)
    assert out.cls_logits.dtype == torch.bfloat16  # the heads stay in bf16, as JAX's
    port = (out.cls_logits.float().numpy(), out.reg.float().numpy())
    for i, head in enumerate(("cls", "reg")):
        f32, bf, s2d_f32, s2d_bf = (jax_out[k][i] for k in (
            (None, False), (jnp.bfloat16, False), (None, True), (jnp.bfloat16, True)))
        hold_bf16(f"{mode} {head} plain", port[i], f32, dist(bf, f32), bf, dist(s2d_bf, bf))
        hold_bf16(f"{mode} {head} s2d", port[i], s2d_f32, dist(s2d_bf, s2d_f32))


@pytest.mark.parametrize("shape", [(4, 64, 16, 16), (6, 32, 32, 32)])
def test_bf16_train_batchnorm_rounds_once(shape):
    """F4: one train-mode BatchNorm in bf16 against flax's
    ``nn.BatchNorm(dtype=bfloat16)`` on the same map and affine. flax
    normalizes in float32 and rounds once; the port's earlier form, the
    folded affine in bf16, rounded inv, shift, the product and the sum,
    and disagreed with flax in ~40% of the outputs."""
    rng = np.random.default_rng(shape[1])
    n, c, h, w = shape
    x = (rng.normal(0.7, 1.3, (n, h, w, c))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.3, c).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.bfloat16)
    variables = flax_bn.init(jax.random.PRNGKey(0), xb)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    want, stats = flax_bn.apply(variables, xb, mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(c, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    with torch.no_grad():
        got = _bn(torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2),
                  bn, train=True)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want, np.float32)
    differ = got != want
    # Float32 rounding of the moments may tip a bf16 rounding, by one ulp
    # (or by float32's cancellation error where the output is near zero).
    assert differ.mean() <= 1e-3, differ.mean()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


def test_bf16_conv_bias_and_upsample_round_as_jax():
    """A biased conv in bf16 against flax's ``nn.Conv(dtype=bfloat16)``,
    which rounds the conv before adding the bias, and the decoder's
    bilinear upsample against ``jax.image.resize`` in bf16, which XLA
    contracts rows first, rounding between the two."""
    rng = np.random.default_rng(7)
    cin, cout = 32, 16
    x = rng.normal(0.2, 1.1, (2, 8, 8, cin)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    kernel = rng.normal(0.0, 0.1, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.normal(0.0, 0.5, cout).astype(np.float32)
    want = np.asarray(nn.Conv(cout, (3, 3), padding=1, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}, xb), np.float32)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = _conv(xt, conv).float().permute(0, 2, 3, 1).numpy()
    # The conv's own accumulation order may flip a rounding (one ulp).
    assert (got != want).mean() <= 2e-3, (got != want).mean()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -8)
    up = np.asarray(jax.image.resize(xb, (2, 16, 16, cin), "bilinear"), np.float32)
    got_up = upsample_bilinear(xt, (16, 16)).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_up, up)
