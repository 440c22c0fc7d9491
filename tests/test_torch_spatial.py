"""Row sharding of the port (``parallel/spatial.py``) on 2 and 4 gloo ranks
of the CPU (tests/torch_dist.py), against the unsharded versions.

  * the halo exchange: each shard padded with its neighbours' edge rows,
    zeros at the global edges;
  * ``conv3x3_halo`` and ``conv3x3s2_halo`` against the unsharded pad-1
    conv (float64, to 1e-12), and the gradients through the exchange, of
    the input and of the kernel summed over the ranks, against unsharded
    autograd (to 1e-12);
  * the stem and the 5-stage encoder in inference BatchNorm, from the
    port's ConvBlocks, against JAX's unsharded ``STPNEncoder`` on the same
    (bridged) weights with perturbed running stats, at
    tests/test_spatial.py's float32 tolerances (H = 64 keeps every stage's
    rows a shard even on 4 ranks);
  * one SGD step (lr 0.1) of the stem, BatchNorm's moments averaged over
    the ranks, against JAX's unsharded flax ``ConvBlock`` train step as
    tests/test_spatial.py takes it: loss, new parameters and running
    stats; every rank ends with the same block.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from v2x_sim_tpu.models.backbone import ConvBlock as JaxConvBlock
from v2x_sim_tpu.models.backbone import STPNEncoder as JaxSTPNEncoder
from v2x_sim_tpu_torch.bridge import flax_from_state_dict, state_dict_from_flax
from tests import torch_dist
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

CHANNELS = (8, 12, 16, 20, 24)
LR = 0.1
PARTS = (("conv1", "Conv_0"), ("bn1", "BatchNorm_0"), ("conv2", "Conv_1"), ("bn2", "BatchNorm_1"))
BLOCK_MAP = {tk: (fk,) for tk, fk in PARTS}
ENCODER_MAP = {f"blocks.{i}.{tk}": (f"ConvBlock_{i}", fk)
               for i in range(len(CHANNELS)) for tk, fk in PARTS}


def _nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def _perturbed(variables, scale):
    """Running stats (and BN affines) moved off their init values."""
    return jax.tree.map(lambda v: v + scale * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape)
                        / v.size if v.ndim == 1 else v, variables)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 64, 64, 13))
    enc = JaxSTPNEncoder(s2d=False, stage_channels=CHANNELS)
    enc_vars = _perturbed(enc.init(jax.random.PRNGKey(6), x, train=False), 0.05)
    feats = enc.apply(enc_vars, x, train=False)
    stem_ref = JaxConvBlock(CHANNELS[0], stride=1, mode="plain").apply(
        {"params": enc_vars["params"]["ConvBlock_0"],
         "batch_stats": enc_vars["batch_stats"]["ConvBlock_0"]}, x, train=False)

    sx = jax.random.normal(jax.random.PRNGKey(20), (2, 32, 16, 13))
    target = jax.random.normal(jax.random.PRNGKey(21), (2, 32, 16, 16))
    block = JaxConvBlock(16, stride=1, mode="plain")
    block_vars = block.init(jax.random.PRNGKey(22), sx, train=False)
    params, stats = block_vars["params"], block_vars["batch_stats"]

    def flax_loss(p):
        y, mut = block.apply({"params": p, "batch_stats": stats}, sx, train=True,
                             mutable=["batch_stats"])
        return jnp.mean((y - target) ** 2), mut["batch_stats"]

    (loss, new_stats), grads = jax.value_and_grad(flax_loss, has_aux=True)(params)
    new_params = jax.tree.map(lambda p, g: p - LR * g, params, grads)
    return {
        "x": rng.normal(size=(2, 8, 32, 16)),
        "w": rng.normal(size=(16, 8, 3, 3)) * 0.1,
        "cot": rng.normal(size=(2, 16, 32, 16)),
        "enc_x": _nchw(x), "enc_channels": CHANNELS,
        "enc_state": state_dict_from_flax(enc_vars, ENCODER_MAP),
        "stem_x": _nchw(sx), "stem_target": _nchw(target), "lr": LR,
        "stem_state": state_dict_from_flax(block_vars, BLOCK_MAP),
        "want": {"encoder": [_nchw(f) for f in feats], "stem": _nchw(stem_ref),
                 "loss": float(loss),
                 "block": jax.tree.map(np.asarray, {"params": new_params,
                                                    "batch_stats": new_stats})},
    }


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, inputs, tmp_path_factory):
    """Each rank's outputs of tests/torch_dist.py's spatial_checks."""
    rank_inputs = {k: v for k, v in inputs.items() if k != "want"}
    return torch_dist.run(torch_dist.spatial_checks, request.param,
                          tmp_path_factory.mktemp(f"spatial{request.param}"), rank_inputs)


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=2)


def test_halo_rows_come_from_the_neighbours(ranks, inputs):
    x, n = inputs["x"], len(ranks)
    h = x.shape[2] // n
    for i, r in enumerate(ranks):
        got = r["halo"]
        assert got.shape == (2, 8, h + 2, 16)
        np.testing.assert_array_equal(got[:, :, 1:-1], x[:, :, i * h:(i + 1) * h])
        above = x[:, :, i * h - 1] if i > 0 else np.zeros_like(x[:, :, 0])
        below = x[:, :, (i + 1) * h] if i < n - 1 else np.zeros_like(x[:, :, 0])
        np.testing.assert_array_equal(got[:, :, 0], above)
        np.testing.assert_array_equal(got[:, :, -1], below)


@pytest.mark.parametrize("stride", [1, 2])
def test_halo_conv_equals_the_unsharded_conv(ranks, inputs, stride):
    x, w = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["w"])
    want = F.conv2d(x, w, stride=stride, padding=1).numpy()
    got = _rows(ranks, "conv" if stride == 1 else "conv_s2")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_gradient_through_the_exchange(ranks, inputs):
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    w = torch.from_numpy(inputs["w"]).requires_grad_(True)
    (F.conv2d(x, w, padding=1) * torch.from_numpy(inputs["cot"])).sum().backward()
    np.testing.assert_allclose(_rows(ranks, "grad_x"), x.grad.numpy(), rtol=0, atol=1e-12)
    for r in ranks:
        np.testing.assert_allclose(r["grad_w"], w.grad.numpy(), rtol=0, atol=1e-12)


def test_stem_and_encoder_match_jax(ranks, inputs):
    want = inputs["want"]
    np.testing.assert_allclose(_rows(ranks, "stem"), want["stem"], atol=2e-5, rtol=1e-5)
    assert len(ranks[0]["encoder"]) == len(CHANNELS)
    for lvl, ref in enumerate(want["encoder"]):
        got = np.concatenate([r["encoder"][lvl] for r in ranks], axis=2)
        assert got.shape == ref.shape, (lvl, got.shape, ref.shape)
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4, err_msg=f"level {lvl}")


def test_stem_train_step_matches_flax(ranks, inputs):
    want = inputs["want"]
    for r in ranks[1:]:
        assert r["train_loss"] == ranks[0]["train_loss"]
        for k, v in ranks[0]["train_state"].items():
            np.testing.assert_array_equal(r["train_state"][k], v, err_msg=k)
    np.testing.assert_allclose(ranks[0]["train_loss"], want["loss"], rtol=1e-5)
    got = flax_from_state_dict({k: torch.from_numpy(v) for k, v in
                                ranks[0]["train_state"].items()}, BLOCK_MAP)
    for coll in ("params", "batch_stats"):
        got_leaves = jax.tree_util.tree_flatten_with_path(got[coll])[0]
        want_leaves = jax.tree_util.tree_flatten_with_path(want["block"][coll])[0]
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-4, err_msg=f"{coll} {path}")
