"""The port's SegModel against the JAX SegModel on the same weights and
inputs, and the weight bridge's seg tree.

At the 64x64x8 grid with a translated and rotated ``trans`` and one
padded agent, weights from ``bridge.random_flax_variables`` (He-normal
kernels, random biases, BN affines and running stats) loaded by both
packages. Eval logits at atol 1e-4 in fp32:
  * every mode at depth 2, width_mult 0.25 (bottleneck 16x16, 32
    channels: the fusion's warp, masks and attention all act) against the
    plain (``s2d=False``) JAX execution;
  * lowerbound and disco at depth 4 (bottleneck 4x4) against the default
    space-to-depth execution, whose param tree is the plain one's.
The bridge: the port's tree has the JAX init's paths and shapes, and
flax -> port -> flax gives it back leaf for leaf, in every mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.models.seg.unet import SegModel as JaxSegModel
from v2x_sim_tpu_torch.bridge import (
    flax_from_state_dict,
    random_flax_variables,
    seg_key_map,
    state_dict_from_flax,
)
from v2x_sim_tpu_torch.models.det.net import MODES
from v2x_sim_tpu_torch.models.seg.unet import SegModel
from tests.test_torch_model import CFG, JCFG, _inputs
from tests.test_torch_train import _leaves
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

ATOL = 1e-4
WIDTH = 0.25


def _logits(mode, depth, s2d, seed):
    model = SegModel(CFG, mode, WIDTH, depth).eval()
    variables = random_flax_variables(model, seed=seed)
    model.load_state_dict(state_dict_from_flax(variables, seg_key_map(mode, depth)), strict=True)
    occ, trans, mask = _inputs(seed=seed)
    want = JaxSegModel(config=JCFG, mode=mode, s2d=s2d, width_mult=WIDTH, depth=depth).apply(
        variables, jnp.asarray(occ), jnp.asarray(trans), jnp.asarray(mask), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(occ), torch.from_numpy(trans), torch.from_numpy(mask))
    return got.logits.numpy(), np.asarray(want.logits)


@pytest.mark.parametrize(
    "mode,depth,s2d",
    [(m, 2, False) for m in MODES] + [("lowerbound", 4, True), ("disco", 4, True)],
    ids=[f"{m}-plain" for m in MODES] + ["lowerbound-s2d-depth4", "disco-s2d-depth4"])
def test_eval_logits_match_jax(mode, depth, s2d):
    got, want = _logits(mode, depth, s2d, seed=MODES.index(mode))
    assert got.shape == (1, 6, 64, 64, CFG.num_seg_classes) and got.dtype == np.float32
    assert want.std() > 0.1  # the logits vary across the map
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_bridge_seg_tree_round_trips(mode):
    model = SegModel(CFG, mode, WIDTH, depth=2)
    variables = random_flax_variables(model, seed=7)
    occ, trans, mask = _inputs()
    jmodel = JaxSegModel(config=JCFG, mode=mode, s2d=False, width_mult=WIDTH, depth=2)
    shapes = jax.eval_shape(lambda o, t, m: jmodel.init(jax.random.PRNGKey(0), o, t, m, train=False),
                            jnp.asarray(occ), jnp.asarray(trans), jnp.asarray(mask))
    want = {jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_flatten_with_path(
                {c: shapes[c] for c in ("params", "batch_stats")})[0]}
    assert {k: v.shape for k, v in _leaves(variables).items()} == want
    kmap = seg_key_map(mode, 2)
    back = _leaves(flax_from_state_dict(state_dict_from_flax(variables, kmap), kmap))
    assert sorted(back) == sorted(want)
    for k, v in _leaves(variables).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_unknown_mode_and_depth_raise():
    with pytest.raises(ValueError, match="unknown mode"):
        SegModel(CFG, "disco_x")
    with pytest.raises(ValueError, match="depth"):
        SegModel(CFG, "lowerbound", depth=5)
