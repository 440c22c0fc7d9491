"""The port's fusion modules and ConvRNN cells against the JAX ones, on the
same numpy inputs and the same flax parameters.

B=2 scenes, A=6 agents with one padded agent in scene 1, 16x16 maps of
C=32 channels, random rigid transforms between agents. Flax initializes
each module; its biases and norm affines are then redrawn from a numpy
seed so every parameter matters, and the tree reaches the port by the
bridge's layout rules (``_to_port``). Every fusion runs in train and eval
semantics (only When2com/Who2com tell them apart). float32 throughout,
atol 2e-5 on maps of unit scale, except where a test says otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.models import convrnn as jrnn
from v2x_sim_tpu.models.det import fusion as jfusion
from v2x_sim_tpu.models.det.v2vnet import V2VNetFusion as JaxV2V
from v2x_sim_tpu.models.det.when2com import QueryKeyNet as JaxQueryKeyNet
from v2x_sim_tpu.models.det.when2com import When2comFusion as JaxWhen2com
from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.models import convrnn
from v2x_sim_tpu_torch.models.det import fusion
from v2x_sim_tpu_torch.models.det.v2vnet import V2VNetFusion
from v2x_sim_tpu_torch.models.det.when2com import When2comFusion
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

GRID, JGRID = GridConfig(), JaxGrid()  # +-32 m: 4 m cells on a 16x16 map
B, A, H, W, C = 2, 6, 16, 16, 32
ATOL = 2e-5


def _inputs(seed=0, relu=False):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, A, H, W, C)).astype(np.float32)
    if relu:
        feats = np.maximum(feats, 0.0)
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    for b in range(B):
        for i in range(A):
            for j in range(A):
                if i != j:
                    yaw = rng.uniform(-0.6, 0.6)
                    c, s = np.cos(yaw), np.sin(yaw)
                    trans[b, i, j, :2, :2] = [[c, -s], [s, c]]
                    trans[b, i, j, :2, 3] = rng.uniform(-12, 12, 2)
    mask = np.ones((B, A), bool)
    mask[1, -1] = False
    return feats, trans, mask


def _perturb(params, seed=0):
    """Biases N(0, 0.1) and norm scales U(0.8, 1.2) from a numpy seed."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "bias":
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _to_port(module, params):
    """Load a flax params tree into a port module whose submodule names
    mirror the flax names: conv kernels (k..., in, out) -> (out, in, k...),
    Dense kernels transposed, norm scales -> weight."""
    sd = {}
    for key in module.state_dict():
        *path, leaf = key.split(".")
        node = params
        for k in path:
            node = node[k]
        if leaf == "bias":
            arr = np.asarray(node["bias"])
        elif "scale" in node:
            arr = np.asarray(node["scale"])
        else:
            arr = np.asarray(node["kernel"])
            arr = arr.T if arr.ndim == 2 else np.moveaxis(arr, (-1, -2), (0, 1))
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    module.load_state_dict(sd, strict=True)
    return module


def _jax_module(mod, feats, trans, mask, train, seed=0):
    args = (jnp.asarray(feats), jnp.asarray(trans), jnp.asarray(mask))
    params = _perturb(mod.init(jax.random.PRNGKey(seed), *args, train=train)["params"], seed)
    return params, np.asarray(mod.apply({"params": params}, *args, train=train))


def _port(module, params, feats, trans, mask, train):
    module = _to_port(module, params)
    with torch.no_grad():
        return module(torch.from_numpy(feats), torch.from_numpy(trans), torch.from_numpy(mask),
                      train).numpy()


FNS = {"sum": (jfusion.fuse_sum, fusion.fuse_sum), "mean": (jfusion.fuse_mean, fusion.fuse_mean),
       "max": (jfusion.fuse_max, fusion.fuse_max)}

MODULES = {
    "cat": (lambda: jfusion.CatFusion(JGRID), lambda: fusion.CatFusion(GRID, C, A)),
    "agent": (lambda: jfusion.AgentWiseWeightedFusion(JGRID),
              lambda: fusion.AgentWiseWeightedFusion(GRID, C)),
    "disco": (lambda: jfusion.DiscoFusion(JGRID), lambda: fusion.DiscoFusion(GRID, C)),
    "when2com": (lambda: JaxWhen2com(JGRID), lambda: When2comFusion(GRID, C)),
    "who2com": (lambda: JaxWhen2com(JGRID, argmax_mode=True),
                lambda: When2comFusion(GRID, C, argmax_mode=True)),
    "when2com_no_threshold": (lambda: JaxWhen2com(JGRID, threshold=False),
                              lambda: When2comFusion(GRID, C, threshold=False)),
    "v2v": (lambda: JaxV2V(JGRID), lambda: V2VNetFusion(GRID, C)),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("mode", list(FNS) + list(MODULES))
def test_fusion_matches_jax(mode, train):
    feats, trans, mask = _inputs(seed=1)
    if mode in FNS:
        jfn, fn = FNS[mode]
        want = np.asarray(jfn(jnp.asarray(feats), jnp.asarray(trans), jnp.asarray(mask), JGRID))
        got = fn(torch.from_numpy(feats), torch.from_numpy(trans), torch.from_numpy(mask),
                 GRID).numpy()
    else:
        jmod, mod = MODULES[mode]
        params, want = _jax_module(jmod(), feats, trans, mask, train)
        got = _port(mod(), params, feats, trans, mask, train)
    assert got.shape == (B, A, H, W, C)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("msg_norm", [False, True], ids=["plain", "msg_norm"])
@pytest.mark.parametrize("rounds", [1, 3])
def test_v2v_rounds_and_msg_norm_match_jax(rounds, msg_norm):
    feats, trans, mask = _inputs(seed=2)
    params, want = _jax_module(JaxV2V(JGRID, rounds=rounds, msg_norm=msg_norm),
                               feats, trans, mask, train=True)
    assert ("msg_norm" in params) == msg_norm
    got = _port(V2VNetFusion(GRID, C, rounds=rounds, msg_norm=msg_norm), params,
                feats, trans, mask, train=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("argmax", [False, True], ids=["when2com", "who2com"])
def test_when2com_without_warp_matches_jax(argmax, train):
    feats, trans, mask = _inputs(seed=3)
    params, want = _jax_module(JaxWhen2com(JGRID, argmax_mode=argmax, warp_flag=False),
                               feats, trans, mask, train)
    got = _port(When2comFusion(GRID, C, argmax_mode=argmax, warp_flag=False), params,
                feats, trans, mask, train)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_when2com_eval_keep_mask_matches_jax():
    """The eval threshold attn >= 1/n flips on ties; these inputs keep every
    soft weight of a real source at least 1e-3 away from 1/n, and the
    pruned weights (hence the keep mask) and the fused map agree with
    JAX's, the weights recomputed from its query/key net."""
    feats, trans, mask = _inputs(seed=4)
    params, _ = _jax_module(JaxWhen2com(JGRID), feats, trans, mask, train=False)
    # At init the scores are ~1e-3 and every weight sits near 1/n: spread them.
    params["attn_w"]["kernel"] = params["attn_w"]["kernel"] * 200.0
    q, k = JaxQueryKeyNet().apply({"params": params["query_key_net"]},
                                  jnp.asarray(feats.reshape(B * A, H, W, C)), False)
    q, k = np.asarray(q).reshape(B, A, -1), np.asarray(k).reshape(B, A, -1)
    scores = np.einsum("biq,bjq->bij", q, k @ np.asarray(params["attn_w"]["kernel"])) / np.sqrt(32)
    scores = np.where(mask[:, None, :], scores, -1e9)
    soft = np.exp(scores - scores.max(-1, keepdims=True))
    soft /= soft.sum(-1, keepdims=True)
    uniform = 1.0 / mask.sum(1)[:, None, None]
    assert np.abs(soft - uniform)[np.broadcast_to(mask[:, None, :], soft.shape)].min() > 1e-3
    want_keep = (soft >= uniform) | np.eye(A, dtype=bool)

    port = _to_port(When2comFusion(GRID, C), params)
    with torch.no_grad():
        got_soft = port.attention(torch.from_numpy(feats), torch.from_numpy(mask), train=True)
        got = port.attention(torch.from_numpy(feats), torch.from_numpy(mask), train=False)
    # Scores of ~5 in float32 through two packages: weights agree to 1e-5.
    np.testing.assert_allclose(got_soft.numpy(), soft, atol=1e-5)
    # Kept links of real sources (a padded source's self link weighs 0).
    np.testing.assert_array_equal(got.numpy() > 0, want_keep & mask[:, None, :])
    assert 0 < (got.numpy() == 0).sum() < got.numel()
    want = np.where(want_keep, soft, 0.0)
    np.testing.assert_allclose(got.numpy(), want / want.sum(-1, keepdims=True), atol=1e-5)
    jmod = JaxWhen2com(JGRID)
    fused = jmod.apply({"params": params}, jnp.asarray(feats), jnp.asarray(trans),
                       jnp.asarray(mask), train=False)
    np.testing.assert_allclose(_port(port, params, feats, trans, mask, False), np.asarray(fused),
                               atol=ATOL, rtol=0)


def test_who2com_single_real_agent_keeps_full_self_weight():
    """As tests/test_when2com_modes.py: an ego with no real partner keeps its
    own map whole at inference (identity transforms), in both packages."""
    feats, trans, _ = _inputs(seed=5)
    trans = np.tile(np.eye(4, dtype=np.float32), (B, A, A, 1, 1))
    mask = np.zeros((B, A), bool)
    mask[:, 0] = True
    params, want = _jax_module(JaxWhen2com(JGRID, argmax_mode=True), feats, trans, mask,
                               train=False)
    got = _port(When2comFusion(GRID, C, argmax_mode=True), params, feats, trans, mask,
                train=False)
    np.testing.assert_allclose(got[:, 0], feats[:, 0], atol=1e-6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fuse_max_float64_gradients_split_ties_as_jax():
    """ReLU'd maps warped by whole-cell shifts: the samples are exact, so
    many sources tie at 0 (and padding). JAX's max VJP splits the gradient
    evenly among tied maxima; so must the port (amax, not max(dim))."""
    feats, _, mask = _inputs(seed=6, relu=True)
    feats = feats.astype(np.float64)
    rng = np.random.default_rng(6)
    trans = np.tile(np.eye(4), (B, A, A, 1, 1))
    trans[..., :2, 3] = 4.0 * rng.integers(-3, 4, (B, A, A, 2))  # whole 4 m cells
    trans[:, np.arange(A), np.arange(A), :2, 3] = 0.0
    up = rng.standard_normal((B, A, H, W, C))
    with jax.enable_x64(True):
        def loss(f):
            out = jfusion.fuse_max(f, jnp.asarray(trans), jnp.asarray(mask), JGRID)
            return jnp.sum(out * up)
        want = np.asarray(jax.grad(loss)(jnp.asarray(feats)))
    x = torch.from_numpy(feats).requires_grad_(True)
    (fusion.fuse_max(x, torch.from_numpy(trans), torch.from_numpy(mask), GRID)
     * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-12, rtol=0)
    with torch.no_grad():
        warped = fusion.warp_all_pairs(torch.from_numpy(feats), torch.from_numpy(trans), GRID)
        warped = torch.where(torch.from_numpy(mask)[:, None, :, None, None, None], warped, -1e9)
        ties = (warped == warped.amax(dim=2, keepdim=True)).sum(dim=2)
    assert (ties > 1).float().mean() > 0.03  # the case under test occurs often


def _cell_io(seed, spatial=(6, 5), cin=3, feat=7, batch=2):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((batch,) + spatial + (feat,)).astype(np.float32)
    x = rng.standard_normal((batch,) + spatial + (cin,)).astype(np.float32)
    return h, x


@pytest.mark.parametrize("cell", ["gru", "rnn", "lstm"])
def test_conv_rnn_cells_match_jax(cell):
    """One step of each cell (the GRU is V2VNet's; z is the first half of
    the gate conv, the candidate reads [r*h, x])."""
    h, x = _cell_io(7)
    jcell = {"gru": jrnn.ConvGRUCell(features=7), "rnn": jrnn.ConvRNNCell(features=7, nonlinearity="relu"),
             "lstm": jrnn.ConvLSTMCell(features=7)}[cell]
    port = {"gru": convrnn.ConvGRUCell(7, 3), "rnn": convrnn.ConvRNNCell(7, 3, nonlinearity="relu"),
            "lstm": convrnn.ConvLSTMCell(7, 3)}[cell]
    state = (jnp.asarray(h), jnp.asarray(h) * 0.5) if cell == "lstm" else jnp.asarray(h)
    params = _perturb(jcell.init(jax.random.PRNGKey(0), state, jnp.asarray(x))["params"])
    want = jcell.apply({"params": params}, state, jnp.asarray(x))
    tstate = tuple(torch.from_numpy(np.asarray(s)) for s in state) if cell == "lstm" else torch.from_numpy(h)
    with torch.no_grad():
        got = _to_port(port, params)(tstate, torch.from_numpy(x))
    for g, w in zip(got if cell == "lstm" else [got], want if cell == "lstm" else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("cell,ndim,kernel", [("gru", 2, 3), ("lstm", 1, 4), ("rnn", 3, 3)])
def test_conv_rnn_sequence_matches_jax(cell, ndim, kernel):
    """The sequence wrapper, two layers, bidirectional: outputs and every
    final state. The 1-d case has an even kernel (flax SAME pads one more
    after than before)."""
    rng = np.random.default_rng(8)
    spatial = (5, 4, 3)[:ndim]
    x = rng.standard_normal((2, 4) + spatial + (3,)).astype(np.float32)
    jmod = jrnn.ConvRNN(features=5, cell=cell, ndim=ndim, kernel=kernel, num_layers=2,
                        bidirectional=True)
    params = _perturb(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want_seq, want_states = jmod.apply({"params": params}, jnp.asarray(x))
    port = _to_port(convrnn.ConvRNN(5, 3, cell=cell, ndim=ndim, kernel=kernel, num_layers=2,
                                    bidirectional=True), {"cells": params})
    with torch.no_grad():
        got_seq, got_states = port(torch.from_numpy(x))
    assert got_seq.shape == (2, 4) + spatial + (10,)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), atol=1e-5, rtol=0)
    got_leaves, want_leaves = jax.tree_util.tree_leaves(got_states), jax.tree_util.tree_leaves(want_states)
    assert len(got_leaves) == len(want_leaves) == 4 * (2 if cell == "lstm" else 1)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
