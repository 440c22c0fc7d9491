"""The port's DetModel against the JAX DetModel on the same weights and
inputs, and the weight bridge against the JAX package's converter.

Weights come from the JAX ``DetModel.init`` (kernels scaled to He
normal, BN stats and biases then drawn from a numpy seed, so every
parameter kind matters and the logits vary by ~0.2 across cells) and reach the
port through ``bridge.py``. Logits are compared at the 64x64x8 grid of
tests/test_reference_parity.py with its atol 2e-4, at full widths
(32..512) with one padded agent, against both the plain (s2d=False) and
the default space-to-depth JAX execution, for every collaboration mode
(v2v with its message GroupNorm on, so the bridge carries one), and for
the KD outputs: ``fused_feat`` and the teacher's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.baselines.torch_ref import key_map as jax_key_map
from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.models.det.net import TeacherModel as JaxTeacherModel
from v2x_sim_tpu.train.torch_convert import convert_state_dict
from v2x_sim_tpu_torch.bridge import key_map, random_flax_variables, state_dict_from_flax
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.models.det.net import MODES, DetModel, TeacherModel
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

VOXEL = (1.0, 1.0, 0.625)  # 64x64x8
CFG = Config(grid=GridConfig(voxel_size=VOXEL))
JCFG = JaxConfig(grid=JaxGrid(voxel_size=VOXEL))
ATOL = 2e-4
#: Per-mode fusion settings (the port's ``fusion``), the same in both
#: packages: JAX's DetModel takes them as ``v2v_<name>``.
FUSION = {"v2v": {"msg_norm": True}}


def _jax_kw(fusion):
    """JAX's DetModel options for the port's ``fusion`` settings."""
    return {f"v2v_{k}": v for k, v in (fusion or {}).items()}


def _inputs(seed=0, b=1):
    rng = np.random.default_rng(seed)
    a = CFG.num_agents
    h, w, d = CFG.grid.grid_shape
    occ = (rng.random((b, a, h, w, d)) < 0.02).astype(np.float32)
    trans = np.tile(np.eye(4, dtype=np.float32), (b, a, a, 1, 1))
    for i in range(a):
        for j in range(a):
            if i != j:
                yaw = rng.uniform(-0.8, 0.8)
                c, s = np.cos(yaw), np.sin(yaw)
                trans[:, i, j, :2, :2] = [[c, -s], [s, c]]
                trans[:, i, j, :2, 3] = rng.uniform(-6, 6, 2)
    mask = np.ones((b, a), bool)
    mask[:, -1] = False  # a padded agent
    return occ, trans, mask


def _perturb(variables, seed):
    """Init tree with random BN stats/affines and biases, and kernels scaled
    from LeCun to He normal so activations keep their scale through the
    depth (numpy leaves)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(variables)
    out = []
    for path, leaf in flat:
        name = path[-1].key
        x = np.asarray(leaf, np.float32)
        if name == "kernel":
            x = x * np.sqrt(2.0)
        elif name == "mean":
            x = rng.uniform(-0.3, 0.3, x.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, x.shape)
        elif name == "scale":
            x = rng.uniform(0.8, 1.2, x.shape)
        elif name == "bias":
            x = rng.normal(0.0, 0.1, x.shape)
        out.append(np.asarray(x, np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


@functools.lru_cache(maxsize=None)
def _init_variables(mode, seed, fusion_layer):
    occ, trans, mask = _inputs()
    init = JaxDetModel(config=JCFG, mode=mode, s2d=False, fusion_layer=fusion_layer,
                       **_jax_kw(FUSION.get(mode))).init(
        jax.random.PRNGKey(seed), jnp.asarray(occ), jnp.asarray(trans), jnp.asarray(mask),
        train=False)
    return _perturb({"params": init["params"], "batch_stats": init["batch_stats"]}, seed)


def _flax_variables(mode, seed=0, fusion_layer=None):
    """The perturbed JAX init of `mode` (one init per mode, seed and fusion
    layer; a fresh top-level dict, so a test may add leaves)."""
    v = _init_variables(mode, seed, fusion_layer)
    return {"params": dict(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.mark.parametrize("mode", MODES)
def test_bridge_round_trips_through_torch_convert(mode):
    variables = _flax_variables(mode)
    model = DetModel(CFG, mode, fusion=FUSION.get(mode))
    model.load_state_dict(state_dict_from_flax(variables, mode), strict=True)
    # The port's table extends the JAX package's (which names disco's fusion only).
    assert jax_key_map(mode).items() <= key_map(mode).items()
    back = convert_state_dict(model.state_dict(), key_map(mode))
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bridge_rejects_unconsumed_leaves_and_random_tree_loads():
    variables = _flax_variables("lowerbound")
    variables["params"]["extra"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(ValueError):
        state_dict_from_flax(variables, "lowerbound")
    model = DetModel(CFG, "disco")
    model.load_state_dict(
        state_dict_from_flax(random_flax_variables(model, seed=3), "disco"), strict=True)


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
@pytest.mark.parametrize("mode", MODES)
def test_eval_logits_match_jax(mode, s2d):
    variables = _flax_variables(mode)
    occ, trans, mask = _inputs(seed=1)
    want = JaxDetModel(config=JCFG, mode=mode, s2d=s2d, **_jax_kw(FUSION.get(mode))).apply(
        variables, jnp.asarray(occ), jnp.asarray(trans), jnp.asarray(mask), train=False)

    model = DetModel(CFG, mode, fusion=FUSION.get(mode)).eval()
    model.load_state_dict(state_dict_from_flax(variables, mode), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(occ), torch.from_numpy(trans), torch.from_numpy(mask))
    assert got.cls_logits.shape == (1, 6, 64, 64, 6, 2) and got.reg.shape == (1, 6, 64, 64, 6, 6)
    np.testing.assert_allclose(got.cls_logits.numpy(), np.asarray(want.cls_logits), atol=ATOL)
    np.testing.assert_allclose(got.reg.numpy(), np.asarray(want.reg), atol=ATOL)


@pytest.mark.parametrize(
    "mode,layer", [("disco", None), ("upperbound", None), ("disco", 2), ("upperbound", 2)],
    ids=["disco", "upperbound", "disco-layer2", "upperbound-layer2"])
def test_kd_fused_feat_and_teacher_match_jax(mode, layer):
    """kd=True's fused_feat (after fusion for disco; the encoder map for
    upperbound), and TeacherModel loading an upperbound tree: all its
    outputs, and kd_target, which stops the encoder at the fusion layer;
    at the config's fusion layer (3) and at layer 2."""
    variables = _flax_variables(mode, fusion_layer=layer)
    occ, trans, mask = _inputs(seed=2)
    want = JaxDetModel(config=JCFG, mode=mode, s2d=False, kd=True, fusion_layer=layer).apply(
        variables, jnp.asarray(occ), jnp.asarray(trans), jnp.asarray(mask), train=False)
    model = DetModel(CFG, mode, fusion_layer=layer, kd=True).eval()
    model.load_state_dict(state_dict_from_flax(variables, mode), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(occ), torch.from_numpy(trans), torch.from_numpy(mask))
    assert got.fused_feat.shape == ((1, 6, 8, 8, 256) if layer is None else (1, 6, 16, 16, 128))
    np.testing.assert_allclose(got.fused_feat.numpy(), np.asarray(want.fused_feat), atol=ATOL)
    np.testing.assert_allclose(got.cls_logits.numpy(), np.asarray(want.cls_logits), atol=ATOL)
    if mode != "upperbound":
        return
    t_want = JaxTeacherModel(config=JCFG, fusion_layer=layer).apply(
        variables, jnp.asarray(occ), train=False)
    teacher = TeacherModel(CFG, fusion_layer=layer).eval()
    teacher.load_state_dict(state_dict_from_flax(variables, "upperbound"), strict=True)
    with torch.no_grad():
        t_got = teacher(torch.from_numpy(occ))
        target = teacher.kd_target(torch.from_numpy(occ))
    for g, w in zip(t_got, t_want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    np.testing.assert_array_equal(target.numpy(), t_got.fused_feat.numpy())
