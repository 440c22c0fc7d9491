"""Whole-model row sharding and channel parallelism of the port
(``parallel/spatial.py``, ``DetModel``/``SegModel(spatial_group=)``) on
2 and 4 gloo ranks of the CPU (tests/torch_dist.py), against JAX's
unsharded models and the port's own.

  * ``conv3x3_channel_parallel``, C_in split over the ranks, against
    JAX's unsharded conv at tests/test_spatial.py's shapes ((2, 16, 16,
    64) x (3, 3, 64, 32)), atol/rtol 1e-5; its float64 gradients of the
    input and of the kernel (every rank taking the replicated output's
    loss over n) against unsharded autograd, to 1e-12;
  * ``upsample_bilinear_halo`` against the unsharded upsample of the port
    (``interpolate``), float64 to 1e-12 and bf16 (rows then columns)
    exactly, the global edge rows included;
  * ``DetModel`` disco and ``SegModel`` mean, row-sharded, against JAX's
    unsharded models on the same weights, as tests/test_spatial.py sets
    them up: 64x64x8 (voxel (1.0, 1.0, 0.625)), 2 agents, fusion_layer 2,
    width_mult 0.25, s2d=False, synthetic seeds 7 and 9; atol 2e-4, rtol
    1e-4. The weights are ``bridge.random_flax_variables`` (He-normal
    kernels, random running stats and biases) in place of JAX's init,
    whose compile alone would take most of this file's time;
  * at 2 ranks, one model of every other fusion family (sum, mean, max,
    cat, agent, when2com, v2v with its message GroupNorm) in float64,
    eval and (disco) train-mode BatchNorm, against the port's unsharded
    model on random weights, to 1e-10 of the output's max; and the disco
    model in bf16, held to JAX's bf16 by tests/test_torch_bf16.py's two
    rules (against JAX's plain and s2d bf16 executions), and by its first
    rule with the port's unsharded bf16 in place of JAX's float32.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.datasets.synthetic import SyntheticSpec as JaxSpec
from v2x_sim_tpu.datasets.synthetic import generate_batch as jax_generate_batch
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.models.seg.unet import SegModel as JaxSegModel
from v2x_sim_tpu.ops.voxelize import voxelize_batch as jax_voxelize
from v2x_sim_tpu_torch.bridge import random_flax_variables, seg_key_map, state_dict_from_flax
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.models.backbone import upsample_bilinear
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.models.seg.unet import SegModel
from tests import torch_dist
from tests.test_torch_bf16 import dist, hold_bf16
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

VOXEL = (1.0, 1.0, 0.625)  # 64x64x8
CFG = Config(grid=GridConfig(voxel_size=VOXEL), num_agents=2, fusion_layer=2)
JCFG = JaxConfig(grid=JaxGrid(voxel_size=VOXEL), num_agents=2, fusion_layer=2)
SPEC = JaxSpec(num_vehicles=4, points_per_agent=512, max_gt=8, points_per_vehicle=32)
WIDTH = 0.25
SEG_DEPTH = 4  # JAX's default: a 4x4 bottleneck at 64 rows, 1 row a shard on 4 ranks
#: The other fusion families, held at 2 ranks in float64 against the port.
FAMILIES = ("sum", "mean", "max", "cat", "agent", "when2com", "v2v")
MODE_KW = {"v2v": {"fusion": {"msg_norm": True}}}


def _scene(seed):
    raw = jax_generate_batch(JCFG, SPEC, batch_size=1, seed=seed)
    occ = jax_voxelize(jnp.asarray(raw["points"]), jnp.asarray(raw["point_mask"]), JCFG.grid)
    return np.array(occ, np.float32), raw["trans"].astype(np.float32), raw["agent_mask"]


def _jax_det(variables, occ, trans, mask, dtype=None, s2d=False):
    model = JaxDetModel(config=JCFG, mode="disco", s2d=s2d, width_mult=WIDTH, dtype=dtype)
    out = jax.jit(lambda v, o, t, m: model.apply(v, o, t, m, train=False))(
        variables, jnp.asarray(occ, dtype or jnp.float32), jnp.asarray(trans), jnp.asarray(mask))
    return [np.asarray(t, np.float32) for t in (out.cls_logits, out.reg)]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    out = {"models": {}}
    # Channel parallelism: tests/test_spatial.py's shapes and JAX's conv.
    x = jax.random.normal(jax.random.PRNGKey(11), (2, 16, 16, 64))
    k = jax.random.normal(jax.random.PRNGKey(12), (3, 3, 64, 32)) * 0.05
    ref = jax.lax.conv_general_dilated(x, k, (1, 1), ((1, 1), (1, 1)),
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    out["cp_x"] = np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))
    out["cp_w"] = np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))
    out["cp_cot"] = rng.normal(size=(2, 32, 16, 16))
    out["up"] = rng.normal(size=(2, 3, 16, 12))

    occ, trans, mask = _scene(7)
    variables = random_flax_variables(DetModel(CFG, "disco", WIDTH, fusion_layer=2), seed=7)
    det = {"kind": "det", "cfg": CFG, "mode": "disco", "width": WIDTH, "layer": 2,
           "state": state_dict_from_flax(variables, "disco"), "occ": occ, "trans": trans,
           "mask": mask, "dtype": torch.float32}
    out["models"]["det"] = det
    out["models"]["det_bf16"] = dict(det, dtype=torch.bfloat16, world=2)

    s_occ, s_trans, s_mask = _scene(9)
    seg = JaxSegModel(config=JCFG, mode="mean", s2d=False, width_mult=WIDTH)
    seg_vars = random_flax_variables(SegModel(CFG, "mean", WIDTH, SEG_DEPTH), seed=9)
    out["models"]["seg"] = {"kind": "seg", "cfg": CFG, "mode": "mean", "width": WIDTH,
                            "depth": SEG_DEPTH,
                            "state": state_dict_from_flax(seg_vars, seg_key_map("mean", SEG_DEPTH)),
                            "occ": s_occ, "trans": s_trans, "mask": s_mask,
                            "dtype": torch.float32}

    for i, mode in enumerate(FAMILIES + ("disco",)):
        model = DetModel(CFG, mode, WIDTH, **MODE_KW.get(mode, {}))
        state = state_dict_from_flax(random_flax_variables(model, seed=60 + i), mode)
        out["models"][f"f64_{mode}"] = {
            "kind": "det", "cfg": CFG, "mode": mode, "width": WIDTH, "layer": 2,
            "kw": MODE_KW.get(mode, {}), "state": state, "occ": occ, "trans": trans,
            "mask": mask, "dtype": torch.float64, "world": 2, "train": mode == "disco"}

    want = {"cp": np.asarray(ref).transpose(0, 3, 1, 2),
            "det": _jax_det(variables, occ, trans, mask),
            "det_bf16": _jax_det(variables, occ, trans, mask, jnp.bfloat16),
            "det_bf16_s2d": _jax_det(variables, occ, trans, mask, jnp.bfloat16, s2d=True)}
    seg_out = jax.jit(lambda v, o, t, m: seg.apply(v, o, t, m, train=False))(
        seg_vars, jnp.asarray(s_occ), jnp.asarray(s_trans), jnp.asarray(s_mask))
    want["seg"] = [np.asarray(seg_out.logits)]
    out["want"] = want
    return out


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """world -> each rank's outputs of tests/torch_dist.py's
    spatial_model_checks, on 2 and on 4 ranks."""
    rank_inputs = {k: v for k, v in inputs.items() if k != "want"}
    return {n: torch_dist.run(torch_dist.spatial_model_checks, n,
                              tmp_path_factory.mktemp(f"spatial_model{n}"), rank_inputs)
            for n in (2, 4)}


def _rows(ranks, key, i=None):
    return np.concatenate([r[key] if i is None else r[key][i] for r in ranks], axis=2)


@pytest.mark.parametrize("world", [2, 4])
def test_channel_parallel_conv_matches_jax(worlds, inputs, world):
    for r in worlds[world]:  # every rank holds the whole output
        np.testing.assert_allclose(r["cp"], inputs["want"]["cp"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_channel_parallel_conv_gradients(worlds, inputs, world):
    ranks = worlds[world]
    x = torch.from_numpy(inputs["cp_x"]).double().requires_grad_(True)
    w = torch.from_numpy(inputs["cp_w"]).double().requires_grad_(True)
    (F.conv2d(x, w, padding=1) * torch.from_numpy(inputs["cp_cot"])).sum().backward()
    got_x = np.concatenate([r["cp_grad_x"] for r in ranks], axis=1)
    got_w = np.concatenate([r["cp_grad_w"] for r in ranks], axis=1)
    np.testing.assert_allclose(got_x, x.grad.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_w, w.grad.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype", ["float64", "bf16"])
def test_upsample_halo_equals_the_unsharded_upsample(worlds, inputs, world, dtype):
    x = torch.from_numpy(inputs["up"])
    key = "up" if dtype == "float64" else "up_bf16"
    if dtype == "bf16":
        x = x.to(torch.bfloat16)
    want = upsample_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]))
    want = want.float().numpy() if dtype == "bf16" else want.numpy()
    got = _rows(worlds[world], key)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 if dtype == "float64" else 0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["det", "seg"])
def test_sharded_model_matches_jax_unsharded(worlds, inputs, world, name):
    for i, want in enumerate(inputs["want"][name]):
        got = _rows(worlds[world], name, i)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", FAMILIES + ("disco",))
def test_fusion_family_sharded_float64(worlds, inputs, mode):
    ranks = worlds[2]
    case = inputs["models"][f"f64_{mode}"]
    model = DetModel(CFG, mode, WIDTH, **case["kw"])
    model.load_state_dict(case["state"])
    model.double()
    with torch.no_grad():
        want = model(torch.from_numpy(case["occ"]).double(), torch.from_numpy(case["trans"]),
                     torch.from_numpy(case["mask"]), train=case["train"])
    for i, w in enumerate((want.cls_logits, want.reg)):
        w = w.numpy()
        np.testing.assert_allclose(_rows(ranks, f"f64_{mode}", i), w, rtol=0,
                                   atol=1e-10 * np.abs(w).max())


def test_sharded_bf16_within_jax_bf16_error(worlds, inputs):
    """The two rules against JAX's bf16 and float32, and rule 1 against
    the port's unsharded bf16 forward in place of JAX's float32."""
    want, case = inputs["want"], inputs["models"]["det_bf16"]
    model = DetModel(CFG, "disco", WIDTH, fusion_layer=2)
    model.load_state_dict(case["state"])
    with torch.no_grad():
        port = model(torch.from_numpy(case["occ"]).to(torch.bfloat16),
                     torch.from_numpy(case["trans"]), torch.from_numpy(case["mask"]))
    for i, head in enumerate(("cls", "reg")):
        got = _rows(worlds[2], "det_bf16", i)
        f32, bf, s2d_bf = want["det"][i], want["det_bf16"][i], want["det_bf16_s2d"][i]
        hold_bf16(f"sharded disco {head}", got, f32, dist(bf, f32), bf, dist(s2d_bf, bf))
        hold_bf16(f"sharded disco {head} vs the port's unsharded bf16", got,
                  port[i].float().numpy(), dist(bf, f32))


def test_shards_that_do_not_split_raise():
    """A stride-2 conv or a 2x2 pool needs an even row count on every
    shard, and a sharded upsample doubles its shard: each raises before
    any exchange."""
    from v2x_sim_tpu_torch.models.backbone import upsample_like
    from v2x_sim_tpu_torch.parallel import spatial

    odd = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError, match="even row count"):
        spatial.max_pool2x2_rows(odd)
    with pytest.raises(ValueError, match="even row count"):
        spatial.conv3x3s2_halo(odd, torch.zeros(2, 2, 3, 3), group=object())
    with pytest.raises(ValueError, match="doubles the shard"):
        upsample_like(odd, torch.zeros(1, 2, 5, 8), group=object())
