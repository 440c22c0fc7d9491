"""The training slice: the port's DetModule.prepare_batch and train_step
against the JAX DetModule(mode="disco") on the CPU, same points, same
weights.

DiscoNet at full widths (32..512), 6 agents on a 64x64x8 grid (1 m
voxels), B=2 with one padded agent. The weights are one flax tree from
``bridge.random_flax_variables`` (He-normal kernels, random biases, BN
affines and running stats: the recipe of test_torch_model.py::_perturb,
without the JAX init's eager compile), loaded by both packages.

Against the JAX package's default execution (space-to-depth, blocked
heads), in float32:
  * prepared targets: occupancy and reg_sp_w exact, reg_sp_t within
    1e-5, cells/lanes exact after mapping the port's plain anchor order
    to the blocked one, labels exact except within 1e-5 of a threshold;
  * loss and its terms at rtol 1e-5; running stats after the forward at
    rtol 1e-4 (E[x^2] - E[x]^2 in float32 loses digits to cancellation;
    the float64 steps below hold them to 1e-5).

Gradients and optimizer steps are compared in float64, against the JAX
model's plain execution (``s2d=False``, the same param tree), at
width_mult 0.25 (8..128 channels: float64 convolutions run ~15x slower
than float32 ones on the CPU). This network's training gradients are
ill-conditioned: ``python -m tests.grad_conditioning`` measured, as the
largest per-leaf difference over that leaf's max, the port's float32
against its float64 gradients at 1.9e-2 at full width (2.4e-5 at 0.25
with this file's weights), and the JAX space-to-depth execution, whose
BatchNorm statistics are float32 even in a float64 run
(v2x_sim_tpu/models/s2d.py:281), against the plain one at 1.4e-3 at full
width (1.8e-4 at 0.25 with this file's weights); the port against the
plain execution at 2.7e-7 and 3.1e-7. So:
  * grads, mapped back through ``flax_from_state_dict``: atol 1e-4 x
    max|g| per leaf, where max|g| is at least 1e-6 of the model's
    largest gradient (the fusion's score bias has an exactly zero
    gradient, softmax being shift invariant, and holds only rounding);
  * Adam: the first steps are nearly sign functions (lr g / (|g| + 1e-8)),
    so a gradient entry at rounding level may move either way by lr.
    New params must agree to 1e-8 where |g_jax| exceeds 1e-3 of its
    leaf's max|g|, and to 2 lr elsewhere; running stats to 1e-5;
  * one step with grad_clip at half the gradient's global norm (Adam's
    first moment must equal optax's), and a JAX state after 2 steps
    (params, stats, Adam's count/mu/nu, rounded to float32 on both sides
    as the bridge carries them) continued by both for step 3.

The other collaboration modes and KD take the same float64 step in
tests/test_torch_train_modes.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.models.s2d import depth_to_space
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu_torch.bridge import (
    adam_state_from_optax,
    flax_from_state_dict,
    random_flax_variables,
    state_dict_from_flax,
)
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

VOXEL = (1.0, 1.0, 0.625)  # 64x64x8
CFG = Config(grid=GridConfig(voxel_size=VOXEL))
JCFG = JaxConfig(grid=JaxGrid(voxel_size=VOXEL))
LR = 1e-3
NEAR = 1e-5
WIDTH_F64 = 0.25


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(got, want, rtol, atol):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def _assert_grads_close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    gmax = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-6 * gmax)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale, err_msg=k)


def _assert_adam_close(got, want, grads):
    """New params after an Adam step, under the rule of the module docstring."""
    got, want, grads = _leaves(got), _leaves(want), _leaves(grads)
    gmax = max(np.abs(g).max() for g in grads.values())
    for k, w in want.items():
        g = grads[k]
        clear = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-6 * gmax)
        err = np.abs(got[k] - w)
        assert (err[clear] <= 1e-8).all(), (k, err[clear].max())
        assert (err <= 2 * LR).all(), (k, err.max())


@pytest.fixture(scope="module")
def raw():
    spec = SyntheticSpec(points_per_agent=2048, num_vehicles=12, max_gt=16)
    batch = generate_batch(CFG, spec, batch_size=2, seed=5)
    batch["agent_mask"][1, -1] = False  # one padded agent
    return batch


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(DetModel(CFG, "disco"), seed=0)


@pytest.fixture(scope="module")
def variables64():
    return random_flax_variables(DetModel(CFG, "disco", WIDTH_F64), seed=1)


@pytest.fixture(scope="module")
def f32(raw, variables):
    """The JAX default module and the port, float32, one train-mode forward."""
    jmod = JaxDetModule(JCFG, mode="disco")
    jprep = jmod.prepare_batch(raw)
    loss_fn = jax.jit(jmod.loss_fn, static_argnums=(4,))
    _, (jstats, jmet) = loss_fn(variables["params"], variables["batch_stats"], jprep, None, True)
    port = DetModule(CFG, "disco", device="cpu")
    port.load_flax_variables(variables)
    prep = port.prepare_batch(raw)
    with torch.no_grad():
        _, met = port.loss(prep, train=True)
    sp = port.targets_from_gt(torch.from_numpy(raw["gt_boxes"]), torch.from_numpy(raw["gt_mask"]),
                            flat="sparse")
    return {
        "jprep": jax.tree.map(np.asarray, jprep), "jstats": jstats, "jmet": jmet,
        "prep": prep, "met": met, "iou": sp.iou.numpy(),
        "stats": flax_from_state_dict(port.model.state_dict())["batch_stats"],
    }


def _f64_module(grad_clip=0.0):
    port = DetModule(CFG, "disco", torch.float64, device="cpu", learning_rate=LR,
                     grad_clip=grad_clip, width_mult=WIDTH_F64)
    port.model.double()
    return port


def _rounded(tree):
    """A float64 tree at float32 precision: what the bridge carries."""
    return jax.tree.map(lambda x: np.asarray(np.asarray(x, np.float32), np.float64), tree)


@pytest.fixture(scope="module")
def f64(raw, variables64):
    """The JAX model's plain execution in float64: three Adam steps on one
    batch (the third from the float32-rounded state after two), and one
    clipped first step."""
    with jax.enable_x64(True):
        jmod = JaxDetModule(JCFG, mode="disco", compute_dtype=jnp.float64, learning_rate=LR)
        # Plain (s2d=False) execution: the same params, plain-layout targets.
        jmod.model = JaxDetModel(
            config=JCFG, mode="disco", dtype=jnp.float64, s2d=False, width_mult=WIDTH_F64)
        jmod._blocked = jmod._occ_blocked = False
        prep = jmod.prepare_batch(raw)
        grad_fn = jax.jit(jax.value_and_grad(jmod.loss_fn, has_aux=True), static_argnums=(4,))

        def stepper(tx):
            def step(grads, opt, params):
                updates, opt = tx.update(grads, opt, params)
                return optax.apply_updates(params, updates), opt
            return jax.jit(step)

        step = stepper(jmod.tx)
        v = jax.tree.map(lambda x: np.asarray(x, np.float64), variables64)
        params, stats, opt = v["params"], v["batch_stats"], jmod.tx.init(v["params"])
        steps = []
        for i in range(3):
            if i == 2:
                params, stats, opt = _rounded(params), _rounded(stats), _rounded(opt)
            (_, (new_stats, _)), grads = grad_fn(params, stats, prep, None, True)
            new_params, new_opt = step(grads, opt, params)
            steps.append(jax.tree.map(np.asarray, {
                "params": params, "stats": stats, "opt": opt, "grads": grads,
                "new_params": new_params, "new_stats": new_stats}))
            params, stats, opt = new_params, new_stats, new_opt
        clip = 0.5 * float(optax.global_norm(steps[0]["grads"]))
        tx = JaxDetModule(JCFG, mode="disco", learning_rate=LR, grad_clip=clip).tx
        v_params = jax.tree.map(jnp.asarray, v["params"])
        clip_params, clip_opt = stepper(tx)(steps[0]["grads"], tx.init(v_params), v_params)
        clip_mu = next(s for s in jax.tree.leaves(
            clip_opt, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")).mu
    return {"steps": steps, "clip": clip, "clip_params": jax.tree.map(np.asarray, clip_params),
            "clip_mu": jax.tree.map(np.asarray, clip_mu)}


def _port_step(port, raw):
    """One train_step; returns (new params, new stats, grads) as flax trees."""
    port.train_step(port.prepare_batch(raw))
    new = flax_from_state_dict(port.model.state_dict())
    grads = flax_from_state_dict({n: p.grad for n, p in port.model.named_parameters()})
    return new["params"], new["batch_stats"], grads["params"]


def test_prepared_targets_match_jax(f32):
    jp, prep = f32["jprep"], f32["prep"]
    b, a = 2, CFG.num_agents
    h, w = CFG.grid.bev_shape
    k = CFG.anchors.num_anchors
    occ = np.asarray(depth_to_space(jnp.asarray(jp["occupancy"])))
    np.testing.assert_array_equal(prep["occupancy"].numpy(), occ)
    labels = np.asarray(depth_to_space(jnp.asarray(jp["labels"]).reshape(b * a, h // 2, w // 2, 4 * k)))
    got = prep["labels"].numpy().reshape(labels.shape)
    iou = f32["iou"].reshape(labels.shape)
    near = (np.abs(iou - 0.2) <= NEAR) | (np.abs(iou - 0.4) <= NEAR)
    assert ((got != labels) <= near).all()
    assert (got == 1).sum() > 50
    # The port's plain (cell, lane) of each target, mapped to the blocked order.
    cells = prep["reg_cell"].numpy()[..., ::k]
    hh, ww = cells // w, cells % w
    blocked_cell = (hh // 2) * (w // 2) + ww // 2
    blocked_lane = (2 * (hh % 2) + ww % 2)[..., None] * k + np.arange(k)
    np.testing.assert_array_equal(np.repeat(blocked_cell, k, axis=-1), jp["reg_cell"])
    np.testing.assert_array_equal(blocked_lane.reshape(b, a, -1), jp["reg_lane"])
    np.testing.assert_array_equal(prep["reg_lane"].numpy(), np.tile(np.arange(k), cells.shape[-1])[None, None].repeat(a, 1).repeat(b, 0))
    np.testing.assert_array_equal(prep["reg_sp_w"].numpy(), jp["reg_sp_w"])
    np.testing.assert_allclose(prep["reg_sp_t"].numpy(), jp["reg_sp_t"], atol=1e-5, rtol=0)
    assert prep["labels"].dtype == torch.int8 and prep["overflow"].shape == (b, a)


def test_loss_matches_jax(f32):
    for key in ("cls_loss", "loc_loss", "loss"):
        np.testing.assert_allclose(f32["met"][key].item(), float(f32["jmet"][key]), rtol=1e-5, err_msg=key)


def test_batch_stats_after_train_forward_match_jax(f32):
    _assert_tree_close(f32["stats"], f32["jstats"], rtol=1e-4, atol=1e-5)


def test_grads_and_adam_step_match_jax(f64, raw, variables64):
    want = f64["steps"][0]
    port = _f64_module()
    port.load_flax_variables(variables64)
    params, stats, grads = _port_step(port, raw)
    _assert_grads_close(grads, want["grads"])
    _assert_adam_close(params, want["new_params"], want["grads"])
    _assert_tree_close(stats, want["new_stats"], rtol=1e-5, atol=1e-5)


def test_clipped_step_matches_optax(f64, raw, variables64):
    port = _f64_module(grad_clip=f64["clip"])
    port.load_flax_variables(variables64)
    params, _, grads = _port_step(port, raw)
    g_norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in _leaves(f64["steps"][0]["grads"]).values()))
    assert g_norm > 1.9 * f64["clip"]  # the clip fires, by about half
    mu = {n: port.optimizer.state[p]["exp_avg"] for n, p in port.model.named_parameters()}
    _assert_grads_close(flax_from_state_dict(mu)["params"], f64["clip_mu"])
    _assert_adam_close(params, f64["clip_params"], f64["steps"][0]["grads"])


def test_carried_over_jax_state_continues_step_for_step(f64, raw):
    want = f64["steps"][2]  # step 3, from the rounded state after two JAX steps
    port = _f64_module()
    port.load_flax_variables({"params": want["params"], "batch_stats": want["stats"]})
    adam_state_from_optax(want["opt"], port)
    state = next(iter(port.optimizer.state.values()))
    assert float(state["step"]) == 2.0 and state["exp_avg"].dtype == torch.float64
    params, stats, grads = _port_step(port, raw)
    _assert_grads_close(grads, want["grads"])
    _assert_adam_close(params, want["new_params"], want["grads"])
    _assert_tree_close(stats, want["new_stats"], rtol=1e-5, atol=1e-5)


def test_bridge_round_trips_both_ways(variables):
    back = flax_from_state_dict(state_dict_from_flax(variables, "disco"), "disco")
    got, want = _leaves(back), _leaves(variables)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        adam_state_from_optax((optax.EmptyState(),), _f64_module())


def test_baked_targets_prepare_like_gt_targets(raw, variables):
    port = DetModule(CFG, "disco", device="cpu")
    from_gt = port.prepare_batch(raw)
    sp = port.targets_from_gt(torch.from_numpy(raw["gt_boxes"]), torch.from_numpy(raw["gt_mask"]),
                            flat="sparse")
    n = sp.labels.shape[-1]
    lab = sp.labels.numpy()

    def idx(value, cap):
        out = np.full(lab.shape[:2] + (cap,), n, np.int32)
        for i in np.ndindex(*lab.shape[:2]):
            hit = np.flatnonzero(lab[i] == value)
            out[i][: len(hit)] = hit
        return out

    baked = dict(raw, tgt_pos_idx=idx(1, 600), tgt_ign_idx=idx(-1, 2000), tgt_cells=sp.cells.numpy(),
                 tgt_reg=sp.reg.to(torch.bfloat16), tgt_wts=sp.wts.to(torch.int8))
    got = port.prepare_batch(baked)
    for key in ("occupancy", "labels", "reg_cell", "reg_lane", "reg_sp_w"):
        assert torch.equal(got[key], from_gt[key]), key
    torch.testing.assert_close(got["reg_sp_t"], from_gt["reg_sp_t"], atol=2e-2, rtol=1e-2)  # bf16 storage


def test_port_loss_falls_over_steps(raw, variables):
    port = DetModule(CFG, "disco", device="cpu")
    port.load_flax_variables(variables)
    prep = port.prepare_batch(raw)
    losses = [port.train_step(prep)["loss"].item() for _ in range(4)]
    assert all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:])), losses

