"""The port's visibility maps and visibility input against the JAX package
on the CPU.

  * ``visibility_map`` / ``visibility_batch`` on seeded float32 clouds
    (padded points, returns beyond the extents, the long ray of
    tests/test_visibility.py, the hand-checked single ray), at the small
    and the production grid: exactly equal (0 cells differ). Both packages
    compute the slab clip, the samples and the voxel indices in the same
    order. JAX under jit (its DetModule's fallback) fuses and reorders the
    sample arithmetic: there, cells may differ only where a sample lies
    within 2e-6 m of a voxel face (test_visibility_batch_against_jitted_jax
    counts them); the float64 steps below run on clouds where none does.
  * ``DetModel(use_vis=True)``: the encoder's first conv takes 2·D
    channels; the JAX ``DetModule(use_vis=True)`` tree loads through the
    bridge by name; eval logits on the same 16-channel input within the
    2e-4 of tests/test_torch_model.py.
  * ``DetModule(use_vis=True)``: prepared input equal to JAX's (exact), and
    one float64 step equal to JAX's plain execution under the rules of
    tests/test_torch_train.py (loss rtol 1e-5, grads atol 1e-4 x max|g|
    per leaf, Adam's new params, running stats rtol 1e-5), with baked
    ``vis_maps`` and with the on-device fallback, for disco; upperbound's
    prepared input (the visibility after the merged occupancy) exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.ops import visibility as jvis
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu_torch.bridge import flax_from_state_dict, random_flax_variables, state_dict_from_flax
from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.ops import visibility as pvis
from v2x_sim_tpu_torch.train.det_module import BATCH_KEYS, DetModule
from tests.test_torch_train import (  # noqa: F401  (raw is a fixture)
    CFG,
    JCFG,
    LR,
    WIDTH_F64,
    _assert_adam_close,
    _assert_grads_close,
    _assert_tree_close,
    raw,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

TINY = dict(voxel_size=(1.0, 1.0, 1.0), area_extents=((0.0, 8.0), (0.0, 8.0), (0.0, 1.0)))
SMALL = dict(voxel_size=(1.0, 1.0, 0.625))


def _both(points, mask, grid_kw, origin=None, num_samples=pvis.DEFAULT_NUM_SAMPLES):
    """(port, JAX) visibility of one float32 cloud."""
    pts, m = np.asarray(points, np.float32), np.asarray(mask, bool)
    o = None if origin is None else np.asarray(origin, np.float32)
    got = pvis.visibility_map(torch.from_numpy(pts), torch.from_numpy(m), GridConfig(**grid_kw),
                              None if o is None else torch.from_numpy(o), num_samples)
    want = jvis.visibility_map(jnp.asarray(pts), jnp.asarray(m), JaxGrid(**grid_kw),
                               None if o is None else jnp.asarray(o), num_samples)
    return got.numpy(), np.asarray(want)


def test_constants_match_jax():
    assert (pvis.FREE, pvis.OCCUPIED, pvis.DEFAULT_NUM_SAMPLES) == (
        jvis.FREE, jvis.OCCUPIED, jvis.DEFAULT_NUM_SAMPLES)


@pytest.mark.parametrize("case", ["single_ray", "padded", "out_of_extent", "long_ray"])
def test_visibility_map_cases_match_jax(case):
    if case == "single_ray":
        got, want = _both([[6.5, 0.5, 0.5]], [True], TINY, [0.5, 0.5, 0.5], 64)
        assert got[6, 0, 0] == pvis.OCCUPIED and (got[:6, 0, 0] == pvis.FREE).all()
    elif case == "padded":
        got, want = _both([[6.5, 0.5, 0.5], [3.5, 3.5, 0.5]], [False, False], TINY)
        assert got.max() == 0.0
    elif case == "out_of_extent":
        got, want = _both([[20.5, 0.5, 0.5]], [True], TINY, [0.5, 0.5, 0.5], 256)
        assert (got[:, 0, 0] == pvis.FREE).all()
    else:  # ~90 m, slightly off-axis, at the production grid and sample count
        got, want = _both([[90.0, 7.03, 0.5]], [True], {}, [0.0, 0.0, 0.5])
        assert (got == pvis.FREE).sum() > 120  # ~32 m of ray in the grid at 0.25 m
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _clouds():
    """Seeded clouds over +-40 m (a third of the returns beyond the
    extents) with 10% padded points and a few zero-length rays; 12 clouds,
    so that visibility_batch carves a full chunk and a partial one."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-40.0, 40.0, (2, 6, 1024, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3.5, 2.5, pts.shape[:-1])
    pts[0, 0, :8] = 0.0  # returns at the sensor
    return pts, rng.random((2, 6, 1024)) < 0.9


def _face_distance(points, mask, grid, samples):
    """(N, H, W, D) least distance in m from one of a voxel's faces of a
    valid ray sample (numpy float32, the port's order of operations) that
    lies in the voxel or in its neighbour across that face; inf where none."""
    p = points.reshape(-1, points.shape[-2], 3)
    lo = np.array([e[0] for e in grid.area_extents], np.float32)
    hi = np.array([e[1] for e in grid.area_extents], np.float32)
    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(p) > 1e-9, np.float32(1.0) / np.where(p == 0, np.float32(1.0), p),
                       np.float32(1e30))
    ta, tb = lo * inv, hi * inv
    tmin = np.clip(np.minimum(ta, tb).max(-1), 0, 1)
    tmax = np.clip(np.maximum(ta, tb).min(-1), 0, 1)
    frac = np.arange(samples, dtype=np.float32) / np.float32(samples)
    t = tmin[:, None] + frac[None, :, None] * (tmax - tmin)[:, None]
    smp = (t[..., None] * p[:, None]).astype(np.float64)  # (N, S, P, 3)
    ok = (mask.reshape(-1, 1, p.shape[1]) & (tmax > tmin)[:, None]).repeat(samples, 1)
    vs, shape = np.asarray(grid.voxel_size), np.asarray(grid.grid_shape)
    q = (smp - np.asarray(grid.lower)) / vs
    cell = np.floor(q).astype(np.int64)
    out = np.full((len(p),) + grid.grid_shape, np.inf)
    n = np.broadcast_to(np.arange(len(p))[:, None, None], ok.shape)
    for ax in range(3):
        for side, dist in ((-1, (q[..., ax] - cell[..., ax]) * vs[ax]),
                           (1, (cell[..., ax] + 1 - q[..., ax]) * vs[ax])):
            for shift in (0, side):
                c = cell.copy()
                c[..., ax] += shift
                inside = ok & ((c >= 0) & (c < shape)).all(-1)
                np.minimum.at(out, (n[inside], *c[inside].T), dist[inside])
    return out


@pytest.mark.parametrize("grid_kw, samples", [(SMALL, pvis.DEFAULT_NUM_SAMPLES),
                                              ({}, pvis.DEFAULT_NUM_SAMPLES)],
                         ids=["small_384", "production_384"])
def test_visibility_batch_matches_jax(grid_kw, samples):
    """Against JAX as its create_data_det bake calls it, op by op: exactly
    equal."""
    pts, mask = _clouds()
    assert pts.shape[0] * pts.shape[1] > pvis.CHUNK
    got = pvis.visibility_batch(torch.from_numpy(pts), torch.from_numpy(mask), GridConfig(**grid_kw),
                                num_samples=samples).numpy()
    want = np.asarray(jvis.visibility_batch(jnp.asarray(pts), jnp.asarray(mask), JaxGrid(**grid_kw),
                                            samples))
    assert got.shape == want.shape == (2, 6) + GridConfig(**grid_kw).grid_shape
    assert (want == 1).sum() > 1000 and (want == 2).sum() > 100
    np.testing.assert_array_equal(got, want)  # 0 cells differ


def test_visibility_batch_against_jitted_jax():
    """Against JAX under jax.jit, as its DetModule's fallback runs it
    (production grid, 64 samples). XLA fuses the samples into the voxel
    index (a fused multiply-add skips the rounding of t * d) and rewrites
    arange(S)/S as arange(S) * (1/S), so a sample within half a float32
    ulp of a face may land on its other side: at |x| <= 32 m that is
    1.9e-6 m. Only such cells may differ: each differing cell must have a
    sample of the port's float32 evaluation within 2e-6 m of one of its
    faces. These clouds give 25560 such cells of 10,223,616 (218 of them
    beyond 1e-6 m, 0 beyond 2e-6 m). (At S=384 JAX's own eager and jitted
    runs of these clouds differ in 8566 cells; the port keeps
    arange(S)/S, JAX's eager value.)"""
    pts, mask = _clouds()
    got = pvis.visibility_batch(torch.from_numpy(pts), torch.from_numpy(mask), GridConfig(),
                                num_samples=64).numpy()
    want = np.asarray(jax.jit(jvis.visibility_batch, static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(mask), JaxGrid(), 64))
    differ = (got != want).reshape((12,) + GridConfig().grid_shape)
    assert 0 < differ.sum() < 0.005 * differ.size
    assert ((got == 2) == (want == 2)).all()  # the returns' voxels are equal
    dist = _face_distance(pts, mask, GridConfig(), 64)
    assert (dist[differ] <= 2e-6).all(), np.sort(dist[differ])[-5:]


def _jax_module(mode, **kw):
    jmod = JaxDetModule(JCFG, mode=mode, use_vis=True, **kw)
    dtype = kw.get("compute_dtype", jnp.float32)
    jmod.model = JaxDetModel(config=JCFG, mode=mode, dtype=None if dtype == jnp.float32 else dtype,
                             s2d=False, width_mult=kw.get("width_mult", 1.0))
    jmod._blocked = jmod._occ_blocked = False
    return jmod


def test_use_vis_tree_bridges_and_logits_match_jax(raw):
    """JAX's own DetModule(use_vis=True) tree (its init, with the plain
    model, whose tree is the default one's) loads into the port's
    DetModel(use_vis=True) by name; the first conv is 16 wide."""
    jmod = _jax_module("disco", width_mult=0.25)
    batch = {k: jnp.asarray(v) for k, v in raw.items() if k != "visible"}
    state = jax.jit(jmod.init)(jax.random.PRNGKey(0), batch)
    variables = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    d = CFG.grid.grid_shape[2]
    assert variables["params"]["encoder"]["ConvBlock_0"]["Conv_0"]["kernel"].shape[2] == 2 * d
    model = DetModel(CFG, "disco", 0.25, use_vis=True)
    model.load_state_dict(state_dict_from_flax(variables, "disco"), strict=True)
    assert model.encoder.blocks[0].conv1.in_channels == 2 * d
    assert DetModel(CFG, "disco", 0.25).encoder.blocks[0].conv1.in_channels == d

    occ = np.asarray(jax.jit(jmod._model_input)(batch))
    assert occ.shape[-1] == 2 * d and set(np.unique(occ[..., d:])) <= {0.0, 0.5, 1.0}
    want = jax.jit(lambda v, o: jmod.model.apply(v, o, batch["trans"], batch["agent_mask"],
                                                 train=False))(variables, occ)
    with torch.no_grad():
        got = model(torch.from_numpy(occ.copy()), torch.from_numpy(raw["trans"]),
                    torch.from_numpy(raw["agent_mask"]))
    for name in ("cls_logits", "reg"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=2e-4, err_msg=name)


@pytest.fixture(scope="module")
def jax_steps(raw):
    """mode -> the JAX plain execution's float64 step from fresh maps:
    weights, prepared input, metrics, grads, new params and stats."""
    memo = {}

    def step(mode):
        if mode in memo:
            return memo[mode]
        variables = random_flax_variables(DetModel(CFG, mode, WIDTH_F64, use_vis=True), seed=6)
        with jax.enable_x64(True):
            jmod = _jax_module(mode, compute_dtype=jnp.float64, width_mult=WIDTH_F64,
                               learning_rate=LR)
            prep = jax.jit(jmod.prepare_batch)(raw)
            v = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
            (_, (stats, met)), grads = jax.jit(
                jax.value_and_grad(jmod.loss_fn, has_aux=True), static_argnums=(4,))(
                v["params"], v["batch_stats"], prep, None, True)
            updates, _ = jmod.tx.update(grads, jmod.tx.init(v["params"]), v["params"])
            params = jax.tree.map(lambda p, u: p + u, v["params"], updates)
            memo[mode] = jax.tree.map(np.asarray, {
                "variables": variables, "occupancy": prep["occupancy"], "met": met,
                "grads": grads, "params": params, "stats": stats})
        return memo[mode]

    return step


def test_use_vis_upperbound_input_matches_jax(raw):
    """Upperbound appends the visibility of each agent's own cloud after
    the merged occupancy: the prepared input equals JAX's exactly."""
    jmod = _jax_module("upperbound", width_mult=WIDTH_F64)
    want = np.asarray(jax.jit(jmod._model_input)({k: raw[k] for k in BATCH_KEYS if k in raw}))
    port = DetModule(CFG, "upperbound", device="cpu", width_mult=WIDTH_F64, use_vis=True)
    got = port.prepare_batch(raw)["occupancy"].numpy()
    d = CFG.grid.grid_shape[2]
    assert got.shape[-1] == 2 * d and (got[..., d:] == 0.5).sum() > 1000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("baked", [True, False], ids=["disco_baked", "disco_fallback"])
def test_use_vis_float64_step_matches_jax(raw, jax_steps, baked, monkeypatch):
    """The JAX step carves its maps; the baked case gives the port JAX's
    carving as int8 vis_maps (the same maps: the prepared inputs equal)."""
    mode = "disco"
    want = jax_steps(mode)
    batch = dict(raw)
    if baked:
        vis = jax.jit(jvis.visibility_batch, static_argnums=(2,))(
            jnp.asarray(raw["points"]), jnp.asarray(raw["point_mask"]), JCFG.grid)
        batch["vis_maps"] = np.asarray(vis, np.int8)
    port = DetModule(CFG, mode, torch.float64, device="cpu", learning_rate=LR, width_mult=WIDTH_F64,
                     use_vis=True)
    port.model.double()
    port.load_flax_variables(want["variables"])
    assert "vis_maps" in BATCH_KEYS
    if baked:  # the baked maps reach the module: the fallback must not run
        monkeypatch.setattr("v2x_sim_tpu_torch.train.det_module.visibility_batch",
                            lambda *a, **k: pytest.fail("carved maps despite baked vis_maps"))
    prepared = port.prepare_batch(batch)
    np.testing.assert_array_equal(prepared["occupancy"].numpy(), want["occupancy"])
    met = port.train_step(prepared)
    for key in ("cls_loss", "loc_loss", "loss"):
        np.testing.assert_allclose(met[key].item(), float(want["met"][key]), rtol=1e-5, err_msg=key)
    grads = flax_from_state_dict({n: p.grad for n, p in port.model.named_parameters()}, mode)
    _assert_grads_close(grads["params"], want["grads"])
    new = flax_from_state_dict(port.model.state_dict(), mode)
    _assert_adam_close(new["params"], want["params"], want["grads"])
    _assert_tree_close(new["batch_stats"], want["stats"], rtol=1e-5, atol=1e-5)
