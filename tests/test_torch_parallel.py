"""Data parallelism of the port (``parallel/mesh.py``, DetModule's and
SegModule's ``process_group``, ``train_det --dp``) on the CPU over gloo.

JAX's contract (tests/test_parallel.py): an N-rank step is the
single-process step on the global batch. Two gloo ranks (tests/
torch_dist.py) each take 2 scenes of a global batch of 4 at
test_parallel.py's CFG and SPEC (32x32x4, 2 agents; one padded agent on
rank 1), width_mult 0.25, float64, and take one step:
  * DetModule in mode mean; disco with KD (kd_weight 1e5, a random
    upperbound teacher); disco with MGDA and use_vis (each rank carves
    its own rows' visibility);
  * SegModule (disco, depth 2).
Each rank's parameters, running stats and Adam moments are bit-identical
to the other's. Against the port's single-process step on the 4 scenes
and against JAX's single-device step (plain execution, float64) on the
same weights and batch: the loss terms (float32 sums in both packages,
even in float64 runs) at rtol 1e-6 against the port (a few float32
ulps: the ranks sum their halves first) and 1e-5 against JAX; the
``mgda_w_*`` within 1e-6; Adam's first moment (0.1 x the summed
gradient) under tests/test_torch_train.py's gradient rule, the new
parameters under its Adam rule, the running stats at rtol 1e-10 against
the port and 1e-5 against JAX (and as far from zero).

``train_det --dp 2 --cpu`` against ``--dp 0 --cpu`` over 2 steps
(float32, the small grid): the first step's loss within 1e-6; after it,
the parameters equal within 1e-6 but at the few entries whose gradient
is at rounding level, where Adam's first step (about lr x sign(g)) may go
either way (at most 2 lr, on at most 0.1% of the entries); the running
stats within 1e-5 of their leaf's max. Those few entries change the
second step's gradients throughout (its loss by ~3e-5 of it, most
parameters by more than 1e-6), so after it only Adam's bound of 2 lr a
step holds. Only rank 0
logs and writes checkpoints. Resumed from the first epoch's checkpoint,
``--dp 2`` takes the uninterrupted run's second step: its loss within
1e-6, every parameter and running stat within 1e-6.
Each rank makes only its rows of a batch (``make_batches``' ``shard``,
``shard_batch``'s rows). The tool raises when the batch does not split
over the ranks, and when there are fewer cards than ranks without
``--cpu``. ``average_`` (the running stats' pmean) raises when the ranks
held different values.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.models.det.net import TeacherModel as JaxTeacherModel
from v2x_sim_tpu.models.seg.unet import SegModel as JaxSegModel
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.train.det_module import TrainState as JaxTrainState
from v2x_sim_tpu.train.seg_module import SegModule as JaxSegModule
from v2x_sim_tpu_torch.bridge import flax_from_state_dict, random_flax_variables, seg_key_map
from v2x_sim_tpu_torch.datasets.cache import save_frame
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.models.seg.unet import SegModel
from v2x_sim_tpu_torch.ops.visibility import visibility_batch
from v2x_sim_tpu_torch.parallel.mesh import Mesh, shard_batch
from v2x_sim_tpu_torch.tools import train_det
from v2x_sim_tpu_torch.tools.common import make_batches
from tests import torch_dist
from tests.test_torch_train import LR, _assert_adam_close, _assert_grads_close, _assert_tree_close
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

VOXEL = (2.0, 2.0, 1.25)  # tests/test_parallel.py's CFG: 32x32x4, 2 agents
CFG = Config(grid=GridConfig(voxel_size=VOXEL), num_agents=2)
JCFG = JaxConfig(grid=JaxGrid(voxel_size=VOXEL), num_agents=2)
SPEC = SyntheticSpec(num_vehicles=3, points_per_agent=256, max_gt=4, points_per_vehicle=24)
WIDTH = 0.25
WORLD = 2
BATCH = 4  # global; 2 scenes a rank
KD_WEIGHT = 1e5
SEG_DEPTH = 2

#: case -> (mode, DetModule options); "seg" is a SegModule step.
DET_CASES = {
    "mean": ("mean", {}),
    "disco_kd": ("disco", {"kd_weight": KD_WEIGHT}),
    "mgda_use_vis": ("disco", {"mgda": True, "use_vis": True}),
}
CASES = list(DET_CASES) + ["seg"]


@pytest.fixture(scope="module")
def batch():
    raw = generate_batch(CFG, SPEC, batch_size=BATCH, seed=3)
    raw["agent_mask"][3, 1] = False  # a padded agent in rank 1's rows
    return {k: v for k, v in raw.items() if k != "visible"}


@pytest.fixture(scope="module")
def cases():
    """case -> the step's inputs (tests/torch_dist.py's det_step/seg_step)."""
    out = {}
    for i, (name, (mode, opts)) in enumerate(DET_CASES.items()):
        kd = opts.get("kd_weight", 0.0) > 0.0
        model = DetModel(CFG, mode, WIDTH, kd=kd, use_vis=opts.get("use_vis", False))
        out[name] = {"mode": mode, "opts": {"width_mult": WIDTH, "learning_rate": LR, **opts},
                     "variables": random_flax_variables(model, seed=20 + i),
                     "teacher": random_flax_variables(DetModel(CFG, "upperbound", WIDTH), seed=30)
                     if kd else None}
    seg_opts = {"width_mult": WIDTH, "learning_rate": LR, "depth": SEG_DEPTH}
    out["seg"] = {"mode": "disco", "opts": seg_opts, "variables": random_flax_variables(
        SegModel(CFG, "disco", WIDTH, SEG_DEPTH), seed=40)}
    return out


@pytest.fixture(scope="module")
def ranks(batch, cases, tmp_path_factory):
    """Each rank's record of every case's step, over two gloo ranks."""
    det = {k: v for k, v in cases.items() if k != "seg"}
    return torch_dist.run(torch_dist.dp_steps, WORLD, tmp_path_factory.mktemp("dp"), CFG, det,
                          CFG, {"seg": cases["seg"]}, batch, batch)


def _single(cases, batch, name):
    if name == "seg":
        return torch_dist.seg_step(CFG, cases[name], batch)
    return torch_dist.det_step(CFG, cases[name], batch)


def _jax_det(case, batch):
    """JAX's single-device float64 step of a det case (plain execution):
    metrics, Adam's first moment, new params and stats."""
    opts = {k: v for k, v in case["opts"].items() if k != "learning_rate"}
    kd = opts.get("kd_weight", 0.0) > 0.0
    jbatch = dict(batch)
    if opts.get("use_vis"):  # the port's carving equals JAX's op by op (test_torch_visibility.py)
        jbatch["vis_maps"] = visibility_batch(torch.from_numpy(batch["points"]),
                                              torch.from_numpy(batch["point_mask"]),
                                              CFG.grid).numpy().astype(np.int8)
    with jax.enable_x64(True):
        jmod = JaxDetModule(JCFG, mode=case["mode"], compute_dtype=jnp.float64, learning_rate=LR,
                            **opts)
        jmod.model = JaxDetModel(config=JCFG, mode=case["mode"], dtype=jnp.float64, s2d=False,
                                 width_mult=WIDTH, kd=kd)
        jmod.teacher = JaxTeacherModel(config=JCFG, dtype=jnp.float64, s2d=False, width_mult=WIDTH)
        jmod._blocked = jmod._occ_blocked = False
        prep = jmod.prepare_batch(jbatch)
        v = jax.tree.map(lambda x: np.asarray(x, np.float64), case["variables"])
        t = None if not kd else jax.tree.map(lambda x: np.asarray(x, np.float64), case["teacher"])
        state = JaxTrainState(v["params"], v["batch_stats"], jmod.tx.init(v["params"]),
                              jnp.zeros((), jnp.int32))
        impl = jmod._train_step_mgda_impl if jmod.mgda else jmod._train_step_impl
        new, met = jax.jit(impl)(state, prep, t)
        mu = next(s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                  if hasattr(s, "mu")).mu
        return jax.tree.map(np.asarray, {"met": met, "mu": mu, "params": new.params,
                                         "stats": new.batch_stats})


def _jax_seg(case, batch):
    """JAX's single-device float64 SegModule step (plain execution)."""
    opts = case["opts"]
    with jax.enable_x64(True):
        jmod = JaxSegModule(JCFG, mode=case["mode"], learning_rate=LR, compute_dtype=jnp.float64,
                            width_mult=opts["width_mult"], depth=opts["depth"])
        jmod.model = JaxSegModel(config=JCFG, mode=case["mode"], dtype=jnp.float64, s2d=False,
                                 width_mult=opts["width_mult"], depth=opts["depth"])
        prep = jmod.prepare_batch(batch)
        v = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), case["variables"])
        (_, (stats, met)), grads = jax.jit(jax.value_and_grad(jmod.loss_fn, has_aux=True),
                                           static_argnums=(3,))(
            v["params"], v["batch_stats"], prep, True)
        opt = jmod.tx.init(v["params"])
        updates, opt = jmod.tx.update(grads, opt, v["params"])
        params = jax.tree.map(lambda p, u: p + u, v["params"], updates)
        mu = jax.tree.map(lambda g: 0.1 * g, grads)
        return jax.tree.map(np.asarray, {"met": met, "mu": mu, "params": params, "stats": stats})


def _flax(arrays, name):
    kmap = seg_key_map("disco", SEG_DEPTH) if name == "seg" else DET_CASES[name][0]
    return flax_from_state_dict({k: torch.from_numpy(v) for k, v in arrays.items()}, kmap)


def _check_step(got, want, name, loss_rtol, stats_tol):
    """A rank's record against a reference record of the same step (both
    in the port's names and layout, as flax trees)."""
    assert sorted(got["metrics"]) == sorted(want["met"])
    for key, w in want["met"].items():
        if key.startswith("mgda_w_"):
            np.testing.assert_allclose(got["metrics"][key], float(w), rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got["metrics"][key], float(w), rtol=loss_rtol, err_msg=key)
    _assert_grads_close(_flax(got["exp_avg"], name)["params"], want["mu"])
    new = _flax(got["state"], name)
    _assert_adam_close(new["params"], want["params"], jax.tree.map(lambda m: m / 0.1, want["mu"]))
    _assert_tree_close(new["batch_stats"], want["stats"], rtol=stats_tol, atol=stats_tol)


@pytest.mark.parametrize("name", CASES)
def test_ranks_hold_identical_state(ranks, name):
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0["metrics"] == r1["metrics"]
    for part in ("state", "exp_avg", "exp_avg_sq"):
        assert sorted(r0[part]) == sorted(r1[part])
        for k in r0[part]:
            np.testing.assert_array_equal(r0[part][k], r1[part][k], err_msg=f"{part} {k}")


@pytest.mark.parametrize("name", CASES)
def test_dp_step_is_the_single_process_step(ranks, cases, batch, name):
    ref = _single(cases, batch, name)
    want = {"met": ref["metrics"], "mu": _flax(ref["exp_avg"], name)["params"]}
    want.update({"params": _flax(ref["state"], name)["params"],
                 "stats": _flax(ref["state"], name)["batch_stats"]})
    _check_step(ranks[0][name], want, name, loss_rtol=1e-6, stats_tol=1e-10)


@pytest.mark.parametrize("name", CASES)
def test_dp_step_matches_jax_single_device(ranks, cases, batch, name):
    want = _jax_seg(cases[name], batch) if name == "seg" else _jax_det(cases[name], batch)
    _check_step(ranks[0][name], want, name, loss_rtol=1e-5, stats_tol=1e-5)


def _tool_argv(logpath, *extra):
    return ["--cpu", "--grid", "small", "--width_mult", "0.25", "--com", "disco", "--batch", "2",
            "--batches_per_epoch", "1", "--log_every", "1", "--lr", str(LR),
            "--logpath", str(logpath), *extra]


def _checkpoint(path):
    return {k: v.double().numpy() for k, v in
            torch.load(path, map_location="cpu", weights_only=True)["model"].items()
            if v.is_floating_point()}


def _losses(logpath):
    import json

    return [json.loads(line)["loss"] for line in (logpath / "metrics.jsonl").read_text().splitlines()]


def test_train_det_dp_matches_single_process_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setattr(train_det, "DP_TIMEOUT", torch_dist.TIMEOUT_S)
    one, dp, resumed = tmp_path / "dp0", tmp_path / "dp2", tmp_path / "resumed"
    train_det.main(_tool_argv(one, "--nepoch", "2"))
    run = train_det.main(_tool_argv(dp, "--nepoch", "2", "--dp", "2"))
    assert (run.start_epoch, run.step) == (0, 2)
    assert sorted(p.name for p in dp.iterdir()) == ["epoch_0", "epoch_1", "log.txt",
                                                    "metrics.jsonl"]
    log = (dp / "log.txt").read_text()
    assert log.count("saved ") == 2 and log.count("epoch 0:") == 1  # rank 0 alone
    np.testing.assert_allclose(_losses(dp)[0], _losses(one)[0], rtol=1e-6)

    want, got = _checkpoint(one / "epoch_0"), _checkpoint(dp / "epoch_0")
    assert sorted(got) == sorted(want)
    params = [k for k in want if "running_" not in k]
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in params])
    assert diff.max() <= 2 * LR and (diff > 1e-6).mean() <= 1e-3, (diff.max(), (diff > 1e-6).mean())
    for k in want:
        if "running_" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max(),
                                       err_msg=k)
    # The first step's few flipped entries change the second step's
    # gradients throughout: after it only Adam's bound holds.
    got, want = _checkpoint(dp / "epoch_1"), _checkpoint(one / "epoch_1")
    assert max(np.abs(got[k] - want[k]).max() for k in params) <= 2 * 2 * LR

    # Resumed from epoch_0 alone, the second step is the uninterrupted run's:
    # parameters, running stats and Adam's moments restored and replicated.
    resumed.mkdir()
    shutil.copy(dp / "epoch_0", resumed / "epoch_0")
    run = train_det.main(_tool_argv(resumed, "--nepoch", "2", "--dp", "2", "--resume", "auto"))
    assert (run.start_epoch, run.start_step, run.step) == (1, 1, 2)
    assert (resumed / "log.txt").read_text().count("resumed from") == 1
    np.testing.assert_allclose(_losses(resumed), _losses(dp)[2:], rtol=1e-6)
    got, want = _checkpoint(resumed / "epoch_1"), _checkpoint(dp / "epoch_1")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_train_det_dp_fails_loudly(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="does not split over --dp 2"):
        train_det.main(_tool_argv(tmp_path, "--batch", "3", "--dp", "2"))
    argv = [a for a in _tool_argv(tmp_path, "--dp", "2") if a != "--cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_det.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--dp 2 needs 2 CUDA cards, this host has 1"):
        train_det.main(argv)
    assert not any(tmp_path.iterdir())  # nothing ran


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_takes_the_ranks_rows(world):
    batch = {"a": np.arange(8 * 3).reshape(8, 3), "b": torch.arange(8)}
    for r in range(world):
        got = shard_batch(batch, Mesh((world, 1), r, torch.device("cpu"), None, None))
        rows = slice(r * 8 // world, (r + 1) * 8 // world)
        np.testing.assert_array_equal(got["a"], batch["a"][rows])
        assert torch.equal(got["b"], batch["b"][rows])
    with pytest.raises(ValueError, match="does not split over 3 data ranks"):
        shard_batch(batch, Mesh((3, 1), 0, torch.device("cpu"), None, None))


@pytest.mark.parametrize("source", ["synthetic", "cache"])
def test_make_batches_shard_makes_only_the_ranks_rows(tmp_path, source):
    """Each rank's shard of make_batches is its rows of the whole batch,
    so --dp N trains on --dp 0's scenes without making the others'."""
    data = "synthetic"
    if source == "cache":
        raw = generate_batch(CFG, SPEC, batch_size=6, seed=5)
        for n in range(6):
            save_frame(str(tmp_path), f"f{n:03d}", {k: v[n] for k, v in raw.items()})
        data = str(tmp_path)
    args = train_det.parse_args(_tool_argv(tmp_path / "log", "--data", data, "--batch", "4"))
    whole = list(make_batches(args, CFG, split_seed=7, num_batches=2))
    shards = [list(make_batches(args, CFG, split_seed=7, num_batches=2, shard=(r, 2)))
              for r in range(2)]
    assert len(whole) == 2 and all(len(s) == 2 for s in shards)
    for bi, want in enumerate(whole):
        for r in range(2):
            assert sorted(shards[r][bi]) == sorted(want)
            for k, v in want.items():
                half = len(v) // 2  # the cache's second batch is its 2-frame tail
                np.testing.assert_array_equal(shards[r][bi][k], v[r * half:(r + 1) * half],
                                              err_msg=k)
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        next(make_batches(args, CFG, num_batches=1, shard=(0, 3)))


def test_average_raises_when_the_ranks_differ(ranks):
    assert [r["average_raises"] for r in ranks] == [True] * WORLD
