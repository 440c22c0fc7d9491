"""JAX checkpoints into the port (``convert_jax_checkpoint.py`` at the
repo root), on the CPU at the 64x64x8 grid and width_mult 0.25.

  * JAX's DetModule (disco, float32) takes 2 steps on ``train_det``'s
    synthetic batches of ``--batches_per_epoch 1`` (seeds 0 and 1000) and
    saves its TrainState as orbax ``epoch_0``; the converter writes the
    port's ``epoch_0``, whose weights, BatchNorm statistics, Adam moments
    and step count equal JAX's bit for bit;
  * the port's ``train_det.main([..., "--resume", <converted>])`` starts
    at step 2 and takes step 3 (epoch 2's batch, seed 2000); its loss
    equals JAX's float32 loss on that batch from its own checkpoint at
    tests/test_torch_train.py's rtol 1e-5;
  * that step in float64 (the converted checkpoint in a float64 port
    module, JAX's restored state in float64, plain execution) holds
    tests/test_torch_train.py's float64 rules: gradients at 1e-4 of a
    leaf's max, new parameters at 1e-8 where the gradient is clear and
    2 lr elsewhere, running statistics at 1e-5;
  * a converted upperbound checkpoint loads as the port's ``--teacher``
    (``restore_teacher``, and a ``train_det --kd_flag 1`` run);
  * a seg checkpoint converts alike, and a non-``epoch_<n>`` source is
    refused.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import convert_jax_checkpoint
from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from v2x_sim_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.train.det_module import TrainState
from v2x_sim_tpu.train.seg_module import SegModule as JaxSegModule
from v2x_sim_tpu_torch.bridge import flax_from_state_dict, model_key_map, random_flax_variables
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.tools import train_det
from v2x_sim_tpu_torch.train.checkpoint import restore_checkpoint, restore_teacher
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.train.seg_module import SegModule
from tests.test_torch_train import LR, _assert_adam_close, _assert_grads_close, _assert_tree_close
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

VOXEL = (1.0, 1.0, 0.625)
CFG = Config(grid=GridConfig(voxel_size=VOXEL))
JCFG = JaxConfig(grid=JaxGrid(voxel_size=VOXEL))
WIDTH = 0.25
SMALL = ["--grid", "small", "--width_mult", str(WIDTH)]


def _batch(seed):
    """``train_det``'s synthetic batch of seed ``seed`` (``--batch 2``)."""
    return generate_batch(CFG, SyntheticSpec(points_per_agent=2048), 2, seed=seed)


def _jax_state(jmod, variables):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return TrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                      jmod.tx.init(params), jnp.zeros((), jnp.int32))


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's 2 float32 steps saved as orbax epoch_0, and its converted copy."""
    root = tmp_path_factory.mktemp("ckpt")
    jmod = JaxDetModule(JCFG, mode="disco", learning_rate=LR, width_mult=WIDTH)
    state = _jax_state(jmod, random_flax_variables(DetModel(CFG, "disco", WIDTH), seed=2))
    for seed in (0, 1000):
        state, _ = jmod.train_step(state, jmod.prepare_batch(_batch(seed)))
    src = jax_save_checkpoint(str(root / "jax"), state, 0)
    out = convert_jax_checkpoint.main(["det", src, str(root / "port"), "--com", "disco"] + SMALL)
    return {"jmod": jmod, "state": jax.tree.map(np.asarray, state), "src": src, "out": out,
            "root": root}


def test_converted_checkpoint_equals_the_jax_state(jax_run):
    assert os.path.basename(jax_run["out"]) == "epoch_0"
    port = restore_checkpoint(jax_run["out"], DetModule(CFG, "disco", device="cpu", width_mult=WIDTH))
    state = jax_run["state"]
    assert port.step == int(state.step) == 2
    got = flax_from_state_dict(port.model.state_dict())
    for coll, want in (("params", state.params), ("batch_stats", state.batch_stats)):
        g, w = _leaves(got[coll]), _leaves(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    adam = state.opt_state[0]
    for slot, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = flax_from_state_dict({n: port.optimizer.state[p][slot]
                                    for n, p in port.model.named_parameters()})["params"]
        g, w = _leaves(got), _leaves(moment)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{slot} {k}")
    assert all(float(s["step"]) == 2.0 for s in port.optimizer.state.values())


def test_train_det_resumes_the_converted_run(jax_run, tmp_path):
    jmod, state = jax_run["jmod"], jax_restore_checkpoint(jax_run["src"], jax_run["state"])
    _, (_, jmet) = jmod.loss_fn(state.params, state.batch_stats, jmod.prepare_batch(_batch(2000)),
                                None, True)
    run = train_det.main(SMALL + ["--cpu", "--com", "disco", "--batch", "2", "--nepoch", "3",
                                  "--batches_per_epoch", "1", "--lr", str(LR),
                                  "--logpath", str(tmp_path), "--resume", jax_run["out"]])
    assert (run.start_epoch, run.start_step, run.step) == (2, 2, 3)
    np.testing.assert_allclose(float(run.metrics["loss"]), float(jmet["loss"]), rtol=1e-5)
    assert os.path.exists(tmp_path / "epoch_2")


def test_next_step_matches_jax_in_float64(jax_run):
    batch = _batch(2000)
    with jax.enable_x64(True):
        jmod = JaxDetModule(JCFG, mode="disco", compute_dtype=jnp.float64, learning_rate=LR,
                            width_mult=WIDTH)
        jmod.model = JaxDetModel(config=JCFG, mode="disco", dtype=jnp.float64, s2d=False,
                                 width_mult=WIDTH)
        jmod._blocked = jmod._occ_blocked = False
        state = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64)
                             if np.issubdtype(np.asarray(x).dtype, np.floating) else jnp.asarray(x),
                             jax_restore_checkpoint(jax_run["src"], jax_run["state"]))
        grad_fn = jax.jit(jax.value_and_grad(jmod.loss_fn, has_aux=True), static_argnums=(4,))
        (_, (stats, _)), grads = grad_fn(state.params, state.batch_stats, jmod.prepare_batch(batch),
                                         None, True)
        updates, _ = jmod.tx.update(grads, state.opt_state, state.params)
        new_params = jax.tree.map(lambda p, u: p + u, state.params, updates)
        grads, stats, new_params = jax.tree.map(np.asarray, (grads, stats, new_params))

    port = DetModule(CFG, "disco", torch.float64, device="cpu", learning_rate=LR, width_mult=WIDTH)
    port.model.double()
    restore_checkpoint(jax_run["out"], port)
    assert all(s["exp_avg"].dtype == torch.float64 for s in port.optimizer.state.values())
    port.train_step(port.prepare_batch(batch))
    new = flax_from_state_dict(port.model.state_dict())
    got_grads = flax_from_state_dict({n: p.grad for n, p in port.model.named_parameters()})
    _assert_grads_close(got_grads["params"], grads)
    _assert_adam_close(new["params"], new_params, grads)
    _assert_tree_close(new["batch_stats"], stats, rtol=1e-5, atol=1e-5)
    assert port.step == 3


def test_converted_upperbound_is_the_teacher(tmp_path):
    jmod = JaxDetModule(JCFG, mode="upperbound", width_mult=WIDTH)
    state = _jax_state(jmod, random_flax_variables(DetModel(CFG, "upperbound", WIDTH), seed=5))
    src = jax_save_checkpoint(str(tmp_path / "jax"), state, 4)
    out = convert_jax_checkpoint.main(["det", src, str(tmp_path / "port"), "--com", "upperbound"]
                                      + SMALL)
    student = DetModule(CFG, "disco", device="cpu", width_mult=WIDTH, kd_weight=1e5)
    restore_teacher(out, student)
    got = _leaves(flax_from_state_dict(student.teacher.state_dict(), "upperbound")["params"])
    want = _leaves(state.params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    run = train_det.main(SMALL + ["--cpu", "--com", "disco", "--batch", "2", "--nepoch", "1",
                                  "--batches_per_epoch", "1", "--kd_flag", "1", "--teacher", out,
                                  "--logpath", str(tmp_path / "kd")])
    assert run.step == 1 and np.isfinite(float(run.metrics["kd_loss"]))


def test_seg_checkpoint_converts_and_bad_sources_are_refused(tmp_path):
    port = SegModule(CFG, "disco", device="cpu", width_mult=WIDTH, depth=2)
    variables = random_flax_variables(port.model, seed=6)
    jmod = JaxSegModule(JCFG, mode="disco", width_mult=WIDTH, depth=2)
    src = jax_save_checkpoint(str(tmp_path / "jax"), _jax_state(jmod, variables), 1)
    out = convert_jax_checkpoint.main(["seg", src, str(tmp_path / "port"), "--com", "disco",
                                       "--depth", "2"] + SMALL)
    restore_checkpoint(out, port)
    got = _leaves(flax_from_state_dict(port.model.state_dict(), model_key_map(port.model)))
    want = _leaves(variables)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="epoch_<n>"):
        convert_jax_checkpoint.main(["seg", str(tmp_path / "jax"), str(tmp_path / "x")])
