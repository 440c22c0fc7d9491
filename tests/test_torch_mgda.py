"""MGDA against the JAX package on the CPU.

  * ``utils/mgda.py``: ``min_norm_weights`` for one, two and three tasks
    (three with a tie in the Frank-Wolfe argmin, which both packages break
    toward the first index) and ``mgda_grads`` on seeded float64 task
    gradients: weights and combined gradients within 1e-12.
  * ``DetModule(mgda=True)`` with KD (kd_weight 1e5, a random upperbound
    teacher): one float64 step against the JAX ``_train_step_mgda_impl``
    on the plain execution, from the same weights and batch as
    tests/test_torch_train.py. The task weights ``mgda_w_*`` within 1e-6
    (they sum to 1); the losses at rtol 1e-5; Adam's first moment (0.1 x
    the combined gradient) and the square root of its second moment under
    that file's gradient rule (atol 1e-4 x max per leaf); new params under
    its Adam rule; BatchNorm running stats (updated once, as JAX's) at rtol
    1e-5. Every parameter has Adam state after the step, the heads' convs
    that only one task's loss reaches included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.models.det.net import TeacherModel as JaxTeacherModel
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.train.det_module import TrainState as JaxTrainState
from v2x_sim_tpu.utils import mgda as jmgda
from v2x_sim_tpu_torch.bridge import flax_from_state_dict, random_flax_variables
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.utils import mgda
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

KD_WEIGHT = 1e5


def _gram(t, seed):
    g = np.random.default_rng(seed).normal(size=(t, 7))
    return g @ g.T


@pytest.mark.parametrize("case", ["t1", "t2", "t2_clipped", "t3", "t3_tie"])
def test_min_norm_weights_match_jax(case):
    if case == "t1":
        gram = _gram(1, 0)
    elif case == "t2":
        gram = _gram(2, 1)
    elif case == "t2_clipped":  # one gradient inside the other's half-space: gamma clips to 1
        gram = np.array([[1.0, 2.0], [2.0, 9.0]])
    elif case == "t3":
        gram = _gram(3, 2)
    else:  # orthonormal gradients: every vertex ties at each Frank-Wolfe step
        gram = np.eye(3)
    with jax.enable_x64(True):
        want = np.asarray(jmgda.min_norm_weights(jnp.asarray(gram)))
    got = mgda.min_norm_weights(torch.from_numpy(gram)).numpy()
    assert got.shape == want.shape == (len(gram),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-12)
    assert (got >= 0).all()
    if case == "t2_clipped":
        np.testing.assert_array_equal(got, [1.0, 0.0])


@pytest.mark.parametrize("tasks", [2, 3])
def test_mgda_grads_match_jax(tasks):
    rng = np.random.default_rng(tasks)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    grads = [[rng.normal(scale=10.0 ** i, size=s) for s in shapes] for i in range(tasks)]
    with jax.enable_x64(True):
        jtrees = [{f"p{j}": jnp.asarray(g) for j, g in enumerate(task)} for task in grads]
        jcomb, jw = jmgda.mgda_grads(jtrees)
        jcomb, jw = {k: np.asarray(v) for k, v in jcomb.items()}, np.asarray(jw)
    comb, w = mgda.mgda_grads([[torch.from_numpy(g) for g in task] for task in grads])
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-12)
    for j, c in enumerate(comb):
        np.testing.assert_allclose(c.numpy(), jcomb[f"p{j}"], rtol=0, atol=1e-12)
    gram = mgda.gram_matrix([[torch.from_numpy(g) for g in task] for task in grads]).numpy()
    flat = np.stack([np.concatenate([g.ravel() for g in task]) for task in grads])
    np.testing.assert_allclose(gram, flat @ flat.T, rtol=1e-12)


@pytest.fixture(scope="module")
def jax_mgda_step(raw):
    """One float64 MGDA step of the JAX plain execution with KD."""
    variables = random_flax_variables(DetModel(CFG, "disco", WIDTH_F64, kd=True), seed=8)
    teacher = random_flax_variables(DetModel(CFG, "upperbound", WIDTH_F64), seed=9)
    with jax.enable_x64(True):
        jmod = JaxDetModule(JCFG, mode="disco", compute_dtype=jnp.float64, width_mult=WIDTH_F64,
                            learning_rate=LR, kd_weight=KD_WEIGHT, mgda=True)
        jmod.model = JaxDetModel(config=JCFG, mode="disco", dtype=jnp.float64, s2d=False,
                                 width_mult=WIDTH_F64, kd=True)
        jmod.teacher = JaxTeacherModel(config=JCFG, dtype=jnp.float64, s2d=False,
                                       width_mult=WIDTH_F64)
        jmod._blocked = jmod._occ_blocked = False
        prep = jax.jit(jmod.prepare_batch)(raw)
        v, t = (jax.tree.map(lambda x: np.asarray(x, np.float64), tree) for tree in (variables, teacher))
        state = JaxTrainState(v["params"], v["batch_stats"], jmod.tx.init(v["params"]),
                              jnp.zeros((), jnp.int32))
        new, met = jax.jit(jmod._train_step_mgda_impl)(state, prep, t)
        adam = next(s for s in jax.tree.leaves(new.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                    if hasattr(s, "mu"))
        return jax.tree.map(np.asarray, {
            "variables": variables, "teacher": teacher, "met": met, "params": new.params,
            "stats": new.batch_stats, "mu": adam.mu, "nu": adam.nu, "count": adam.count})


def test_mgda_kd_float64_step_matches_jax(raw, jax_mgda_step):
    want = jax_mgda_step
    port = DetModule(CFG, "disco", torch.float64, device="cpu", learning_rate=LR,
                     width_mult=WIDTH_F64, kd_weight=KD_WEIGHT, mgda=True)
    port.model.double()
    port.load_flax_variables(want["variables"])
    port.load_teacher_flax_variables(want["teacher"])
    met = port.train_step(port.prepare_batch(raw))

    keys = ("mgda_w_cls_loss", "mgda_w_loc_loss", "mgda_w_kd_loss")
    assert sorted(met) == sorted(want["met"]) and set(keys) <= set(met)
    for key in keys:
        np.testing.assert_allclose(met[key].item(), float(want["met"][key]), rtol=0, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(sum(met[k].item() for k in keys), 1.0, atol=1e-12)
    assert min(met[k].item() for k in keys) > 0.01  # every task takes part
    for key in ("cls_loss", "loc_loss", "kd_loss", "loss"):
        np.testing.assert_allclose(met[key].item(), float(want["met"][key]), rtol=1e-5, err_msg=key)

    named = dict(port.model.named_parameters())
    state = {n: port.optimizer.state[p] for n, p in named.items()}
    assert all(float(s["step"]) == 1.0 for s in state.values()) and int(want["count"]) == 1
    mu = flax_from_state_dict({n: s["exp_avg"] for n, s in state.items()}, "disco")["params"]
    _assert_grads_close(mu, want["mu"])
    root = lambda nu: jax.tree.map(lambda x: np.sqrt(np.asarray(x) / (1 - 0.999)), nu)
    nu = flax_from_state_dict({n: s["exp_avg_sq"] for n, s in state.items()}, "disco")["params"]
    _assert_grads_close(root(nu), root(want["nu"]))
    combined = jax.tree.map(lambda m: m / (1 - 0.9), want["mu"])
    new = flax_from_state_dict(port.model.state_dict(), "disco")
    _assert_adam_close(new["params"], want["params"], combined)
    _assert_tree_close(new["batch_stats"], want["stats"], rtol=1e-5, atol=1e-5)

    # Parameters one task alone reaches get their combined gradient too.
    for name in ("reg_head.conv2.weight", "cls_head.conv2.weight"):
        assert named[name].grad.abs().max() > 0, name
