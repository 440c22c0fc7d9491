"""bf16 against the JAX package at the DetModule level: one disco prepare
+ train step, without and with KD, on the CPU.

The same batch (64x64x8 grid, 6 agents, B=2, one padded agent) and the
same flax tree go through the port's ``DetModule(compute_dtype=
torch.bfloat16)`` and through JAX's ``DetModule`` in float32 and in
bfloat16, each in its plain (``s2d=False``) and its default
space-to-depth execution. The loss terms (``cls_loss``, ``loc_loss``,
``loss``, with KD ``kd_loss``) and every parameter after the Adam step
are held by the rules of tests/test_torch_bf16.py, with JAX's own bf16
error taken as the larger of its two executions' (a loss term is one sum,
so one execution's bf16 error is a single draw: disco's cls_loss moves
0.050 in the plain execution and 0.0013 in the s2d one):

  * rule 1: d(port bf16, JAX plain f32) <= 1.25 x own;
  * rule 2: d(port bf16, JAX plain bf16) <= max(own, d(JAX s2d bf16,
    JAX plain bf16)).

A parameter's Adam step is nearly lr * sign(g), so the parameters' max
distance is ~2 lr in every run (a gradient at rounding level flips
sign); their mean distance is the share of such flips.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.train.det_module import TrainState
from v2x_sim_tpu_torch.bridge import flax_from_state_dict, random_flax_variables
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.test_torch_bf16 import dist, hold_bf16
from tests.test_torch_train import CFG, JCFG
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

#: The CLI's KD weight, from a random upperbound teacher.
KD_WEIGHT = 1e5
EXECUTIONS = ("plain", "s2d")
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


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
def teacher():
    return random_flax_variables(DetModel(CFG, "upperbound"), seed=1)


def _flat_params(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(tree)])


def _jax_step(raw, variables, dtype, execution, kd_teacher=None):
    """One JAX prepare + train step: (metrics, new params flattened)."""
    kw = {"kd_weight": KD_WEIGHT} if kd_teacher is not None else {}
    jmod = JaxDetModule(JCFG, mode="disco", compute_dtype=dtype, **kw)
    if execution == "plain":
        jmod.model = JaxDetModel(config=JCFG, mode="disco", kd=bool(kw), s2d=False,
                                 dtype=None if dtype == jnp.float32 else dtype)
        jmod._blocked = jmod._occ_blocked = False
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       jmod.tx.init(params), jnp.zeros((), jnp.int32))
    args = () if kd_teacher is None else (jax.tree.map(jnp.asarray, kd_teacher),)
    new, metrics = jmod.train_step(state, jmod.prepare_batch(raw), *args)
    return {k: float(v) for k, v in metrics.items()}, _flat_params(new.params)


def _port_step(raw, variables, kd_teacher=None):
    kw = {"kd_weight": KD_WEIGHT} if kd_teacher is not None else {}
    port = DetModule(CFG, "disco", torch.bfloat16, device="cpu", **kw)
    port.load_flax_variables(variables)
    if kd_teacher is not None:
        port.load_teacher_flax_variables(kd_teacher)
    metrics = port.train_step(port.prepare_batch(raw))
    new = flax_from_state_dict(port.model.state_dict())["params"]
    return {k: float(v) for k, v in metrics.items()}, _flat_params(new)


@pytest.mark.parametrize("kd", [False, True], ids=["disco", "disco_kd"])
def test_bf16_train_step_within_jax_bf16_error(raw, variables, teacher, kd):
    t = teacher if kd else None
    jax_runs = {(e, d): _jax_step(raw, variables, dt, e, t)
                for e in EXECUTIONS for d, dt in DTYPES.items()}
    port = _port_step(raw, variables, t)
    keys = ["cls_loss", "loc_loss", "loss"] + (["kd_loss"] if kd else [])
    assert sorted(port[0]) == sorted(keys)
    for i, name in enumerate(keys + ["params after Adam"]):
        pick = (lambda run: run[0][name]) if i < len(keys) else (lambda run: run[1])
        f32, bf = pick(jax_runs["plain", "f32"]), pick(jax_runs["plain", "bf16"])
        own = tuple(max(a, b) for a, b in zip(
            dist(bf, f32), dist(pick(jax_runs["s2d", "bf16"]), pick(jax_runs["s2d", "f32"]))))
        hold_bf16(f"{'KD ' if kd else ''}{name}", pick(port), f32, own, bf,
                  dist(pick(jax_runs["s2d", "bf16"]), bf))
