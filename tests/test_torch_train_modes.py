"""The training step of every other collaboration mode, and DiscoNet's
KD, against the JAX DetModule on the CPU: one float64 step from the same
weights on the same batch as tests/test_torch_train.py (whose fixtures
and comparison rules this file reuses; it lives apart so the two halves
run on two test workers).

Against the JAX model's plain execution at width_mult 0.25: v2v with its
message GroupNorm, when2com (training attention), cat and max; and disco
with KD at the CLI's kd_weight 1e5 from a random upperbound teacher,
under both kd_reduce rules. Loss and its terms at rtol 1e-5 (both
packages sum the losses in float32, even in a float64 run, and the KD
term squares differences of two float32-rounded maps: it reads 3e-6
apart); grads at atol 1e-4 x max|g| per leaf, as in
tests/test_torch_train.py. Then every mode's tree through both bridge
directions and optax's Adam state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from v2x_sim_tpu.models.det.net import DetModel as JaxDetModel
from v2x_sim_tpu.models.det.net import TeacherModel as JaxTeacherModel
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu_torch.bridge import (
    adam_state_from_optax,
    flax_from_state_dict,
    random_flax_variables,
    state_dict_from_flax,
)
from v2x_sim_tpu_torch.models.det.net import MODES, DetModel
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.test_torch_train import (  # noqa: F401  (raw is a fixture)
    CFG,
    JCFG,
    LR,
    WIDTH_F64,
    _assert_grads_close,
    _leaves,
    raw,
)
from tests.test_torch_model import _jax_kw
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

#: (mode, DetModule options) of the float64 one-step cases beyond disco.
MODE_CASES = {
    "v2v_msg_norm": ("v2v", {"fusion": {"msg_norm": True}}),
    "when2com": ("when2com", {}),
    "cat": ("cat", {}),
    "max": ("max", {}),
    "disco_kd_mean": ("disco", {"kd_weight": 1e5, "kd_reduce": "mean"}),
    "disco_kd_pos": ("disco", {"kd_weight": 1e5, "kd_reduce": "pos"}),
}


@pytest.mark.parametrize("case", list(MODE_CASES))
def test_mode_step_loss_and_grads_match_jax(case, raw):
    mode, opts = MODE_CASES[case]
    fusion = opts.get("fusion", {})
    jax_model_opts = _jax_kw(fusion)
    jax_opts = {**{k: v for k, v in opts.items() if k != "fusion"}, **jax_model_opts}
    kd = opts.get("kd_weight", 0.0) > 0.0
    variables = random_flax_variables(DetModel(CFG, mode, WIDTH_F64, fusion=fusion), seed=3)
    teacher = random_flax_variables(DetModel(CFG, "upperbound", WIDTH_F64), seed=4) if kd else None
    with jax.enable_x64(True):
        jmod = JaxDetModule(JCFG, mode=mode, compute_dtype=jnp.float64, width_mult=WIDTH_F64, **jax_opts)
        jmod.model = JaxDetModel(config=JCFG, mode=mode, dtype=jnp.float64, s2d=False,
                                 width_mult=WIDTH_F64, kd=kd, **jax_model_opts)
        jmod.teacher = JaxTeacherModel(config=JCFG, dtype=jnp.float64, s2d=False,
                                       width_mult=WIDTH_F64)
        jmod._blocked = jmod._occ_blocked = False
        prep = jmod.prepare_batch(raw)
        v = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
        t = None if teacher is None else jax.tree.map(lambda x: np.asarray(x, np.float64), teacher)
        grad_fn = jax.jit(jax.value_and_grad(jmod.loss_fn, has_aux=True), static_argnums=(4,))
        (_, (_, jmet)), jgrads = grad_fn(v["params"], v["batch_stats"], prep, t, True)
        jmet, jgrads = jax.tree.map(np.asarray, (jmet, jgrads))

    port = DetModule(CFG, mode, torch.float64, device="cpu", width_mult=WIDTH_F64, **opts)
    port.model.double()
    port.load_flax_variables(variables)
    if kd:
        port.load_teacher_flax_variables(teacher)
        assert next(port.teacher.parameters()).dtype == torch.float64
    met = port.train_step(port.prepare_batch(raw))
    assert sorted(met) == sorted(jmet) and ("kd_loss" in met) == kd
    for key, want in jmet.items():
        np.testing.assert_allclose(met[key].item(), float(want), rtol=1e-5, err_msg=key)
    grads = flax_from_state_dict({n: p.grad for n, p in port.model.named_parameters()}, mode)
    _assert_grads_close(grads["params"], jgrads)


@pytest.mark.parametrize("mode", MODES)
def test_bridge_and_adam_state_every_mode(mode):
    """Every mode's tree (Dense kernels, attn_w without a bias, v2v's
    GroupNorm without running stats) round-trips through both bridge
    directions, and optax's Adam moments over it load into the port's
    optimizer in the port's layout."""
    opts = {"fusion": {"msg_norm": True}} if mode == "v2v" else {}
    port = DetModule(CFG, mode, device="cpu", width_mult=WIDTH_F64, **opts)
    variables = random_flax_variables(port.model, seed=5)
    back = flax_from_state_dict(state_dict_from_flax(variables, mode), mode)
    got, want = _leaves(back), _leaves(variables)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    params = jax.tree.map(jnp.asarray, variables["params"])
    adam = optax.adam(LR).init(params)[0]._replace(
        count=jnp.asarray(3), mu=params, nu=jax.tree.map(lambda x: 2.0 * x, params))
    adam_state_from_optax((adam,), port)
    sd = state_dict_from_flax(variables, mode)
    for name, p in port.model.named_parameters():
        state = port.optimizer.state[p]
        assert float(state["step"]) == 3.0
        np.testing.assert_array_equal(state["exp_avg"].numpy(), sd[name].numpy(), err_msg=name)
        np.testing.assert_allclose(state["exp_avg_sq"].numpy(), 2.0 * sd[name].numpy(), err_msg=name)
