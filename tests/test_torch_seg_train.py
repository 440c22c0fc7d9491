"""The port's SegModule training step, its loss and its metrics against
the JAX package on the CPU.

One float64 ``train_step`` from the same weights and Adam state on the
same synthetic scene (64x64x8 grid, 6 agents at their scene poses, one
padded agent whose labels are ignored) against the JAX SegModule
with its model's plain execution (``s2d=False``) in float64, at
width_mult 0.25, depth 2. The Adam state is optax's after one
step of this batch's gradient, loaded through
``bridge.adam_state_from_optax``. JAX's v2v gradient is taken op by op,
not under ``jit``: XLA's fusion of the jitted v2v step on the CPU moved
its fusion gradients by up to 4.2e-4 of a leaf's max against both the
op-by-op gradient and the port's (in float64 throughout, loss included),
which agree to 1e-7. (The other modes' jitted gradients agree with the
port's to 2e-7.) Tolerances are those of the det float64
steps (tests/test_torch_train.py): loss at rtol 1e-5 (both packages take
the cross-entropy of float32 logits), grads at atol 1e-4 x max|g| per
leaf, new params under the Adam rule there, new running stats at 1e-5.

Then the loss and the metrics on shared inputs: ``seg_cross_entropy_sum``
with ignored labels; the confusion matrix and IoU equal to JAX's
exactly, an absent class giving NaN.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from v2x_sim_tpu.models.seg.unet import SegModel as JaxSegModel
from v2x_sim_tpu.train.seg_module import SegModule as JaxSegModule
from v2x_sim_tpu.utils.losses import seg_cross_entropy as jax_seg_cross_entropy
from v2x_sim_tpu.utils.losses import seg_cross_entropy_sum as jax_seg_cross_entropy_sum
from v2x_sim_tpu.utils.seg_metrics import confusion_matrix as jax_confusion_matrix
from v2x_sim_tpu.utils.seg_metrics import iou_from_confusion as jax_iou_from_confusion
from v2x_sim_tpu_torch.bridge import adam_state_from_optax, flax_from_state_dict, model_key_map
from v2x_sim_tpu_torch.bridge import random_flax_variables
from v2x_sim_tpu_torch.train.seg_module import SegModule
from v2x_sim_tpu_torch.utils.losses import seg_cross_entropy, seg_cross_entropy_sum
from v2x_sim_tpu_torch.utils.seg_metrics import confusion_matrix, iou_from_confusion
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from tests.test_torch_train import (
    CFG,
    JCFG,
    LR,
    WIDTH_F64,
    _assert_adam_close,
    _assert_grads_close,
    _assert_tree_close,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

#: (mode, depth) of the float64 one-step cases.
STEP_CASES = {
    "lowerbound": ("lowerbound", 2),
    "upperbound": ("upperbound", 2),
    "disco": ("disco", 2),
    "cat": ("cat", 2),
    "when2com": ("when2com", 2),
    "v2v": ("v2v", 2),
}


@pytest.fixture(scope="module")
def scene():
    batch = generate_batch(CFG, SyntheticSpec(points_per_agent=2048), batch_size=1, seed=5)
    batch["agent_mask"][0, -1] = False  # one padded agent
    assert batch["agent_mask"].sum() >= 3 and (batch["seg_labels"] == 1).sum() > 100
    return batch


def _adam_state(grads):
    """optax's Adam state after one step of gradient ``grads``: count 1,
    moments 0.1 g and 0.001 g^2, rounded to float32 (what the bridge
    carries), in float64."""
    g32 = jax.tree.map(lambda g: np.asarray(g, np.float32), grads)
    to64 = lambda t: jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), t)  # noqa: E731
    mu = to64(jax.tree.map(lambda g: np.float32(0.1) * g, g32))
    nu = to64(jax.tree.map(lambda g: np.float32(0.001) * g * g, g32))
    state = optax.adam(LR).init(mu)
    return (state[0]._replace(count=jnp.asarray(1, jnp.int32), mu=mu, nu=nu), state[1])


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case, scene):
    mode, depth = STEP_CASES[case]
    port = SegModule(CFG, mode, torch.float64, device="cpu", learning_rate=LR,
                     width_mult=WIDTH_F64, depth=depth)
    port.model.double()
    variables = random_flax_variables(port.model, seed=11)
    with jax.enable_x64(True):
        jmod = JaxSegModule(JCFG, mode=mode, learning_rate=LR, compute_dtype=jnp.float64,
                            width_mult=WIDTH_F64, depth=depth)
        jmod.model = JaxSegModel(config=JCFG, mode=mode, dtype=jnp.float64, s2d=False,
                                 width_mult=WIDTH_F64, depth=depth)
        prep = jmod.prepare_batch(scene)
        v = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), variables)
        grad_fn = jax.value_and_grad(jmod.loss_fn, has_aux=True)
        if mode != "v2v":
            grad_fn = jax.jit(grad_fn, static_argnums=(3,))
        (_, (jstats, jmet)), jgrads = grad_fn(v["params"], v["batch_stats"], prep, True)
        opt = _adam_state(jgrads)
        updates, _ = jmod.tx.update(jgrads, opt, v["params"])
        jparams = optax.apply_updates(v["params"], updates)
        jmet, jgrads, jstats, jparams = jax.tree.map(np.asarray, (jmet, jgrads, jstats, jparams))

    port.load_flax_variables(variables)
    adam_state_from_optax(opt, port)
    met = port.train_step(port.prepare_batch(scene))
    assert sorted(met) == ["loss"]
    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-5)
    kmap = model_key_map(port.model)
    grads = flax_from_state_dict({n: p.grad for n, p in port.model.named_parameters()}, kmap)
    _assert_grads_close(grads["params"], jgrads)
    new = flax_from_state_dict(port.model.state_dict(), kmap)
    _assert_adam_close(new["params"], jparams, jgrads)
    _assert_tree_close(new["batch_stats"], jstats, rtol=1e-5, atol=1e-5)
    assert port.step == 1


def _pred_and_labels(seed=0, c=8):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, c, (2, 3, 16, 16))
    labels[labels == 5] = 4  # class 5 appears in neither labels ...
    pred = rng.integers(0, c, labels.shape)
    pred[pred == 5] = 6  # ... nor predictions
    return pred, labels


def test_seg_cross_entropy_ignores_negative_labels():
    rng = np.random.default_rng(1)
    _, labels = _pred_and_labels(seed=1)
    logits = rng.normal(0, 3, labels.shape + (8,)).astype(np.float32)
    total, n = seg_cross_entropy_sum(torch.from_numpy(logits), torch.from_numpy(labels), 8)
    jtotal, jn = jax_seg_cross_entropy_sum(jnp.asarray(logits), jnp.asarray(labels), 8)
    assert n.item() == float(jn) == float((labels >= 0).sum())
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-6)
    mean = seg_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 8)
    np.testing.assert_allclose(mean.item(), float(jax_seg_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), 8)), rtol=1e-6)
    # Ignored pixels contribute nothing, whatever their logits.
    logits[labels < 0] = 1e4
    again, _ = seg_cross_entropy_sum(torch.from_numpy(logits), torch.from_numpy(labels), 8)
    assert again.item() == total.item()
    none, zero = seg_cross_entropy_sum(torch.from_numpy(logits), torch.full(labels.shape, -1), 8)
    assert none.item() == 0.0 and zero.item() == 0.0
    assert seg_cross_entropy(torch.from_numpy(logits), torch.full(labels.shape, -1), 8).item() == 0.0


def test_confusion_and_iou_equal_jax():
    pred, labels = _pred_and_labels()
    cm = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(labels), 8)
    want = np.asarray(jax_confusion_matrix(jnp.asarray(pred), jnp.asarray(labels), 8))
    assert cm.dtype == torch.int64
    np.testing.assert_array_equal(cm.numpy(), want)
    assert cm.sum().item() == (labels >= 0).sum()
    got, jgot = iou_from_confusion(cm.numpy()), jax_iou_from_confusion(want)
    assert list(got) == list(jgot) == [f"iou_class{i}" for i in range(8)] + ["miou"]
    assert np.isnan(got["iou_class5"]) and np.isnan(jgot["iou_class5"])
    for key in jgot:
        np.testing.assert_equal(got[key], jgot[key])  # NaN equals NaN here
    assert np.isfinite(got["miou"])
