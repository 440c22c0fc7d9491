"""The port's training losses (utils/losses.py) against the JAX package's
on the same numpy inputs, at rtol 1e-6: float32 sums of at most ~1,500
terms, summed in another order (larger same-sign sums drift apart by more
in float32 on their own)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.utils import losses as jax_losses
from v2x_sim_tpu_torch.utils import losses
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

RTOL = 1e-6


def _check(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.item(), float(w), rtol=RTOL)


@pytest.mark.parametrize(
    "shape, c",
    [((2, 3, 4, 4, 6), 2), ((50, 6), 2), ((2, 3, 4, 4, 6), 3)],
    ids=["binary-path", "binary-low-rank", "general-path"],
)
def test_focal_loss_matches_jax(shape, c):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, shape + (c,)).astype(np.float32)
    labels = rng.integers(-1, c, shape).astype(np.int8)
    want = jax_losses.softmax_focal_loss_sum(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.softmax_focal_loss_sum(torch.from_numpy(logits), torch.from_numpy(labels))
    _check(got, want)


def test_focal_loss_sums_bf16_logits_in_float32():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(0, 2, (4, 64, 6, 2)).astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.integers(-1, 2, (4, 64, 6)).astype(np.int8))
    got = losses.softmax_focal_loss_sum(logits, labels)
    want = losses.softmax_focal_loss_sum(logits.float(), labels)
    _check(got, [w.item() for w in want])


@pytest.mark.parametrize("shape", [(2, 3, 5, 6), (40, 6)], ids=["folded", "low-rank"])
def test_smooth_l1_matches_jax(shape):
    rng = np.random.default_rng(2)
    pred = rng.normal(0, 1.5, shape).astype(np.float32)
    target = rng.normal(0, 1.5, shape).astype(np.float32)
    mask = (rng.random(shape[:-1]) < 0.4).astype(np.float32)
    want = jax_losses.smooth_l1_loss_sum(*(jnp.asarray(x) for x in (pred, target, mask)))
    got = losses.smooth_l1_loss_sum(*(torch.from_numpy(x) for x in (pred, target, mask)))
    _check(got, want)


def test_sparse_smooth_l1_matches_jax():
    rng = np.random.default_rng(3)
    b, a, r, k, code, p = 2, 3, 40, 6, 6, 24
    pred = rng.normal(0, 1.5, (b, a, r, k * code)).astype(np.float32)
    cell = rng.integers(0, r, (b, a, p)).astype(np.int32)
    lane = rng.integers(0, k, (b, a, p)).astype(np.int32)
    target = rng.normal(0, 1.5, (b, a, p, code)).astype(np.float32)
    weight = (rng.random((b, a, p)) < 0.6).astype(np.float32)
    args = (pred, cell, lane, target, weight)
    want = jax_losses.smooth_l1_loss_sparse_sum(*(jnp.asarray(x) for x in args))
    got = losses.smooth_l1_loss_sparse_sum(*(torch.from_numpy(x) for x in args))
    _check(got, want)


def test_kd_mse_matches_jax():
    rng = np.random.default_rng(4)
    s = rng.normal(size=(2, 3, 4, 4, 8)).astype(np.float32)
    t = rng.normal(size=(2, 3, 4, 4, 8)).astype(np.float32)
    want = jax_losses.kd_mse_loss_sum(jnp.asarray(s), jnp.asarray(t))
    got = losses.kd_mse_loss_sum(torch.from_numpy(s), torch.from_numpy(t))
    _check(got, want)
