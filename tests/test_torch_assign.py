"""The port's sparse anchor assignment (ops/assign.py) against the JAX
package's ``assign_targets_batched(flat="sparse")``, both on the CPU
(the JAX side through its XLA IoU, the port's through the plain version
of the CUDA kernel).

Tolerances: labels equal except at anchors whose IoU lies within 1e-5 of
a threshold (the two IoU implementations round differently, ~1e-7);
``cells``, ``wts`` and ``overflow`` exactly equal; ``reg`` within 1e-5;
IoU within 1e-5, as tests/test_torch_iou.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.ops import assign as jax_assign
from v2x_sim_tpu.ops.iou_sh import rotated_iou_pairs_soa_periodic_auto
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.ops import assign, iou_sh
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

NEAR = 1e-5


def _configs(voxel):
    return Config(grid=GridConfig(voxel_size=voxel)), JaxConfig(grid=JaxGrid(voxel_size=voxel))


def _gt(rng, b, m, n_valid, spread=28.0):
    gt = np.stack(
        [
            rng.uniform(-spread, spread, (b, m)),
            rng.uniform(-spread, spread, (b, m)),
            rng.uniform(3.8, 5.0, (b, m)),
            rng.uniform(1.6, 2.1, (b, m)),
            rng.uniform(-np.pi, np.pi, (b, m)),
        ],
        -1,
    ).astype(np.float32)
    mask = np.zeros((b, m), bool)
    for i, k in enumerate(n_valid):
        mask[i, :k] = True
    gt[~mask] = 0.0  # padded GT as the loaders write it
    return gt, mask


def _compare(cfg, jcfg, gt, mask):
    want = jax_assign.assign_targets_batched(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(anchor_grid(cfg)), jcfg, flat="sparse")
    got = assign.assign_targets_batched(
        torch.from_numpy(gt), torch.from_numpy(mask), torch.from_numpy(anchor_grid(cfg)), cfg, flat="sparse")
    thr = (cfg.anchors.neg_iou_threshold, cfg.anchors.pos_iou_threshold)
    iou = got.iou.numpy()
    near = np.zeros(iou.shape, bool)
    for t in thr:
        near |= np.abs(iou - t) <= NEAR
    lab_w, lab_g = np.asarray(want.labels), got.labels.numpy()
    assert ((lab_w != lab_g) <= near).all()
    assert (lab_w != lab_g).sum() <= near.sum()
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))
    np.testing.assert_array_equal(got.wts.numpy(), np.asarray(want.wts))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    np.testing.assert_allclose(got.reg.numpy(), np.asarray(want.reg), atol=1e-5, rtol=0)
    assert got.labels.dtype == torch.int8 and got.reg.shape == tuple(want.reg.shape)
    return got, want


def test_sparse_assignment_matches_jax_coarse_grid_with_all_masked_row():
    cfg, jcfg = _configs((1.0, 1.0, 0.625))  # 64x64x8, capacity 256
    gt, mask = _gt(np.random.default_rng(0), b=3, m=16, n_valid=(12, 5, 0))
    got, _ = _compare(cfg, jcfg, gt, mask)
    lab = got.labels.numpy()
    assert (lab[:2] == 1).sum() >= 17  # every valid GT has a positive
    assert (lab[2] == 0).all()  # no GT: all background, nothing forced
    np.testing.assert_array_equal(got.cells[2].numpy(), np.arange(256))


def test_sparse_assignment_matches_jax_with_overflow():
    """Dense scenes on the coarse grid overflow the 256-cell capacity:
    the demoted positives and the kept cells must match exactly."""
    cfg, jcfg = _configs((1.0, 1.0, 0.625))
    gt, mask = _gt(np.random.default_rng(1), b=2, m=96, n_valid=(96, 40), spread=30.0)
    got, want = _compare(cfg, jcfg, gt, mask)
    assert int(np.asarray(want.overflow)[0]) > 0
    lab = got.labels.numpy()
    k = cfg.anchors.num_anchors
    lanes = (got.cells.numpy()[..., None] * k + np.arange(k)).reshape(2, -1)
    supervised = np.zeros(lab.shape, bool)
    np.put_along_axis(supervised, lanes, got.wts.numpy() > 0, axis=1)
    assert ((lab == 1) <= supervised).all()  # every positive has a target


def test_sparse_assignment_matches_jax_production_grid():
    """256x256x6 anchors at 0.25 m, one agent-scene (as tests/test_assign.py)."""
    cfg, jcfg = _configs((0.25, 0.25, 0.4))
    gt, mask = _gt(np.random.default_rng(2), b=1, m=12, n_valid=(12,))
    got, _ = _compare(cfg, jcfg, gt, mask)
    assert assign.sparse_cell_capacity(cfg) == 1024
    assert (got.labels.numpy() == 1).sum() > 100


def test_labels_from_sparse_idx_matches_jax():
    rng = np.random.default_rng(3)
    n = 500
    pos = rng.integers(0, n + 1, (2, 3, 40)).astype(np.int32)  # n = padding
    ign = rng.integers(0, n + 1, (2, 3, 60)).astype(np.int32)
    ign[0, 0, :5] = pos[0, 0, :5]  # in both lists: positive wins
    want = jax_assign.labels_from_sparse_idx(jnp.asarray(pos), jnp.asarray(ign), n)
    got = assign.labels_from_sparse_idx(torch.from_numpy(pos), torch.from_numpy(ign), n)
    assert got.dtype == torch.int8 and got.shape == (2, 3, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n, reps", [(128, 5), (1000, 3)])
def test_plain_periodic_iou_matches_jax(n, reps):
    rng = np.random.default_rng(n)
    anchors = np.stack(
        [rng.uniform(-5, 5, n), rng.uniform(-5, 5, n), rng.uniform(1, 5, n),
         rng.uniform(0.8, 3, n), rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)
    boxes = (np.tile(anchors, (1, reps)) + rng.normal(0, 0.7, (5, n * reps))).astype(np.float32)
    boxes[2:4] = np.abs(boxes[2:4]) + 0.5
    want = np.asarray(rotated_iou_pairs_soa_periodic_auto(jnp.asarray(anchors), jnp.asarray(boxes)))
    got = iou_sh.rotated_iou_pairs_soa_periodic(torch.from_numpy(anchors), torch.from_numpy(boxes))
    assert (want > 0.1).mean() > 0.3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        iou_sh.rotated_iou_pairs_soa_periodic(torch.from_numpy(anchors), torch.from_numpy(boxes[:, 1:]))
