"""The port's dense and flat anchor-target layouts (``ops/assign.py``
``assign_targets_batched(flat=False | True)``, ``assign_targets``,
``DetModule.targets_from_gt(flat=)``) and the losses' normalized
wrappers, against the JAX package on the CPU (the JAX side through its
XLA IoU, the port's through the plain version of the CUDA kernel).

Tolerances: labels and reg_mask exactly equal; reg_targets within 1e-6;
best_iou within 2e-5. The IoU twin and JAX's IoU clip in different
orders, in float32 at coordinates up to 30 m, and differ by up to
1.19e-5 on these scenes; no label of these scenes lies that near a
threshold, so the labels are held exactly. The dense smooth-L1 sum equals the sparse
one at the same predictions (JAX's tests/test_losses.py holds its own
two alike).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.ops import assign as jax_assign
from v2x_sim_tpu.train.det_module import DetModule as JaxDetModule
from v2x_sim_tpu.utils import losses as jax_losses
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.ops import assign
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.utils import losses
from tests.test_torch_assign import _configs, _gt
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

COARSE = (1.0, 1.0, 0.625)  # 64x64x8, 6 anchors a cell
FINE = (0.25, 0.25, 0.4)  # the production 256x256 grid
#: (voxel, seed, B, M, valid GT per row, spread): an all-masked row, a
#: scene dense enough to overflow the sparse capacity, the production grid.
CASES = {
    "coarse_all_masked_row": (COARSE, 0, 3, 16, (12, 5, 0), 28.0),
    "coarse_crowded": (COARSE, 1, 2, 96, (96, 40), 30.0),
    "production_grid": (FINE, 2, 1, 12, (12,), 28.0),
}


def _hold(got, want):
    """AnchorTargets field by field under the module docstring's rule."""
    assert got.labels.dtype == torch.int32 and got.reg_targets.dtype == torch.float32
    for name in ("labels", "reg_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.reg_targets.numpy(), np.asarray(want.reg_targets), atol=1e-6,
                               rtol=0, err_msg="reg_targets")
    np.testing.assert_allclose(got.best_iou.numpy(), np.asarray(want.best_iou), atol=2e-5, rtol=0,
                               err_msg="best_iou")


@pytest.mark.parametrize("flat", [False, True], ids=["dense", "flat"])
@pytest.mark.parametrize("case", list(CASES))
def test_layout_matches_jax(case, flat):
    voxel, seed, b, m, n_valid, spread = CASES[case]
    cfg, jcfg = _configs(voxel)
    gt, mask = _gt(np.random.default_rng(seed), b, m, n_valid, spread)
    anchors = anchor_grid(cfg)
    want = jax_assign.assign_targets_batched(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(anchors), jcfg, flat=flat)
    got = assign.assign_targets_batched(
        torch.from_numpy(gt), torch.from_numpy(mask), torch.from_numpy(anchors), cfg, flat=flat)
    h, w = cfg.grid.bev_shape
    k = cfg.anchors.num_anchors
    lead = (b, h * w * k) if flat else (b, h, w, k)
    assert tuple(got.labels.shape) == lead and tuple(got.reg_mask.shape) == lead
    assert tuple(got.reg_targets.shape) == ((b, 6, h * w * k) if flat else lead + (6,))
    _hold(got, want)
    # The sparse layout's labels are the dense ones, bar positives demoted
    # for want of capacity.
    sp = assign.assign_targets_batched(
        torch.from_numpy(gt), torch.from_numpy(mask), torch.from_numpy(anchors), cfg, flat="sparse")
    dense = got.labels.reshape(b, -1)
    kept = sp.labels.to(torch.int32) == dense
    assert bool((kept | ((dense == 1) & (sp.labels == -1))).all())
    assert bool(kept.all()) == (int(sp.overflow.sum()) == 0)


def test_assign_targets_single_sample_matches_jax():
    cfg, jcfg = _configs(COARSE)
    gt, mask = _gt(np.random.default_rng(4), 1, 10, (7,))
    anchors = anchor_grid(cfg)
    want = jax_assign.assign_targets(jnp.asarray(gt[0]), jnp.asarray(mask[0]), jnp.asarray(anchors), jcfg)
    got = assign.assign_targets(torch.from_numpy(gt[0]), torch.from_numpy(mask[0]),
                                torch.from_numpy(anchors), cfg)
    assert tuple(got.reg_targets.shape) == anchors.shape[:3] + (6,)
    _hold(got, want)
    with pytest.raises(ValueError, match="flat"):
        assign.assign_targets_batched(torch.from_numpy(gt), torch.from_numpy(mask),
                                      torch.from_numpy(anchors), cfg, flat="dense")


@pytest.fixture(scope="module")
def batch():
    cfg = Config(grid=GridConfig(voxel_size=COARSE))
    spec = SyntheticSpec(num_vehicles=5, points_per_agent=256, max_gt=8, points_per_vehicle=16)
    return generate_batch(cfg, spec, batch_size=2, seed=11)


@pytest.mark.parametrize("flat", [False, True], ids=["dense", "flat"])
def test_module_targets_from_gt_matches_jax(batch, flat):
    cfg, jcfg = _configs(COARSE)
    want = JaxDetModule(jcfg, mode="lowerbound").targets_from_gt(
        jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["gt_mask"]), flat=flat)
    port = DetModule(cfg, "lowerbound", device="cpu")
    got = port.targets_from_gt(torch.from_numpy(batch["gt_boxes"]), torch.from_numpy(batch["gt_mask"]),
                               flat=flat)
    assert isinstance(got, assign.AnchorTargets) and got.labels.shape[:2] == (2, cfg.num_agents)
    _hold(got, want)


def test_dense_loss_equals_sparse_loss(batch):
    """The dense smooth-L1 over every anchor equals the sparse one at the
    positive cells, on the same random predictions."""
    cfg = Config(grid=GridConfig(voxel_size=COARSE))
    port = DetModule(cfg, "lowerbound", device="cpu")
    gt, gt_mask = torch.from_numpy(batch["gt_boxes"]), torch.from_numpy(batch["gt_mask"])
    full = port.targets_from_gt(gt, gt_mask)
    prep = port.targets({"gt_boxes": gt, "gt_mask": gt_mask})
    assert float(prep["reg_sp_w"].sum()) > 0 and int(prep["overflow"].sum()) == 0
    b, a, h, w, k = full.labels.shape
    pred = torch.from_numpy(np.random.default_rng(0).normal(0, 0.2, (b, a, h, w, k, 6)).astype(np.float32))
    dense_sum, dense_n = losses.smooth_l1_loss_sum(pred, full.reg_targets, full.reg_mask)
    sp_sum, sp_n = losses.smooth_l1_loss_sparse_sum(
        pred.reshape(b, a, h * w, k * 6), prep["reg_cell"], prep["reg_lane"], prep["reg_sp_t"],
        prep["reg_sp_w"])
    assert float(dense_n) == float(sp_n) > 0
    np.testing.assert_allclose(float(sp_sum), float(dense_sum), rtol=1e-5)
    np.testing.assert_allclose(float(losses.smooth_l1_loss(pred, full.reg_targets, full.reg_mask)),
                               float(dense_sum) / float(dense_n), rtol=1e-6)


def test_normalized_loss_wrappers_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (2, 3, 8, 8, 6, 2)).astype(np.float32)
    labels = rng.integers(-1, 2, (2, 3, 8, 8, 6)).astype(np.int32)
    pred = rng.normal(0, 1, (2, 3, 8, 8, 6, 6)).astype(np.float32)
    target = rng.normal(0, 1, pred.shape).astype(np.float32)
    mask = (rng.random(labels.shape) < 0.1).astype(np.float32)
    feat = rng.normal(0, 1, (2, 3, 4, 4, 16)).astype(np.float32)
    teacher = rng.normal(0, 1, feat.shape).astype(np.float32)
    seg_logits = rng.normal(0, 1, (2, 8, 8, 5)).astype(np.float32)
    seg_labels = rng.integers(-1, 5, (2, 8, 8)).astype(np.int32)
    t = torch.from_numpy
    pairs = {
        "softmax_focal_loss": (losses.softmax_focal_loss(t(logits), t(labels)),
                               jax_losses.softmax_focal_loss(jnp.asarray(logits), jnp.asarray(labels))),
        "smooth_l1_loss": (losses.smooth_l1_loss(t(pred), t(target), t(mask)),
                           jax_losses.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))),
        "kd_mse_loss": (losses.kd_mse_loss(t(feat), t(teacher)),
                        jax_losses.kd_mse_loss(jnp.asarray(feat), jnp.asarray(teacher))),
        "seg_cross_entropy": (losses.seg_cross_entropy(t(seg_logits), t(seg_labels), 5),
                              jax_losses.seg_cross_entropy(jnp.asarray(seg_logits), jnp.asarray(seg_labels), 5)),
    }
    for name, (got, want) in pairs.items():
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=name)
    # No positive: the count floors at 1, as _norm's max(n, 1).
    empty = (torch.tensor(3.0), torch.tensor(0.0))
    assert float(losses._norm(empty)) == float(jax_losses._norm((jnp.float32(3.0), jnp.float32(0.0)))) == 3.0
