"""The port's host-side ops against the JAX package on the same inputs:
box codec, voxelization, the all-pairs warp (both JAX regimes), top-K
decode with the peak filter, and NMS.

Tolerances: exact where both sides do the same integer/selection work
(voxel grids, valid masks); 1e-5 for float32 arithmetic done in another
order; 1e-4 where bilinear weights multiply features of order 1 over
maps summed across taps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.configs.config import GridConfig as JaxGrid
from v2x_sim_tpu.ops import boxes as jax_boxes
from v2x_sim_tpu.ops import nms as jax_nms
from v2x_sim_tpu.ops import postprocess as jax_post
from v2x_sim_tpu.ops import voxelize as jax_vox
from v2x_sim_tpu.ops import warp as jax_warp
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.ops import boxes, nms, postprocess, voxelize, warp
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


def _grids(voxel):
    return GridConfig(voxel_size=voxel), JaxGrid(voxel_size=voxel)


def _random_boxes(rng, shape, spread=10.0):
    n = int(np.prod(shape))
    out = np.stack(
        [
            rng.uniform(-spread, spread, n),
            rng.uniform(-spread, spread, n),
            rng.uniform(1.0, 5.0, n),
            rng.uniform(0.8, 3.0, n),
            rng.uniform(-np.pi, np.pi, n),
        ],
        axis=-1,
    ).astype(np.float32)
    return out.reshape(tuple(shape) + (5,))


def test_box_codec_matches_jax():
    rng = np.random.default_rng(0)
    gt = _random_boxes(rng, (64,))
    anchors = _random_boxes(rng, (64,))
    t_gt, t_an = torch.from_numpy(gt), torch.from_numpy(anchors)
    j_gt, j_an = jnp.asarray(gt), jnp.asarray(anchors)
    np.testing.assert_allclose(
        boxes.box_corners(t_gt).numpy(), np.asarray(jax_boxes.box_corners(j_gt)), atol=1e-5)
    np.testing.assert_allclose(
        boxes.box_area(t_gt).numpy(), np.asarray(jax_boxes.box_area(j_gt)), atol=1e-5)
    code = boxes.encode_boxes(t_gt, t_an)
    np.testing.assert_allclose(
        code.numpy(), np.asarray(jax_boxes.encode_boxes(j_gt, j_an)), atol=1e-5)
    np.testing.assert_allclose(
        boxes.decode_boxes(code, t_an).numpy(),
        np.asarray(jax_boxes.decode_boxes(jnp.asarray(code.numpy()), j_an)), atol=1e-5)
    np.testing.assert_allclose(boxes.decode_boxes(code, t_an).numpy(), gt, atol=1e-4)


def test_anchor_grid_copy_matches_jax():
    from v2x_sim_tpu.ops.anchors import anchor_grid as jax_anchor_grid

    np.testing.assert_array_equal(anchor_grid(Config()), jax_anchor_grid(JaxConfig()))


def test_voxelize_batch_matches_jax_with_padding_and_out_of_extent():
    grid, jgrid = _grids((0.25, 0.25, 0.4))  # production 256x256x13
    rng = np.random.default_rng(1)
    b, a, p = 2, 3, 600
    pts = rng.uniform(-40, 40, (b, a, p, 3)).astype(np.float32)  # many out of extent
    pts[..., 2] = rng.uniform(-4, 3, (b, a, p))
    pts[0, 0, :4] = [[32.0, 0.0, 0.0], [0.0, 32.0, 0.0], [-32.0, -32.0, -3.0], [31.99, 31.99, 1.9]]
    mask = rng.uniform(size=(b, a, p)) > 0.2  # padded points
    mask[0, 0, :4] = True
    got = voxelize.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(mask), grid).numpy()
    want = np.asarray(jax_vox.voxelize_batch(jnp.asarray(pts), jnp.asarray(mask), jgrid))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (b, a, 256, 256, 13)
    assert got[0, 0, 0, 0, 0] == 1.0 and got[0, 0, 255, 255, 12] == 1.0  # edges kept
    idx, valid = voxelize.voxel_indices(torch.tensor([[32.0, 0.0, 0.0]]), grid)
    assert idx[0, 0] == 256 and not bool(valid[0])  # +32.0 m is past the grid
    # Padded points never land, wherever they are.
    none = voxelize.voxelize_batch(torch.zeros(1, 5, 3), torch.zeros(1, 5, dtype=torch.bool), grid)
    assert none.sum() == 0


def _random_trans(rng, b, a):
    trans = np.tile(np.eye(4, dtype=np.float32), (b, a, a, 1, 1))
    for bi in range(b):
        for i in range(a):
            for j in range(a):
                if i == j:
                    continue
                yaw = rng.uniform(-0.8, 0.8)
                c, s = np.cos(yaw), np.sin(yaw)
                trans[bi, i, j, :2, :2] = [[c, -s], [s, c]]
                trans[bi, i, j, :2, 3] = rng.uniform(-6, 6, 2)
    return trans


@pytest.mark.parametrize("voxel", [(2.0, 2.0, 0.625), (1.0, 1.0, 0.625)], ids=["onehot-32x32", "gather-64x64"])
def test_warp_all_pairs_matches_jax_both_regimes(voxel):
    """32x32 = 1024 cells runs JAX's one-hot matmul, 64x64 = 4096 its gather."""
    grid, jgrid = _grids(voxel)
    h, w, _ = grid.grid_shape
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 3, h, w, 4)).astype(np.float32)
    trans = _random_trans(rng, 2, 3)
    got = warp.warp_all_pairs(torch.from_numpy(feats), torch.from_numpy(trans), grid).numpy()
    want = np.asarray(jax_warp.warp_all_pairs(jnp.asarray(feats), jnp.asarray(trans), jgrid))
    assert got.shape == (2, 3, 3, h, w, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got[:, [0, 1, 2], [0, 1, 2]], feats, atol=1e-5)  # diagonal = identity


def test_warp_probe_translation_lands_four_cells_up():
    """A feature at (30, 20) of agent 1, sampled through T_{1<-0} with +4 m
    in x at 1 m voxels, lands at (26, 20) of agent 0's frame."""
    grid, _ = _grids((1.0, 1.0, 0.625))
    feats = torch.zeros(1, 2, 64, 64, 1)
    feats[0, 1, 30, 20, 0] = 1.0
    trans = torch.eye(4).repeat(1, 2, 2, 1, 1)
    trans[0, 1, 0, 0, 3] = 4.0  # T_{1<-0}
    trans[0, 0, 1, 0, 3] = -4.0  # T_{0<-1}
    out = warp.warp_all_pairs(feats, trans, grid)[0, 0, 1, :, :, 0]
    assert out[26, 20] == pytest.approx(1.0, abs=1e-6)
    assert float(out.sum()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("peak_window", [0, 3])
def test_decode_topk_matches_jax(peak_window):
    cfg = Config(grid=GridConfig(voxel_size=(2.0, 2.0, 0.625)))  # 32x32
    anchors = anchor_grid(cfg)
    rng = np.random.default_rng(3)
    b, a, k = 2, 3, 24  # k below the number of 3x3 peaks: no -inf ties
    cls = rng.standard_normal((b, a, 32, 32, 6, 2)).astype(np.float32)
    reg = (0.3 * rng.standard_normal((b, a, 32, 32, 6, 6))).astype(np.float32)
    am = np.array([[True, True, False], [True, True, True]])
    got = postprocess.decode_topk(
        torch.from_numpy(cls), torch.from_numpy(reg), torch.from_numpy(anchors), k, 0.3,
        torch.from_numpy(am), peak_window=peak_window)
    want = jax_post.decode_topk(
        jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors), k, 0.3, jnp.asarray(am),
        exact=True, peak_window=peak_window)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[2].sum() < got[2].numel()
    if peak_window:
        np.testing.assert_array_equal(
            postprocess._peak_filter(torch.from_numpy(cls[..., 1] - cls[..., 0]).reshape(6, 32, 32, 6), 3).numpy(),
            np.asarray(jax_post._peak_filter(jnp.asarray(cls[..., 1] - cls[..., 0]).reshape(6, 32, 32, 6), 3)))


def test_batched_nms_matches_jax():
    """Distinct scores, so the stable sort leaves no tie to disagree on."""
    rng = np.random.default_rng(4)
    b, a, k = 2, 3, 40
    bx = _random_boxes(rng, (b, a, k), spread=6.0)
    scores = rng.uniform(0, 1, (b, a, k)).astype(np.float32)
    valid = scores > 0.3
    got = nms.batched_nms(torch.from_numpy(bx), torch.from_numpy(scores), torch.from_numpy(valid), 0.1)
    want = jax_nms.batched_nms(jnp.asarray(bx), jnp.asarray(scores), jnp.asarray(valid), 0.1)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=0)
    kept = got.valid.sum()
    assert 0 < kept < valid.sum()  # something was suppressed, something kept
