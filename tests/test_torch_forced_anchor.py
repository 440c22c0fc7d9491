"""The anchor assignment's forced-anchor test (``iou_cu.forced_anchor``, a
CUDA entry point, and its plain version ``ops/assign.py::
forced_anchor_plain``) on the CPU, at the production grid (256 x 256, 0.25
m voxels, K = 6).

The plain version is held bit for bit to the chain it replaced in
``assign_targets_batched`` (own_cell, own_cell_pairs, the plain IoU,
argmax, amax); the whole assignment to JAX's; and numpy models of the
kernel's own-cell arithmetic and of its butterfly argmax to ``own_cell``
and ``torch.argmax``. The kernel itself runs only on a card
(``tests/test_torch_cuda.py``, marker ``gpu``).

The batches hold padded GT, GT on cell borders (and one float32 step to
either side), GT beyond the extents (clamped into the edge cells) and GT
so far out that every IoU of theirs is 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.configs.config import Config as JaxConfig
from v2x_sim_tpu.ops import assign as jax_assign
from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.ops import assign, iou_sh
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.ops.cuda import iou_cu
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

CFG = Config()
GRID = CFG.grid
ANCHORS = torch.from_numpy(anchor_grid(CFG))
NEAR = 1e-5  # labels may differ only this close to a threshold, as tests/test_torch_assign.py


def _batch(seed: int, b: int = 3, m: int = 16):
    """(B, M, 5) float32 GT and (B, M) mask: random vehicles and small
    boxes (whose best own-cell IoU lies under the positive threshold, so
    that forcing matters), then the edge cases, then padding."""
    rng = np.random.default_rng(seed)
    (x0, x1), (y0, y1) = GRID.area_extents[0], GRID.area_extents[1]
    vx, vy = GRID.voxel_size[0], GRID.voxel_size[1]
    gt = np.stack([
        rng.uniform(-30.0, 30.0, (b, m)),
        rng.uniform(-30.0, 30.0, (b, m)),
        rng.choice([0.6, 1.2, 4.5], (b, m)),
        rng.choice([0.4, 0.8, 1.9], (b, m)),
        rng.uniform(-np.pi, np.pi, (b, m)),
    ], -1).astype(np.float32)
    i, j = rng.integers(0, 256, 2)
    on_border = np.float32(x0 + i * vx)
    edges = [
        (on_border, y0 + j * vy),  # both exactly on a border
        (np.nextafter(on_border, np.float32(-np.inf)),
         np.nextafter(np.float32(y0 + j * vy), np.float32(np.inf))),
        (x0, y1),  # the lower and upper extents: cells 0 and W (clamped to W - 1)
        (x1, y0),
        (x1 + 3.0, y0 - 5.0),  # beyond the extents: the edge cells
        (x1 + 500.0, 0.0),  # far out: every own-cell IoU is 0
        (0.0, y0 - 800.0),
    ]
    for r, (x, y) in enumerate(edges):
        gt[0, r, :2] = (x, y)
    mask = np.ones((b, m), bool)
    mask[0, len(edges) + 2:] = False
    mask[1, m // 2:] = False
    gt[~mask] = 0.0  # padded GT as the loaders write it
    return gt, mask


CASES = [0, 1, 2]


def _own_cell_model(gt: np.ndarray):
    """The kernel's own cell in numpy float32: floor(__fsub_rn then
    __fdiv_rn), clamped in float, then cast."""
    h, w = GRID.bev_shape
    out = []
    for f, cells in ((0, h), (1, w)):
        lo = np.float32(GRID.area_extents[f][0])
        size = np.float32(GRID.voxel_size[f])
        t = np.floor((gt[..., f] - lo) / size)
        out.append(np.clip(t, np.float32(0), np.float32(cells - 1)).astype(np.int64))
    return out


def _butterfly_argmax(values: np.ndarray, k: int, group: int = iou_cu.FORCED_GROUP):
    """The kernel's reduction in numpy: (G, k) values in lanes 0..k-1 of a
    group of `group` lanes (-inf beyond), xor steps group/2, ..., 1, each
    lane keeping the pair that comes first (larger value, NaN largest,
    lower index on ties). Returns every lane's (value, index)."""
    v = np.full((values.shape[0], group), -np.inf, np.float32)
    v[:, :k] = values
    idx = np.broadcast_to(np.arange(group), v.shape).copy()
    step = group // 2
    while step:
        u, j = v[:, np.arange(group) ^ step], idx[:, np.arange(group) ^ step]
        un, vn = np.isnan(u), np.isnan(v)
        first = np.where(un != vn, un, np.where(un | (u == v), j < idx, u > v))
        v, idx = np.where(first, u, v), np.where(first, j, idx)
        step //= 2
    return v, idx


@pytest.mark.parametrize("seed", CASES)
def test_plain_equals_the_chain_it_replaced(seed):
    """forced_anchor_plain against own_cell -> own_cell_pairs -> the plain
    IoU on field-major operands -> argmax, amax, bit for bit; and the
    wrapper takes it for CPU tensors without counting a launch."""
    gt, mask = (torch.from_numpy(a) for a in _batch(seed))
    b, m = mask.shape
    k = ANCHORS.shape[2]
    gr, gc = assign.own_cell(gt, GRID)
    gt_op, own_op = assign.own_cell_pairs(gt, ANCHORS, gr, gc)
    want_iou = iou_sh.rotated_iou(gt_op.T, own_op.T).view(b, m, k)
    want = (want_iou, want_iou.argmax(dim=-1), mask & (want_iou.amax(dim=-1) > 0.0),
            gr * ANCHORS.shape[1] + gc)
    got = assign.forced_anchor_plain(gt, mask, ANCHORS, GRID)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    launches = iou_cu.forced_anchor.launches
    for g, w in zip(iou_cu.forced_anchor(gt, mask, ANCHORS, GRID), want):
        assert torch.equal(g, w)
    assert iou_cu.forced_anchor.launches == launches
    # The edge rows of batch 0: the far-out GT force nothing, with own_k 0.
    assert bool((want_iou[0, 5:7] == 0).all()) and not bool(got[2][0, 5:7].any())
    assert got[1][0, 5:7].tolist() == [0, 0]
    assert not bool(got[2][~mask].any())


@pytest.mark.parametrize("seed", CASES)
def test_own_cell_numpy_model_equals_own_cell(seed):
    """The kernel's own-cell arithmetic (numpy float32 model) against
    own_cell on the edge batches, and on every cell border of the grid,
    one float32 step to either side of each, and points beyond it."""
    gt, _ = _batch(seed)
    (x0, _), _ = GRID.area_extents[0], GRID.area_extents[1]
    borders = np.float32(x0) + np.arange(-6, 263, dtype=np.float32) * np.float32(GRID.voxel_size[0])
    xs = np.concatenate([borders, np.nextafter(borders, np.float32(np.inf)),
                         np.nextafter(borders, np.float32(-np.inf)),
                         np.float32([-1e6, 1e6, -32.125, 32.0, 31.999998])])
    sweep = np.zeros((1, xs.size, 5), np.float32)
    sweep[0, :, 0] = xs
    sweep[0, :, 1] = xs[::-1]
    for boxes in (gt, sweep):
        gr, gc = assign.own_cell(torch.from_numpy(boxes), GRID)
        mr, mc = _own_cell_model(boxes)
        np.testing.assert_array_equal(gr.numpy(), mr)
        np.testing.assert_array_equal(gc.numpy(), mc)
    assert {0, 255} <= set(mr.ravel().tolist())


def test_butterfly_argmax_model_is_torch_argmax():
    """The kernel's shuffle reduction (numpy model) gives torch.argmax's
    first index of the largest and its value in every lane: on rows with
    ties, all zeros, NaN, and at every K from 1 to 8."""
    rng = np.random.default_rng(7)
    for k in range(1, iou_cu.FORCED_GROUP + 1):
        values = rng.choice(np.float32([0.0, 0.125, 0.5, 0.75]), (400, k))
        values[:20] = 0.0
        values[20:30, rng.integers(0, k)] = np.nan
        lanes_v, lanes_i = _butterfly_argmax(values, k)
        want = torch.from_numpy(values).argmax(dim=-1).numpy()
        assert (lanes_i == want[:, None]).all()
        best = values[np.arange(values.shape[0]), want]
        np.testing.assert_array_equal(lanes_v, np.broadcast_to(best[:, None], lanes_v.shape))
    assert (want[:20] == 0).all()  # all-zero rows: own_k 0, as JAX's argmax


@pytest.mark.parametrize("seed", CASES[:2])
def test_assignment_with_forced_anchors_matches_jax(seed):
    """assign_targets_batched(flat="sparse") at the production grid on the
    edge batches against JAX's: labels equal away from the thresholds;
    cells, weights and overflow equal; regression targets within 1e-5. The
    batches hold GT that only forcing makes positive."""
    gt, mask = _batch(seed, b=2)
    tg, tm = torch.from_numpy(gt), torch.from_numpy(mask)
    own_iou, _, force, _ = assign.forced_anchor_plain(tg, tm, ANCHORS, GRID)
    forced_only = force & (own_iou.amax(dim=-1) < CFG.anchors.pos_iou_threshold)
    assert int(forced_only.sum()) > 0
    want = jax_assign.assign_targets_batched(jnp.asarray(gt), jnp.asarray(mask),
                                             jnp.asarray(anchor_grid(CFG)), JaxConfig(), flat="sparse")
    got = assign.assign_targets_batched(tg, tm, ANCHORS, CFG, flat="sparse")
    iou = got.iou.numpy()
    near = np.zeros(iou.shape, bool)
    for t in (CFG.anchors.neg_iou_threshold, CFG.anchors.pos_iou_threshold):
        near |= np.abs(iou - t) <= NEAR
    assert ((np.asarray(want.labels) != got.labels.numpy()) <= near).all()
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))
    np.testing.assert_array_equal(got.wts.numpy(), np.asarray(want.wts))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    np.testing.assert_allclose(got.reg.numpy(), np.asarray(want.reg), atol=1e-5, rtol=0)


def test_forced_anchor_wrapper_rejects_malformed_operands():
    gt, mask = (torch.from_numpy(a) for a in _batch(0, b=2))
    with pytest.raises(ValueError):
        iou_cu.forced_anchor(gt, mask[:, :3], ANCHORS, GRID)  # mask shape
    with pytest.raises(ValueError):
        iou_cu.forced_anchor(gt[..., :4], mask, ANCHORS, GRID)  # not 5 fields
    with pytest.raises(ValueError):
        iou_cu.forced_anchor(gt, mask, ANCHORS[:128], GRID)  # not the grid's cells
    with pytest.raises(ValueError):
        iou_cu.forced_anchor(gt, mask, ANCHORS.to("meta"), GRID)  # mixed devices
