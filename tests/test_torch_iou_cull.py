"""The rotated-IoU kernel's cull and its clip (csrc/rotated_iou.cu) on the
CPU, where no CUDA compiler runs.

1. Every pair that the plain copy of the cull (``iou_sh.culled``) takes
   has IoU exactly 0.0 in the port's plain version and in the JAX
   package's ``rotated_iou``: the cull changes no value.
2. A scalar numpy model of the kernel's clip, written step for step as
   the CUDA source (side bits, crossings and kept vertices written to
   their stream positions, no duplicate padding), equals the plain
   version bit for bit when both start from the same corners: the
   redesigned compaction computes the Pallas body's stream.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2x_sim_tpu.ops import iou_sh as jax_iou_sh
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.ops import iou_sh
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.ops.assign import gt_soa, nearest_gt
from v2x_sim_tpu_torch.ops.boxes import box_corners
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


def _boxes(rng, n, spread, lengths=(1.0, 5.0), widths=(0.8, 3.0)):
    return np.stack(
        [
            rng.uniform(-spread, spread, n),
            rng.uniform(-spread, spread, n),
            rng.uniform(*lengths, n),
            rng.uniform(*widths, n),
            rng.uniform(-np.pi, np.pi, n),
        ],
        axis=-1,
    ).astype(np.float32)


def _radius(boxes):
    return 0.5 * np.hypot(boxes[:, 2].astype(np.float64), boxes[:, 3].astype(np.float64))


def _at_distance(rng, n, scale):
    """Pairs whose centres lie `scale(s)` apart, s = r_a + r_b (float64)."""
    a, b = _boxes(rng, n, 10.0), _boxes(rng, n, 10.0)
    d = scale(_radius(a) + _radius(b))
    phi = rng.uniform(-np.pi, np.pi, n)
    b[:, 0] = a[:, 0] + d * np.cos(phi)
    b[:, 1] = a[:, 1] + d * np.sin(phi)
    return a, b


def _assignment_pairs(rng):
    """The anchor grid at 1 m voxels (64 x 64 x 6) against each cell's
    first and second nearest synthetic GT, as ops/assign.py pairs them."""
    cfg = Config(grid=GridConfig(voxel_size=(1.0, 1.0, 0.625)))
    batch = generate_batch(cfg, SyntheticSpec(points_per_agent=256), 1, seed=int(rng.integers(100)))
    gt = torch.from_numpy(batch["gt_boxes"]).reshape(-1, *batch["gt_boxes"].shape[-2:])
    mask = torch.from_numpy(batch["gt_mask"]).reshape(gt.shape[:2])
    anchors = torch.from_numpy(anchor_grid(cfg))
    h, w, k, _ = anchors.shape
    b, n = gt.shape[0], h * w * k
    c1, c2, _, _ = nearest_gt(gt, mask, anchors)
    a = anchors.reshape(n, 5).repeat(2 * b, 1)
    per_anchor = lambda c: c[..., None].expand(b, h, w, k).reshape(b, n)
    bb = torch.cat([gt_soa(gt, per_anchor(c)).T for c in (c1, c2)])
    return a.numpy(), bb.numpy()


def _cases():
    rng = np.random.default_rng(7)
    over = lambda s: np.sqrt(s * s * (1 + iou_sh.CULL_REL) + iou_sh.CULL_ABS) * (1 + 1e-5)
    thin = dict(lengths=(8.0, 30.0), widths=(0.01, 0.1))
    return {
        "random_dense": (_boxes(rng, 2000, 6.0), _boxes(rng, 2000, 6.0)),
        "random_sparse": (_boxes(rng, 2000, 40.0), _boxes(rng, 2000, 40.0)),
        "just_over_the_slack": _at_distance(rng, 1000, over),
        "just_under_the_radii": _at_distance(rng, 1000, lambda s: s * (1 - 1e-4)),
        "long_thin": (_boxes(rng, 2000, 20.0, **thin), _boxes(rng, 2000, 20.0, **thin)),
        "zero_size_padded": (
            _boxes(rng, 1000, 30.0),
            np.concatenate([np.zeros((500, 5), np.float32),
                            _boxes(rng, 500, 30.0, lengths=(0.0, 0.009))]),
        ),
        "assignment_grid": _assignment_pairs(rng),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_pairs_have_zero_iou(case):
    a, b = CASES[case]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cut = iou_sh.culled(ta, tb).numpy()
    expect = {"just_over_the_slack": 1.0, "just_under_the_radii": 0.0, "zero_size_padded": 0.0}
    if case in expect:
        assert cut.mean() == expect[case]
    else:
        assert 0.0 < cut.mean() < 1.0  # the case holds both kinds of pair
    plain = iou_sh.rotated_iou(ta[cut], tb[cut]).numpy()
    np.testing.assert_array_equal(plain, np.zeros_like(plain))
    ours = jax_iou_sh.rotated_iou(jnp.asarray(a[cut][:20000]), jnp.asarray(b[cut][:20000]))
    np.testing.assert_array_equal(np.asarray(ours), 0.0)


def test_assignment_pairs_are_mostly_culled():
    """The anchor assignment is what the cull is for: most of its pairs
    lie apart (and its pairs with a padded GT are never culled)."""
    a, b = CASES["assignment_grid"]
    cut = iou_sh.culled(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert cut.mean() > 0.5
    assert not cut[(b[:, 2] == 0) & (b[:, 3] == 0)].any()


# --- the kernel's clip, modelled in float32 numpy scalars -------------------

F = np.float32
EPS = F(iou_sh.EPS)


def _popc(x):
    return bin(x).count("1")


def _kernel_clip_iou(ca, cb, area_a, area_b, walk=None):
    """One pair, as csrc/rotated_iou.cu::intersection and iou compute it
    (without the FMA contraction nvcc applies), from float32 corners. With
    a `walk` list, it appends the vertices taken, side changes and vertices
    kept over the 4 stages, and the final vertex count."""
    taken = changes = kept = 0
    px, py = [F(v) for v in ca[:, 0]], [F(v) for v in ca[:, 1]]
    bx, by = [F(v) for v in cb[:, 0]], [F(v) for v in cb[:, 1]]
    count = 4
    for e in range(4):
        nv = min(count, 8)
        ea_x, ea_y = bx[e], by[e]
        ex, ey = bx[(e + 1) % 4] - ea_x, by[(e + 1) % 4] - ea_y
        inside = 0
        for i in range(nv):
            if ex * (py[i] - ea_y) - ey * (px[i] - ea_x) >= -EPS:
                inside |= 1 << i
        nxt = (inside >> 1) | (((inside & 1) << (nv - 1)) if nv > 0 else 0)
        taken, changes, kept = taken + nv, changes + _popc(inside ^ nxt), kept + _popc(inside)
        qx, qy = [None] * 8, [None] * 8
        crossed = 0
        c = inside ^ nxt
        while c:
            i = (c & -c).bit_length() - 1
            j = 0 if i + 1 == nv else i + 1
            dx, dy = px[j] - px[i], py[j] - py[i]
            denom = ex * dy - ey * dx
            if abs(denom) > EPS:
                t = (ex * (ea_y - py[i]) - ey * (ea_x - px[i])) / denom
                pos = _popc(inside & ((2 << i) - 1)) + _popc(crossed)
                if pos < 8:
                    qx[pos], qy[pos] = px[i] + t * dx, py[i] + t * dy
                crossed |= 1 << i
            c &= c - 1
        v = inside
        while v:
            i = (v & -v).bit_length() - 1
            below = (1 << i) - 1
            pos = _popc(inside & below) + _popc(crossed & below)
            if pos < 8:
                qx[pos], qy[pos] = px[i], py[i]
            v &= v - 1
        count = _popc(inside) + _popc(crossed)
        px, py = qx, qy
    nv = min(count, 8)
    if walk is not None:
        walk.extend((taken, changes, kept, nv))
    area2 = F(0.0)
    for i in range(nv):
        j = 0 if i + 1 == nv else i + 1
        area2 = area2 + (px[i] * py[j] - px[j] * py[i])
    inter = F(0.5) * abs(area2) if count >= 3 else F(0.0)
    return inter / max(F(area_a) + F(area_b) - inter, EPS)


def _degenerate_pairs():
    """Touching, collinear, vertex-on-edge, identical, nested, zero-size."""
    q = np.pi / 4
    pairs = [
        ((0, 0, 2, 2, 0), (2, 0, 2, 2, 0)),  # edges touch
        ((0, 0, 2, 2, 0), (2, 2, 2, 2, 0)),  # corners touch
        ((0, 0, 2, 2, 0), (1, 0, 2, 2, 0)),  # collinear top and bottom edges
        ((0, 0, 2, 2, 0), (0, 0, 2, 2, 0)),  # identical
        ((0, 0, 2, 2, 0), (1 + np.sqrt(2), 0, 2, 2, q)),  # vertex on an edge
        ((0, 0, 2, 2, 0), (0, 0, 2, 2, q)),  # octagon: 8 vertices
        ((0, 0, 10, 10, 0.2), (0, 0, 2, 2, 1.0)),  # nested
        ((0, 0, 2, 2, 1.0), (0, 0, 10, 10, 0.2)),  # nested the other way
        ((0, 0, 4, 2, 0), (0, 0, 0, 0, 0)),  # zero-size B
        ((0, 0, 0, 0, 0), (0, 0, 4, 2, 0)),  # zero-size A
        ((0, 0, 4, 2, 0), (0, 0, 4, 0, 0.3)),  # segment B
        ((0, 0, 30, 0.02, 0.1), (0, 0, 30, 0.02, 0.1001)),  # thin, almost parallel
        ((5, 5, 4, 2, np.pi / 2), (5, 5, 4, 2, 0)),  # cross
    ]
    return tuple(np.asarray([p[i] for p in pairs], np.float32) for i in (0, 1))


def _clip_cases():
    rng = np.random.default_rng(8)
    a, b = CASES["assignment_grid"]
    keep = ~iou_sh.culled(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    pick = rng.choice(np.flatnonzero(keep), 300, replace=False)
    return {
        "random_dense": (_boxes(rng, 300, 3.0), _boxes(rng, 300, 3.0)),
        "same_centre": (_boxes(rng, 300, 0.0), _boxes(rng, 300, 0.0)),
        "degenerate": _degenerate_pairs(),
        "assignment_grid": (a[pick], b[pick]),
    }


CLIP_CASES = _clip_cases()


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_kernel_clip_model_equals_plain_version(case):
    a, b = (torch.from_numpy(x) for x in CLIP_CASES[case])
    ca, cb = box_corners(a).numpy(), box_corners(b).numpy()
    area_a, area_b = (a[:, 2] * a[:, 3]).numpy(), (b[:, 2] * b[:, 3]).numpy()
    got = np.array([_kernel_clip_iou(ca[i], cb[i], area_a[i], area_b[i]) for i in range(len(a))],
                   np.float32)
    want = iou_sh.rotated_iou(a, b).numpy()
    assert (want > 0).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_clip_profile_counts_what_the_kernel_clip_walks(case):
    """iou_sh.clip_profile, from which chip_smoke.py counts the kernel's
    operations, equals the model's walk pair by pair."""
    a, b = (torch.from_numpy(x) for x in CLIP_CASES[case])
    ca, cb = box_corners(a).numpy(), box_corners(b).numpy()
    want = []
    for i in range(len(a)):
        walk = []
        _kernel_clip_iou(ca[i], cb[i], 1.0, 1.0, walk)
        want.append(walk)
    got = np.stack([t.numpy() for t in iou_sh.clip_profile(a, b)], axis=-1)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, 1] > 0).any()
