"""The rotated-IoU kernel wrapper (ops/cuda/iou_cu.py), all four entry
points: their CPU route, their input checks, and — on a CUDA card only —
the CUDA kernel against the plain PyTorch version (the forced-anchor
entry's CPU cases are in tests/test_torch_forced_anchor.py). On the card
too: the fused BatchNorm + ReLU passes (ops/cuda/bn_cu.py; their CPU cases
are in tests/test_torch_batchnorm.py) against their plain versions at
the widths and resolutions of a B=16 DiscoNet training step, inference's
route to the normalize + ReLU pass on the running stats, and the
decoder's fused upsample and concatenation (ops/cuda/upsample_cu.py; CPU
cases in tests/test_torch_upsample.py) at that step's four stage inputs.

This file imports neither JAX nor tests/conftest.py's setup, so it runs
on the card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from v2x_sim_tpu_torch.ops import iou_sh
from v2x_sim_tpu_torch.ops.cuda import bn_cu, iou_cu


def _random_boxes(rng, n, spread=6.0):
    return np.stack(
        [
            rng.uniform(-spread, spread, n),
            rng.uniform(-spread, spread, n),
            rng.uniform(1.0, 5.0, n),
            rng.uniform(0.8, 3.0, n),
            rng.uniform(-np.pi, np.pi, n),
        ],
        axis=-1,
    ).astype(np.float32)


@pytest.fixture
def cuda_device():
    """The card; decided here, at run time, never at collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m gpu tests/test_torch_cuda.py")
    return torch.device("cuda")


def test_wrapper_takes_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_random_boxes(rng, 3 * 10).reshape(3, 10, 5))
    b = torch.from_numpy(_random_boxes(rng, 3 * 7).reshape(3, 7, 5))
    before = (iou_cu.rotated_iou_matrix.launches, iou_cu.rotated_iou_pairs_soa.launches)
    got = iou_cu.rotated_iou_matrix(a, b)
    np.testing.assert_array_equal(got.numpy(), iou_sh.rotated_iou_matrix(a, b).numpy())
    a_soa, b_soa = a[0].T.contiguous(), a[1].T.contiguous()
    np.testing.assert_array_equal(
        iou_cu.rotated_iou_pairs_soa(a_soa, b_soa).numpy(),
        iou_sh.rotated_iou(a[0], a[1]).numpy())
    assert (iou_cu.rotated_iou_matrix.launches, iou_cu.rotated_iou_pairs_soa.launches) == before


def test_wrapper_rejects_malformed_operands():
    a = torch.zeros(2, 4, 5)
    with pytest.raises(ValueError):
        iou_cu.rotated_iou_matrix(a, torch.zeros(3, 4, 5))  # G differs
    with pytest.raises(ValueError):
        iou_cu.rotated_iou_matrix(a, torch.zeros(2, 4, 4))  # not 5 fields
    with pytest.raises(ValueError):
        iou_cu.rotated_iou_pairs_soa(torch.zeros(5, 3), torch.zeros(5, 4))
    with pytest.raises(ValueError):
        iou_cu.rotated_iou_matrix(a, a.to("meta"))  # mixed devices


def test_periodic_wrapper_takes_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(5)
    n, reps = 37, 4  # a period that tiles nothing
    a = torch.from_numpy(_random_boxes(rng, n))
    b = torch.from_numpy(_random_boxes(rng, n * reps))
    before = iou_cu.rotated_iou_pairs_soa_periodic.launches
    got = iou_cu.rotated_iou_pairs_soa_periodic(a.T.contiguous(), b.T.contiguous())
    assert iou_cu.rotated_iou_pairs_soa_periodic.launches == before
    np.testing.assert_array_equal(got.numpy(), iou_sh.rotated_iou(a.repeat(reps, 1), b).numpy())


def test_periodic_wrapper_rejects_malformed_operands():
    with pytest.raises(ValueError):
        iou_cu.rotated_iou_pairs_soa_periodic(torch.zeros(5, 3), torch.zeros(5, 7))  # 7 % 3
    with pytest.raises(ValueError):
        iou_cu.rotated_iou_pairs_soa_periodic(torch.zeros(4, 3), torch.zeros(4, 6))  # not 5 fields
    with pytest.raises(ValueError):
        iou_cu.rotated_iou_pairs_soa_periodic(torch.zeros(5, 0), torch.zeros(5, 0))  # no period
    with pytest.raises(ValueError):
        iou_cu.rotated_iou_pairs_soa_periodic(torch.zeros(5, 3), torch.zeros(5, 6, device="meta"))


def test_reset_launches_zeroes_every_entry_point():
    for fn in (iou_cu.rotated_iou_pairs_soa, iou_cu.rotated_iou_matrix,
               iou_cu.rotated_iou_pairs_soa_periodic):
        fn.launches = 3
    iou_cu.reset_launches()
    assert (iou_cu.rotated_iou_pairs_soa.launches, iou_cu.rotated_iou_matrix.launches,
            iou_cu.rotated_iou_pairs_soa_periodic.launches) == (0, 0, 0)


@pytest.mark.gpu
def test_periodic_kernel_matches_plain_on_card(cuda_device):
    """The periodic entry point at a period that is not a multiple of the
    TPU's 8192-pair tile, against the plain version; atol 1e-4 as below."""
    rng = np.random.default_rng(6)
    n, reps = 4099, 16
    a = torch.from_numpy(_random_boxes(rng, n)).to(cuda_device)
    b = torch.from_numpy(_random_boxes(rng, n * reps)).to(cuda_device)
    launches = iou_cu.rotated_iou_pairs_soa_periodic.launches
    got = iou_cu.rotated_iou_pairs_soa_periodic(a.T.contiguous(), b.T.contiguous())
    torch.cuda.synchronize()
    assert iou_cu.rotated_iou_pairs_soa_periodic.launches == launches + 1
    assert got.shape == (n * reps,)
    torch.testing.assert_close(got, iou_sh.rotated_iou(a.repeat(reps, 1), b), atol=1e-4, rtol=0)
    with pytest.raises(TypeError):
        iou_cu.rotated_iou_pairs_soa_periodic(a.T.double(), b.T.double())


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda_device):
    """Both entry points of csrc/rotated_iou.cu against the plain version,
    atol 1e-4 (the bound the kernel met while nvcc contracted its sums into
    FMAs, measured max ~6e-6 on the H100; it now rounds each product as
    the plain version does)."""
    rng = np.random.default_rng(4)
    n = 1 << 16
    a = torch.from_numpy(_random_boxes(rng, n)).to(cuda_device)
    b = torch.from_numpy(_random_boxes(rng, n)).to(cuda_device)
    launches = iou_cu.rotated_iou_pairs_soa.launches
    got = iou_cu.rotated_iou_pairs_soa(a.T.contiguous(), b.T.contiguous())
    assert iou_cu.rotated_iou_pairs_soa.launches == launches + 1
    torch.testing.assert_close(got, iou_sh.rotated_iou(a, b), atol=1e-4, rtol=0)

    g = torch.from_numpy(_random_boxes(rng, 6 * 128).reshape(6, 128, 5)).to(cuda_device)
    h = torch.from_numpy(_random_boxes(rng, 6 * 100).reshape(6, 100, 5)).to(cuda_device)
    got = iou_cu.rotated_iou_matrix(g, h)
    torch.cuda.synchronize()
    assert got.shape == (6, 128, 100)
    torch.testing.assert_close(got, iou_sh.rotated_iou_matrix(g, h), atol=1e-4, rtol=0)
    with pytest.raises(TypeError):
        iou_cu.rotated_iou_matrix(g.double(), h.double())


def _assert_matches_plain(got, want, what):
    """Kernel vs plain: max |diff| <= 1e-4 (as above), and the exact zeros
    agree wherever the plain IoU is 1e-6 or more."""
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=what)
    firm = want >= 1e-6
    assert torch.equal((got == 0)[firm], (want == 0)[firm]), what


@pytest.mark.gpu
def test_periodic_kernel_sparse_operands_on_card(cuda_device):
    """Assignment-like operands: most pairs lie apart (the cull), the rest
    go through the queue; the periods tile nothing, so tiles straddle the
    wrap (one period under a tile, one over). Zero-size padded boxes are
    never culled: their IoU is area / max(rounding, 1e-8) in both versions,
    so there only its sign is compared."""
    rng = np.random.default_rng(9)
    for n, reps in ((5, 1000), (3001, 24)):
        a = _random_boxes(rng, n, spread=30.0)
        b = _random_boxes(rng, n * reps, spread=30.0)
        pad = rng.random(n * reps) < 0.05
        b[pad] = 0.0
        ta, tb = torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device)
        got = iou_cu.rotated_iou_pairs_soa_periodic(ta.T.contiguous(), tb.T.contiguous())
        want = iou_sh.rotated_iou(ta.repeat(reps, 1), tb)
        torch.cuda.synchronize()
        cut = iou_sh.culled(ta.repeat(reps, 1), tb)
        assert 0.5 < float(cut.float().mean()) < 1.0
        real = torch.from_numpy(~pad).to(cuda_device)
        _assert_matches_plain(got[real], want[real], f"period {n}")
        assert torch.equal(got[~real] > 0, want[~real] > 0)


@pytest.mark.gpu
def test_matrix_kernel_clustered_on_card(cuda_device):
    """G > 1, N != M, M over one column tile, boxes in clusters: the
    staged tiles, the cull and the queue against the plain version."""
    rng = np.random.default_rng(10)
    g, n, m = 5, 70, 150

    def clustered(count):
        centres = rng.uniform(-30.0, 30.0, (g, 4, 2))
        boxes = _random_boxes(rng, g * count, spread=1.5).reshape(g, count, 5)
        boxes[..., :2] += centres[np.arange(g)[:, None], rng.integers(0, 4, (g, count))]
        return torch.from_numpy(boxes.astype(np.float32)).to(cuda_device)

    a, b = clustered(n), clustered(m)
    launches = iou_cu.rotated_iou_matrix.launches
    got = iou_cu.rotated_iou_matrix(a, b)
    torch.cuda.synchronize()
    assert iou_cu.rotated_iou_matrix.launches == launches + 1
    assert got.shape == (g, n, m)
    want = iou_sh.rotated_iou_matrix(a, b)
    cut = iou_sh.culled(a[:, :, None], b[:, None])
    assert 0.3 < float(cut.float().mean()) < 1.0 and bool((want > 0).any())
    _assert_matches_plain(got, want, "clustered matrix")


@pytest.mark.gpu
def test_matrix_kernel_zero_size_columns_on_card(cuda_device):
    """mAP's shape of operands (detections x GT) with padded, all-zero GT
    columns. Against a zero-size box the clip keeps the other box whole,
    and the IoU is its area over the rounding residual of the union
    (ROADMAP.md's F2). The kernel rounds every product and sum as the
    plain version does, so every pair, the padded columns included, is
    held within 1e-4 (the count beyond it is printed: 0 of
    131,072 on the H100); so are the aligned-pairs and periodic entries
    on the same boxes."""
    rng = np.random.default_rng(12)
    g, n, m = 8, 512, 32
    a = _random_boxes(rng, g * n, spread=32.0).reshape(g, n, 5)
    b = _random_boxes(rng, g * m, spread=32.0).reshape(g, m, 5)
    padded = rng.random((g, m)) < 0.6
    b[padded] = 0.0
    ta, tb = torch.from_numpy(a).to(cuda_device), torch.from_numpy(b).to(cuda_device)
    got = iou_cu.rotated_iou_matrix(ta, tb)
    want = iou_sh.rotated_iou_matrix(ta, tb)
    torch.cuda.synchronize()
    cols = torch.from_numpy(padded).to(cuda_device)[:, None, :].expand(g, n, m)
    apart = (got - want).abs() > 1e-4
    print(f"pairs beyond 1e-4: {int(apart.sum())} of {apart.numel()}, "
          f"{int(apart[cols].sum())} of the {int(cols.sum())} with a zero-size column")
    assert float(want[cols].min()) > 1e3  # area / residual: the F2 regime
    assert not bool(apart.any())
    # The aligned-pairs and periodic entries share the corners and the union.
    pa, pb = ta[:, :m].reshape(-1, 5), tb.reshape(-1, 5)
    got = iou_cu.rotated_iou_pairs_soa(pa.T.contiguous(), pb.T.contiguous())
    torch.testing.assert_close(got, iou_sh.rotated_iou(pa, pb), atol=1e-4, rtol=0)
    got = iou_cu.rotated_iou_pairs_soa_periodic(pa[:m].T.contiguous(), pb.T.contiguous())
    torch.testing.assert_close(got, iou_sh.rotated_iou(pa[:m].repeat(g, 1), pb), atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_pairs_kernel_sparse_operands_on_card(cuda_device):
    """Aligned pairs, mostly apart, with a ragged last block."""
    rng = np.random.default_rng(11)
    n = 10_007
    a = torch.from_numpy(_random_boxes(rng, n, spread=20.0)).to(cuda_device)
    b = torch.from_numpy(_random_boxes(rng, n, spread=20.0)).to(cuda_device)
    got = iou_cu.rotated_iou_pairs_soa(a.T.contiguous(), b.T.contiguous())
    torch.cuda.synchronize()
    assert float(iou_sh.culled(a, b).float().mean()) > 0.5
    _assert_matches_plain(got, iou_sh.rotated_iou(a, b), "sparse aligned pairs")


@pytest.mark.gpu
def test_device_prefetch_stages_on_a_side_stream(cuda_device):
    """datasets/loader.py::device_prefetch on the card: host arrays go up
    through pinned buffers, the stage (here the matrix kernel) runs on the
    prefetch thread's own stream, and the consumer reads every batch
    complete on its stream."""
    from v2x_sim_tpu_torch.datasets.loader import device_prefetch

    rng = np.random.default_rng(13)
    host = [{"a": _random_boxes(rng, 2 * 300).reshape(2, 300, 5),
             "b": _random_boxes(rng, 2 * 40).reshape(2, 40, 5)} for _ in range(5)]
    consumer = torch.cuda.current_stream(cuda_device)
    streams = []

    def stage(batch):
        streams.append(torch.cuda.current_stream(cuda_device))
        assert batch["a"].is_cuda and batch["b"].is_cuda
        return {"iou": iou_cu.rotated_iou_matrix(batch["a"], batch["b"])}

    launches = iou_cu.rotated_iou_matrix.launches
    got = [p["iou"].cpu() for p in device_prefetch(iter(host), stage, depth=2, device=cuda_device)]
    assert iou_cu.rotated_iou_matrix.launches == launches + len(host)
    assert len(streams) == len(host) and all(s != consumer for s in streams)
    for g, h in zip(got, host):
        want = iou_sh.rotated_iou_matrix(torch.from_numpy(h["a"]), torch.from_numpy(h["b"]))
        _assert_matches_plain(g, want, "matrix staged on the prefetch stream")


@pytest.mark.gpu
@pytest.mark.parametrize("flat", [False, True], ids=["dense", "flat"])
def test_dense_and_flat_assignment_on_card(cuda_device, flat):
    """The dense and flat layouts of ``assign_targets_batched`` on the card
    (K2 twice, the forced-anchor entry once, the aligned pairs never)
    against the same call on the CPU (the plain versions): labels equal
    away from the thresholds, targets and IoU within 1e-5."""
    from v2x_sim_tpu_torch.configs.config import Config, GridConfig
    from v2x_sim_tpu_torch.ops.anchors import anchor_grid
    from v2x_sim_tpu_torch.ops.assign import assign_targets_batched

    cfg = Config(grid=GridConfig(voxel_size=(0.5, 0.5, 0.625)))  # 128x128
    rng = np.random.default_rng(11)
    gt = _random_boxes(rng, 3 * 10, spread=28.0).reshape(3, 10, 5)
    gt[..., 2:4] = gt[..., 2:4] * [1.5, 0.9] + [1.5, 0.5]
    mask = np.ones((3, 10), bool)
    mask[1, 6:] = False
    gt[~mask] = 0.0
    anchors = torch.from_numpy(anchor_grid(cfg))
    args = (torch.from_numpy(gt), torch.from_numpy(mask))
    want = assign_targets_batched(*args, anchors, cfg, flat=flat)
    iou_cu.reset_launches()
    got = assign_targets_batched(*(t.to(cuda_device) for t in args), anchors.to(cuda_device), cfg,
                                 flat=flat)
    torch.cuda.synchronize()
    assert iou_cu.rotated_iou_pairs_soa_periodic.launches == 2
    assert (iou_cu.forced_anchor.launches, iou_cu.rotated_iou_pairs_soa.launches) == (1, 0)
    got = [t.cpu() for t in got]
    iou = want.best_iou
    near = ((iou - 0.2).abs() <= 1e-4) | ((iou - 0.4).abs() <= 1e-4)
    assert bool(((got[0] != want.labels) <= near).all())
    assert int((want.labels == 1).sum()) > 0
    same = (got[0] == want.labels).numpy()
    reg_g, reg_w = got[1].numpy(), want.reg_targets.numpy()
    if flat:  # field-major (B, 6, n)
        reg_g, reg_w = reg_g.transpose(0, 2, 1), reg_w.transpose(0, 2, 1)
    np.testing.assert_allclose(reg_g[same], reg_w[same], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2].numpy()[same], want.reg_mask.numpy()[same])
    np.testing.assert_allclose(got[3].numpy(), iou.numpy(), atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_forced_anchor_kernel_matches_plain_on_card(cuda_device):
    """The forced-anchor entry against its plain version on the card, at
    the production grid: B=16 scenes x 6 agents x 32 GT, and a batch of
    edge cases (GT on cell borders and one float32 step off them, on and
    beyond the extents, so far out that every IoU is 0, padded GT). Every
    pair's IoU bit for bit (both round each product as the other does),
    own_k, force and the cell equal; one launch a call."""
    from v2x_sim_tpu_torch.configs.config import Config
    from v2x_sim_tpu_torch.ops.anchors import anchor_grid
    from v2x_sim_tpu_torch.ops.assign import forced_anchor_plain

    cfg = Config()
    grid = cfg.grid
    anchors = torch.from_numpy(anchor_grid(cfg)).to(cuda_device)
    rng = np.random.default_rng(14)
    gt = _random_boxes(rng, 96 * 32, spread=30.0).reshape(96, 32, 5)
    mask = rng.random((96, 32)) < 0.6
    gt[~mask] = 0.0
    (x0, x1), (y0, y1) = grid.area_extents[0], grid.area_extents[1]
    border = np.float32(x0) + np.arange(0, 257, 16, dtype=np.float32) * np.float32(grid.voxel_size[0])
    xs = np.concatenate([border, np.nextafter(border, np.float32(-np.inf)),
                         np.nextafter(border, np.float32(np.inf)),
                         np.float32([x1 + 3.0, x0 - 2.0, x1 + 500.0, 0.0])])
    edge = _random_boxes(rng, xs.size)[None]
    edge[0, :, 0], edge[0, :, 1] = xs, xs[::-1]
    edge[0, -1, 1] = y0 - 800.0
    edge_mask = np.ones(edge.shape[:2], bool)
    edge[0, -6:-3] = 0.0
    edge_mask[0, -6:-3] = False
    for boxes, valid in ((gt, mask), (edge, edge_mask)):
        tg = torch.from_numpy(boxes).to(cuda_device)
        tm = torch.from_numpy(valid).to(cuda_device)
        launches = iou_cu.forced_anchor.launches
        got = iou_cu.forced_anchor(tg, tm, anchors, grid)
        torch.cuda.synchronize()
        assert iou_cu.forced_anchor.launches == launches + 1
        want = forced_anchor_plain(tg, tm, anchors, grid)
        for name, g, w in zip(("own_iou", "own_k", "force", "cell"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(g, w), f"{name}: {int((g != w).sum())} entries differ"
    assert bool(got[2].any()) and not bool(got[2][~tm].any())
    with pytest.raises(TypeError):
        iou_cu.forced_anchor(tg, tm.to(torch.uint8), anchors, grid)


#: The train-mode BatchNorm maps of a B=16 DiscoNet step (16 scenes x 6
#: agents): each stage's width at its resolution.
BN_SHAPES = ((96, 32, 256, 256), (96, 64, 128, 128), (96, 128, 64, 64), (96, 256, 32, 32),
             (96, 512, 16, 16))
#: A pass's float32 sums against PyTorch's, relative to the sum of the
#: terms' magnitudes (both sum ~1e5-1e7 terms in float32, in other orders).
BN_SUM_RTOL = 1e-5
#: The whole layer's outputs near 0, against the unfused layer's.
BN_NEAR_ZERO = 1e-5


def _bn_operands(shape, device, seed):
    """A channels-last bf16 map with per-channel mean and scale, as conv
    outputs look, its cotangent, and an affine."""
    n, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    loc = torch.randn(c, device=device, generator=gen) * 0.8
    scale = torch.rand(c, device=device, generator=gen) * 1.7 + 0.3
    x = torch.randn(n, h, w, c, device=device, generator=gen) * scale + loc
    dy = torch.randn(n, h, w, c, device=device, generator=gen)
    weight = torch.rand(c, device=device, generator=gen) + 0.5
    bias = torch.randn(c, device=device, generator=gen) * 0.3
    return (x.to(torch.bfloat16).permute(0, 3, 1, 2), dy.to(torch.bfloat16).permute(0, 3, 1, 2),
            weight, bias)


def _assert_sums_close(got, want, magnitude, what):
    gap = (got - want).abs()
    assert bool((gap <= BN_SUM_RTOL * magnitude).all()), (what, float((gap / magnitude).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BN_SHAPES, ids=lambda s: f"c{s[1]}")
def test_batchnorm_kernels_match_plain_on_card(cuda_device, shape):
    """Each pass of csrc/batchnorm.cu against its plain version: the
    reductions within BN_SUM_RTOL; the elementwise passes, given the same
    (C,) vectors, bit for bit; one launch a call. Then the whole Function
    against the unfused layer as tests/test_torch_batchnorm.py holds it."""
    from tests.test_torch_batchnorm import _assert_same_layer

    x, dy, weight, bias = _bn_operands(shape, cuda_device, seed=shape[1])
    before = bn_cu.launches()
    xf = x.float()
    stats = bn_cu.moments(x)
    _assert_sums_close(stats, bn_cu.moments_plain(x),
                       torch.stack([xf.abs().mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))]),
                       "moments")
    mean, msq = stats.unbind()
    var = (msq - mean * mean).clamp(min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    inv = weight * rstd
    y = bn_cu.normalize_relu(x, mean, inv, bias)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, bn_cu.normalize_relu_plain(x, mean, inv, bias))
    sums = bn_cu.backward_reduce(dy, y, x, mean)
    g = bn_cu._relu_grad(dy, y)
    xc = xf - mean[:, None, None]
    _assert_sums_close(sums, bn_cu.backward_reduce_plain(dy, y, x, mean),
                       torch.stack([g.abs().sum((0, 2, 3)), (g * xc).abs().sum((0, 2, 3))]),
                       "backward sums")
    del g, xc, xf
    count = x.numel() // x.shape[1]
    c1 = (sums[0] / count).contiguous()
    c2 = torch.where(msq - mean * mean >= 0, rstd * rstd * sums[1] / count, 0.0)
    dx = bn_cu.backward_dx(dy, y, x, mean, inv, c1, c2)
    assert torch.equal(dx, bn_cu.backward_dx_plain(dy, y, x, mean, inv, c1, c2))
    torch.cuda.synchronize()
    assert bn_cu.launches() == {k: v + 1 for k, v in before.items()}

    runs = []
    for fused in (True, False):
        bn = torch.nn.BatchNorm2d(shape[1], eps=1e-5).to(cuda_device)
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        xg = x.clone().requires_grad_(True)
        if fused:
            out = bn_cu.batch_norm_relu(xg, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                        bn.eps, 0.9)
        else:
            from v2x_sim_tpu_torch.models.backbone import _bn

            out = torch.relu(_bn(xg, bn, True))
        out.backward(dy)
        runs.append({"y": out.detach(), "dx": xg.grad, "dweight": bn.weight.grad,
                     "dbias": bn.bias.grad, "running_mean": bn.running_mean,
                     "running_var": bn.running_var})
        del out, xg
    torch.cuda.synchronize()
    # The two layers' moments are float32 sums in other orders (the
    # kernel's, PyTorch's CUDA mean), so an output near 0 may move by
    # their difference times inv, beyond its own ulp (as
    # tests/test_torch_bf16.py allows flax's BatchNorm against the port's).
    _assert_same_layer(*runs, y_atol=BN_NEAR_ZERO)


@pytest.mark.gpu
def test_batchnorm_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.randn(2, 32, 8, 8, device=cuda_device).contiguous(memory_format=torch.channels_last)
    v = torch.zeros(32, device=cuda_device)
    with pytest.raises(TypeError):
        bn_cu.moments(x)  # float32
    with pytest.raises(ValueError):
        bn_cu.moments(x.to(torch.bfloat16).contiguous())  # NCHW memory
    with pytest.raises(ValueError):
        bn_cu.moments(torch.zeros(2, 12, 8, 8, dtype=torch.bfloat16, device=cuda_device)
                      .contiguous(memory_format=torch.channels_last))  # C not a multiple of 8
    with pytest.raises(ValueError):
        bn_cu.normalize_relu(x.to(torch.bfloat16), v, v.double(), v)  # a float64 vector
    with pytest.raises(TypeError):
        bn_cu.batch_norm_relu(x, v, v, v, v.clone(), 1e-5, 0.9)


@pytest.mark.gpu
def test_batchnorm_launches_of_a_bf16_train_step(cuda_device):
    """A bf16 DiscoNet train forward and backward launches each pass 18
    times (10 BatchNorms in the encoder, 8 in the decoder); a bf16
    inference forward normalize_relu 18 times and no other pass."""
    from v2x_sim_tpu_torch.configs.config import Config, GridConfig
    from v2x_sim_tpu_torch.models.det.net import DetModel

    cfg = Config(grid=GridConfig(voxel_size=(1.0, 1.0, 0.625)))
    model = DetModel(cfg, "disco").to(cuda_device)
    h, w, d = cfg.grid.grid_shape
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    occ = (torch.rand(2, cfg.num_agents, h, w, d, device=cuda_device, generator=gen) < 0.05)
    occ = occ.to(torch.bfloat16)
    trans = torch.eye(4, device=cuda_device).expand(2, cfg.num_agents, cfg.num_agents, 4, 4)
    mask = torch.ones(2, cfg.num_agents, dtype=torch.bool, device=cuda_device)
    bn_cu.reset_launches()
    with torch.no_grad():
        model(occ, trans.contiguous(), mask)
    torch.cuda.synchronize()
    assert bn_cu.launches() == {"moments": 0, "normalize_relu": 18, "backward_reduce": 0,
                                "backward_dx": 0}
    bn_cu.reset_launches()
    out = model(occ, trans.contiguous(), mask, train=True)
    out.cls_logits.float().sum().backward()
    torch.cuda.synchronize()
    assert bn_cu.launches() == {name: 18 for name in ("moments", "normalize_relu",
                                                      "backward_reduce", "backward_dx")}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", (BN_SHAPES[0], BN_SHAPES[-1]), ids=lambda s: f"c{s[1]}")
def test_batchnorm_inference_takes_normalize_relu_on_card(cuda_device, shape):
    """A bf16 inference bn_relu with no graph recorded: one normalize_relu
    launch on the running stats, normalize_relu_plain's output bit for bit
    given the same (C,) vectors, the running stats untouched, and within
    the one-ulp share of relu(_bn(..., False)) (ATen folds the affine
    into x * a + b, so an output near 0 may also differ by float32's
    error of that sum, as in the training test)."""
    from tests.test_torch_batchnorm import _assert_one_ulp_apart
    from v2x_sim_tpu_torch.models.backbone import _bn, bn_relu

    x, _, weight, bias = _bn_operands(shape, cuda_device, seed=shape[1] + 2)
    c = shape[1]
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    bn = torch.nn.BatchNorm2d(c, eps=1e-5).to(cuda_device)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(torch.randn(c, device=cuda_device, generator=gen) * 0.8)
        bn.running_var.copy_(torch.rand(c, device=cuda_device, generator=gen) * 3 + 0.1)
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    before = bn_cu.launches()
    with torch.inference_mode():
        y = bn_relu(x, bn, False)
        want = torch.relu(_bn(x, bn, False))
    torch.cuda.synchronize()
    assert bn_cu.launches() == {**before, "normalize_relu": before["normalize_relu"] + 1}
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        plain = bn_cu.normalize_relu_plain(x, bn.running_mean, inv, bn.bias)
    assert torch.equal(y, plain)
    assert torch.equal(bn.running_mean, stats[0]) and torch.equal(bn.running_var, stats[1])
    _assert_one_ulp_apart(y, want, "y", BN_NEAR_ZERO)


@pytest.mark.gpu
def test_batchnorm_launches_of_a_bf16_predict_forward(cuda_device):
    """A bf16 DetModel inference forward at width_mult 0.25 launches
    normalize_relu 18 times and no other pass; a float32 one none."""
    from v2x_sim_tpu_torch.configs.config import Config, GridConfig
    from v2x_sim_tpu_torch.models.det.net import DetModel

    cfg = Config(grid=GridConfig(voxel_size=(1.0, 1.0, 0.625)))
    model = DetModel(cfg, "disco", width_mult=0.25).to(cuda_device,
                                                       memory_format=torch.channels_last)
    h, w, d = cfg.grid.grid_shape
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    occ = (torch.rand(2, cfg.num_agents, h, w, d, device=cuda_device, generator=gen) < 0.05)
    trans = torch.eye(4, device=cuda_device).expand(2, cfg.num_agents, cfg.num_agents, 4, 4)
    mask = torch.ones(2, cfg.num_agents, dtype=torch.bool, device=cuda_device)
    before = bn_cu.launches()
    with torch.inference_mode():
        model(occ.float(), trans.contiguous(), mask)
        torch.cuda.synchronize()
        assert bn_cu.launches() == before
        model(occ.to(torch.bfloat16), trans.contiguous(), mask)
    torch.cuda.synchronize()
    assert bn_cu.launches() == {**before, "normalize_relu": before["normalize_relu"] + 18}


#: The decoder's stage inputs of a B=16 DiscoNet call (16 scenes x 6
#: agents): (N, C, h, w) of x and the skip's Cs; then odd small shapes.
UPSAMPLE_SHAPES = ((96, 512, 16, 16, 256), (96, 256, 32, 32, 128), (96, 128, 64, 64, 64),
                   (96, 64, 128, 128, 32), (3, 8, 1, 1, 8), (2, 16, 5, 7, 24), (1, 24, 3, 2, 8))


def _upsample_operands(shape, device, seed):
    """x, its skip and the concatenation's cotangent: channels-last bf16,
    magnitudes over six decades in x."""
    n, c, h, w, cs = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, h, w, c, device=device, generator=gen)
    x = x * torch.pow(10.0, torch.rand(n, h, w, c, device=device, generator=gen) * 6 - 3)
    skip = torch.randn(n, 2 * h, 2 * w, cs, device=device, generator=gen)
    dy = torch.randn(n, 2 * h, 2 * w, c + cs, device=device, generator=gen)
    return tuple(t.to(torch.bfloat16).permute(0, 3, 1, 2) for t in (x, skip, dy))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_upsample_kernels_match_plain_on_card(cuda_device, shape):
    """Both entries of csrc/upsample.cu against their plain versions bit
    for bit, the forward also against the upsample and cat it replaces;
    the backward twice, the same bits; one launch a call."""
    from v2x_sim_tpu_torch.models.backbone import upsample_bilinear
    from v2x_sim_tpu_torch.ops.cuda import upsample_cu

    x, skip, dy = _upsample_operands(shape, cuda_device, seed=shape[1] + shape[2])
    c, h, w = x.shape[1:]
    before = upsample_cu.launches()
    out = upsample_cu.forward(x, skip)
    assert out.is_contiguous(memory_format=torch.channels_last)
    bits = out.contiguous().view(torch.int16)
    assert torch.equal(bits, upsample_cu.forward_plain(x, skip).contiguous().view(torch.int16))
    today = torch.cat([upsample_bilinear(x, (2 * h, 2 * w)), skip], dim=1)
    assert torch.equal(out, today)  # values: -0 and +0 agree
    dx = upsample_cu.backward(dy, c)
    again = upsample_cu.backward(dy, c)
    torch.cuda.synchronize()
    assert torch.equal(dx.view(torch.int16), again.view(torch.int16))
    assert torch.equal(dx, upsample_cu.backward_plain(dy, c))
    assert upsample_cu.launches() == {"forward": before["forward"] + 1,
                                      "backward": before["backward"] + 2}


@pytest.mark.gpu
def test_upsample_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from v2x_sim_tpu_torch.ops.cuda import upsample_cu

    x, skip, dy = _upsample_operands((2, 16, 4, 4, 8), cuda_device, seed=1)
    with pytest.raises(TypeError):
        upsample_cu.forward(x.float(), skip)  # float32
    with pytest.raises(ValueError):
        upsample_cu.forward(x.contiguous(), skip)  # NCHW memory
    with pytest.raises(ValueError):
        upsample_cu.forward(x[:, :12].contiguous(memory_format=torch.channels_last), skip)
    with pytest.raises(ValueError):
        upsample_cu.forward(x, skip[:, :, :7])  # not twice x's size
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    shifted = flat[1:].view(2, 4, 4, 16).permute(0, 3, 1, 2)  # 2 bytes past alignment
    with pytest.raises(ValueError):
        upsample_cu.forward(shifted, skip)
    with pytest.raises(ValueError):
        upsample_cu.backward(dy, 12)  # c not a multiple of 8
    with pytest.raises(ValueError):
        upsample_cu.backward(dy, 24)  # no skip channels left
    with pytest.raises(TypeError):
        upsample_cu.UpsampleCat.apply(x.float(), skip.float())


@pytest.mark.gpu
def test_upsample_launches_of_a_bf16_train_step(cuda_device):
    """A bf16 DiscoNet forward launches the forward entry 4 times (one a
    decoder stage), in inference and in training, and its backward the
    backward entry 4 times; float32 none."""
    from v2x_sim_tpu_torch.configs.config import Config, GridConfig
    from v2x_sim_tpu_torch.models.det.net import DetModel
    from v2x_sim_tpu_torch.ops.cuda import upsample_cu

    cfg = Config(grid=GridConfig(voxel_size=(1.0, 1.0, 0.625)))
    model = DetModel(cfg, "disco").to(cuda_device, memory_format=torch.channels_last)
    h, w, d = cfg.grid.grid_shape
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    occ = (torch.rand(2, cfg.num_agents, h, w, d, device=cuda_device, generator=gen) < 0.05)
    trans = torch.eye(4, device=cuda_device).expand(2, cfg.num_agents, cfg.num_agents, 4, 4)
    mask = torch.ones(2, cfg.num_agents, dtype=torch.bool, device=cuda_device)
    upsample_cu.reset_launches()
    with torch.no_grad():
        model(occ.float(), trans.contiguous(), mask)
        model(occ.to(torch.bfloat16), trans.contiguous(), mask)
    torch.cuda.synchronize()
    assert upsample_cu.launches() == {"forward": 4, "backward": 0}
    out = model(occ.to(torch.bfloat16), trans.contiguous(), mask, train=True)
    out.cls_logits.float().sum().backward()
    torch.cuda.synchronize()
    assert upsample_cu.launches() == {"forward": 8, "backward": 4}
