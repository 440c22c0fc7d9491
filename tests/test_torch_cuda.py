"""The rotated-IoU kernel wrapper (ops/cuda/iou_cu.py), all three entry
points: their CPU route, their input checks, and — on a CUDA card only —
the CUDA kernel against the plain PyTorch version.

This file imports neither JAX nor tests/conftest.py's setup, so it runs
on the card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from v2x_sim_tpu_torch.ops import iou_sh
from v2x_sim_tpu_torch.ops.cuda import iou_cu


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
    """Both entry points of csrc/rotated_iou.cu against the plain version.
    atol 1e-4: the kernel's FMA contraction rounds differently from
    PyTorch's separate ops (measured max ~6e-6 on the H100)."""
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
    (K2 twice, K1's aligned pairs at least once) against the same call on
    the CPU (the plain versions): labels equal away from the thresholds,
    targets and IoU within 1e-5."""
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
    assert iou_cu.rotated_iou_pairs_soa.launches >= 1
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
