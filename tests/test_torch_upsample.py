"""The decoder's fused stage input of bf16 maps (ops/cuda/upsample_cu.py):
``cat([upsample_bilinear(x, 2x), skip])`` and its gradient, on the CPU,
where the Function runs the plain versions of its two entries.

Held: the plain forward bit for bit to the form it replaces,
``torch.cat([models/backbone.py::upsample_bilinear(x, ...), skip], 1)`` in
bf16, at the decoder's four stage widths, sizes 1, 2 and odd, and values
over six decades; the plain backward to float64 autograd of the bilinear
upsample within the two bf16 roundings it takes, and equal from run to
run; ``upsample_cat`` leaving float32, float64, sizes that do not double,
channels that are not multiples of 8 and row shards on the two ops, bit
for bit; and the Function's calls in a bf16 DetModule train step and
predict, and in a bf16 SegModel. The kernels themselves are held to these
plain versions on the card (tests/test_torch_cuda.py).
"""

import copy

import numpy as np
import pytest
import torch

from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models import backbone
from v2x_sim_tpu_torch.models.backbone import upsample_bilinear, upsample_cat, upsample_like
from v2x_sim_tpu_torch.models.seg.unet import SegModel
from v2x_sim_tpu_torch.ops.cuda import upsample_cu
from v2x_sim_tpu_torch.parallel import spatial
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

#: (C, Cs, h, w): the decoder's four stage inputs at full width on small
#: maps, then sizes 1, 2 and odd, and a skip wider than x.
STAGES = [(512, 256, 2, 2), (256, 128, 4, 3), (128, 64, 6, 8), (64, 32, 9, 9)]
EDGES = [(8, 8, 1, 1), (8, 16, 2, 1), (16, 8, 1, 5), (24, 40, 3, 7), (8, 8, 5, 2)]
#: A bf16 rounding, relative (8 significant bits: half an ulp at most).
BF16_EPS = 2.0 ** -8


def _map(rng, n, c, h, w, decades=0.0):
    """A bf16 NCHW map in channels-last memory; ``decades`` spreads the
    magnitudes over 10^-decades to 10^decades."""
    v = rng.normal(0.0, 1.0, (n, h, w, c))
    if decades:
        v *= 10.0 ** rng.uniform(-decades, decades, (n, h, w, c))
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).permute(0, 3, 1, 2)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _today(x, skip):
    return torch.cat([upsample_bilinear(x, (2 * x.shape[2], 2 * x.shape[3])), skip], dim=1)


@pytest.mark.parametrize("c, cs, h, w", STAGES + EDGES, ids=lambda v: str(v))
def test_plain_forward_equals_upsample_and_cat_bit_for_bit(c, cs, h, w):
    rng = np.random.default_rng(c * 100 + h * 10 + w)
    for decades in (0.0, 3.0):
        x, skip = _map(rng, 2, c, h, w, decades), _map(rng, 2, cs, 2 * h, 2 * w)
        got = upsample_cu.forward_plain(x, skip)
        want = _today(x, skip)
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(_bits(got), _bits(want))


def test_plain_forward_at_the_edges():
    """Constant rows and columns stay constant; an edge row equals its
    input row; at size 1 every output is the input."""
    rng = np.random.default_rng(1)
    x, skip = _map(rng, 1, 8, 4, 5), _map(rng, 1, 8, 8, 10)
    out = upsample_cu.forward_plain(x, skip)[:, :8]
    assert torch.equal(out[:, :, 0, 0], x[:, :, 0, 0]) and torch.equal(out[:, :, -1, -1],
                                                                          x[:, :, -1, -1])
    flat = torch.full((1, 8, 3, 3), 1.3, dtype=torch.bfloat16)
    out = upsample_cu.forward_plain(flat, _map(rng, 1, 8, 6, 6))[:, :8]
    assert bool((out == flat[0, 0, 0, 0]).all())
    one = _map(rng, 2, 16, 1, 1)
    assert bool((upsample_cu.forward_plain(one, _map(rng, 2, 8, 2, 2))[:, :16] == one).all())


def _float64_grad(x, dy, c):
    """dx of the bilinear upsample in float64 autograd, and the same
    transpose of |dy| (the magnitude the roundings scale with)."""
    h, w = x.shape[2:]
    grads = []
    for g in (dy[:, :c].double(), dy[:, :c].double().abs()):
        x64 = x.double().requires_grad_(True)
        torch.nn.functional.interpolate(x64, size=(2 * h, 2 * w), mode="bilinear",
                                        align_corners=False).backward(g)
        grads.append(x64.grad)
    return grads


@pytest.mark.parametrize("c, cs, h, w", STAGES + EDGES[:3], ids=lambda v: str(v))
def test_plain_backward_is_the_upsample_transpose_rounded_twice(c, cs, h, w):
    """dx within the two bf16 roundings of float64's: the intermediate
    rows' (each at most BF16_EPS / 2 of its terms' magnitudes) and dx's
    own; the skip's gradient is the slice after C; two runs give the same
    bits."""
    rng = np.random.default_rng(c + h + w)
    x, skip = _map(rng, 2, c, h, w), _map(rng, 2, cs, 2 * h, 2 * w)
    dy = _map(rng, 2, c + cs, 2 * h, 2 * w, decades=1.0)
    runs = []
    for _ in range(2):
        xg, sg = x.clone().requires_grad_(True), skip.clone().requires_grad_(True)
        upsample_cat(xg, sg).backward(dy)
        runs.append((xg.grad, sg.grad))
    (dx, dskip), (dx2, dskip2) = runs
    assert torch.equal(_bits(dx), _bits(dx2)) and torch.equal(dskip, dskip2)
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
    assert torch.equal(dskip, dy[:, c:])
    want, magnitude = _float64_grad(x, dy, c)
    gap = (dx.double() - want).abs()
    assert bool((gap <= BF16_EPS * (magnitude + want.abs()) + 1e-30).all()), (
        float((gap / (magnitude + want.abs())).max()))
    assert torch.equal(dx, upsample_cu.backward_plain(dy, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_float32_and_float64_keep_the_two_ops(monkeypatch, dtype):
    calls = _count_calls(monkeypatch)
    rng = np.random.default_rng(4)
    x, skip = _map(rng, 2, 64, 5, 6).to(dtype), _map(rng, 2, 32, 10, 12).to(dtype)
    runs = []
    for form in (upsample_cat, lambda x, s: torch.cat([upsample_like(x, s), s], dim=1)):
        xg, sg = x.clone().requires_grad_(True), skip.clone().requires_grad_(True)
        out = form(xg, sg)
        out.backward(torch.ones_like(out))
        runs.append((out.detach(), xg.grad, sg.grad))
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    assert calls == {}


@pytest.mark.parametrize("shapes", [((8, 5, 6), (8, 9, 12)), ((8, 5, 6), (8, 10, 11)),
                                    ((12, 4, 4), (8, 8, 8)), ((8, 4, 4), (4, 8, 8))],
                         ids=["rows-not-doubled", "columns-not-doubled", "c-not-8",
                              "cs-not-8"])
def test_other_shapes_keep_the_two_ops(monkeypatch, shapes):
    """Sizes that do not double (a pooled odd map) and channels that are
    not multiples of 8: the bf16 upsample and cat as before, bit for bit."""
    calls = _count_calls(monkeypatch)
    rng = np.random.default_rng(5)
    (c, h, w), (cs, hs, ws) = shapes
    x, skip = _map(rng, 2, c, h, w), _map(rng, 2, cs, hs, ws)
    want = torch.cat([upsample_bilinear(x, (hs, ws)), skip], dim=1)
    assert torch.equal(_bits(upsample_cat(x, skip)), _bits(want))
    assert calls == {}


def test_row_shards_keep_the_halo_upsample(monkeypatch):
    """With a spatial group, a bf16 map goes to the sharded upsample
    (``spatial.upsample_bilinear_halo``; its own exchange is held on gloo
    ranks by tests/test_torch_spatial_model.py) and cat, never the Function."""
    calls = _count_calls(monkeypatch)
    seen = []

    def halo(x, group):
        seen.append(group)
        return upsample_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]))

    monkeypatch.setattr(spatial, "upsample_bilinear_halo", halo)
    rng = np.random.default_rng(6)
    x, skip = _map(rng, 2, 16, 4, 4), _map(rng, 2, 8, 8, 8)
    group = object()
    assert torch.equal(_bits(upsample_cat(x, skip, group)), _bits(_today(x, skip)))
    assert seen == [group] and calls == {}


def test_skip_of_another_dtype_is_cast_as_before():
    rng = np.random.default_rng(7)
    x, skip = _map(rng, 1, 16, 3, 3), _map(rng, 1, 8, 6, 6).float()
    assert torch.equal(_bits(upsample_cat(x, skip)), _bits(_today(x, skip.to(torch.bfloat16))))


def test_entries_reject_what_they_do_not_take():
    rng = np.random.default_rng(8)
    x, skip = _map(rng, 1, 16, 3, 3), _map(rng, 1, 8, 6, 6)
    with pytest.raises(TypeError):
        upsample_cu.UpsampleCat.apply(x.float(), skip.float())
    with pytest.raises(ValueError):
        upsample_cu.forward(x, skip[:, :, :5])
    with pytest.raises(ValueError):
        upsample_cu.forward(x, skip.to("meta"))


def _count_calls(monkeypatch):
    """Counts the CPU calls of each entry (the launch counters count only
    the card's)."""
    calls = {}
    for fn in upsample_cu.WRAPPERS:
        def counted(*args, _fn=fn):
            calls[_fn.__name__] = calls.get(_fn.__name__, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(upsample_cu, fn.__name__, counted)
    return calls


def test_bf16_det_module_calls_each_entry_once_a_decoder_stage(monkeypatch):
    """A bf16 DetModule train step calls the forward entry 4 times and the
    backward 4 times (the decoder's four stages), its predict the forward
    4 times; no launch on the CPU."""
    cfg = Config(grid=GridConfig(voxel_size=(2.0, 2.0, 1.25)))
    module = DetModule(cfg, "disco", torch.bfloat16, device="cpu", width_mult=0.25)
    batch = generate_batch(cfg, SyntheticSpec(points_per_agent=512, max_gt=8), 1, seed=3)
    prepared = module.prepare_batch(batch)
    calls = _count_calls(monkeypatch)
    upsample_cu.reset_launches()
    metrics = module.train_step(prepared)
    assert bool(torch.isfinite(metrics["loss"]))
    assert calls == {"forward": 4, "backward": 4}
    calls.clear()
    module.predict({k: batch[k] for k in ("points", "point_mask", "trans", "agent_mask")}, 8)
    assert calls == {"forward": 4}
    assert upsample_cu.launches() == {"forward": 0, "backward": 0}


def test_bf16_det_forward_equals_the_two_ops_bit_for_bit(monkeypatch):
    """The whole bf16 DetModel forward, eval and train mode, with the
    Function and with the two ops in its place: the same logits."""
    cfg = Config(grid=GridConfig(voxel_size=(2.0, 2.0, 1.25)))
    module = DetModule(cfg, "disco", torch.bfloat16, device="cpu", width_mult=0.25)
    prepared = module.prepare_batch(generate_batch(cfg, SyntheticSpec(points_per_agent=512,
                                                                      max_gt=8), 1, seed=4))
    args = (prepared["occupancy"], prepared["trans"], prepared["agent_mask"].to(torch.bool))
    state = copy.deepcopy(module.model.state_dict())
    runs = []
    for fused in (True, False):
        module.model.load_state_dict(state)
        if not fused:
            monkeypatch.setattr(backbone, "upsample_cat", lambda x, skip, group=None: torch.cat(
                [upsample_like(x, skip, group), skip.to(x.dtype)], dim=1))
        torch.manual_seed(0)
        with torch.no_grad():
            eval_out = module.model(*args)
            train_out = module.model(*args, train=True)
        runs.append([eval_out.cls_logits, eval_out.reg, train_out.cls_logits, train_out.reg])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_bf16_seg_decoder_calls_the_forward_where_sizes_double(monkeypatch):
    """The seg UNet's up stages go through the same helper: at a 32 x 32
    map each of its 3 stages doubles and takes the Function."""
    cfg = Config(grid=GridConfig(voxel_size=(2.0, 2.0, 1.25)))
    model = SegModel(cfg, "disco", width_mult=0.25)
    h, w, d = cfg.grid.grid_shape
    occ = torch.from_numpy((np.random.default_rng(9).random((1, cfg.num_agents, h, w, d))
                            < 0.05).astype(np.float32)).to(torch.bfloat16)
    trans = torch.eye(4).expand(1, cfg.num_agents, cfg.num_agents, 4, 4).contiguous()
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        model(occ, trans, torch.ones(1, cfg.num_agents, dtype=torch.bool))
    assert calls == {"forward": len(model.ups)}
