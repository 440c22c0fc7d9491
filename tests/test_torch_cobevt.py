"""CoBEVT's fused axial attention (``models/det/cobevt.py``, the port's
``cobevt`` mode) against its plain float32 reference
(``baselines/cobevt_ref.py``) on the CPU, at a small size: 2 scenes of 6
agents, 32 channels, 16x16 maps, windows 2 and 4, 2 layers, dim_head 8
(4 heads), FFN 32, weights drawn so that attention logits have a std of
about 1 (``tests/test_torch_v2xvit.py::draw_``; the bias tables n /
sqrt(heads)).

  * the fusion's output, in four settings, and ``DetModel``'s cls and reg
    outputs, to 1e-4 relative in float32; the first gradient of every
    leaf at dropout 0; bf16 within 2% of the output's scale;
  * the relative bias, the local block, the grid block, the agent axis
    and the ego-first slot order each move the ego output by more than
    100x the float32 gap;
  * a masked agent's map changes no ego output; dropout acts only in
    training;
  * the window attention with a bias broadcast over windows and a
    per-sequence key mask against a plain softmax;
  * the mode beside ``MODES``, ``DetModule``'s entries in it, and its
    spans under a profiler.
"""

import math

import pytest
import torch
import torch.nn as nn

from v2x_sim_tpu_torch.baselines.cobevt_ref import Attention as RefAttention
from v2x_sim_tpu_torch.baselines.cobevt_ref import CoBEVTRef
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det import cobevt as X
from v2x_sim_tpu_torch.models.det.net import MODES, PORT_MODES, DetModel, build_fusion, check_mode
from v2x_sim_tpu_torch.models.det.v2xvit import window_attention
from v2x_sim_tpu_torch.models.seg.unet import SegModel
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.test_torch_v2xvit import CFG, WIDTH, A, B, C, RefFusion, _span_paths, draw_, gap, inputs
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

SMALL = dict(depth=2, dim_head=8, mlp_dim=32, window_size=4, dropout=0.1)
#: Relative tolerance of the port against the reference in float32.
F32_TOL = 1e-4
#: bf16 against float32, over the output's largest magnitude. bf16 keeps 8
#: significant bits (a rounding of up to 2^-9, 0.2%, relative); each of
#: the 8 residual parts rounds its LayerNorm output, its GEMM operands and
#: outputs and its attention probabilities, and the head rounds twice more:
#: a few dozen such roundings along the stream, which read 0.8-1.3% of the
#: output's largest magnitude here. 2% leaves room above that and stays
#: far under what each perturbation below moves.
BF16_TOL = 2e-2
#: The first gradient, each leaf's largest gap over its largest entry.
GRAD_TOL = 1e-4


def pair(seed: int = 1, **settings):
    """The port's fusion and the reference, one state dict."""
    kw = {**SMALL, **settings}
    port = draw_(build_fusion("cobevt", CFG.grid, C, A, fusion=kw), seed)
    ref = CoBEVTRef(CFG.grid.area_extents, C, A, **kw)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref


def full_inputs(seed: int = 0):
    """``inputs`` with every agent present."""
    feats, trans, mask = inputs(seed)
    return feats, trans, torch.ones_like(mask)


SETTINGS = {
    "window_4": {},
    "window_2": {"window_size": 2},
    "two_heads": {"dim_head": 16},
    "one_layer_wide_ffn": {"depth": 1, "mlp_dim": 64},
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_fusion_matches_the_reference_in_float32(setting):
    port, ref = pair(**SETTINGS[setting])
    feats, trans, mask = inputs()
    with torch.no_grad():
        want = ref(feats, trans, mask)
        got = port(feats, trans, mask)
    assert got.shape == want.shape == feats.shape
    assert gap(got, want) <= F32_TOL * max(1.0, float(want.abs().max()))


def test_the_relative_index_is_the_video_swin_form():
    ref = RefAttention(C, 8, A, 4)
    port = X.relative_index(A, 4)
    assert torch.equal(port, ref.relative_position_index("cpu"))
    assert port.shape == (A * 16, A * 16) and int(port.max()) == (2 * A - 1) * 7 * 7 - 1
    # Token (slot 5, row 3, column 0) against (slot 0, row 0, column 3):
    # ((5 + 5) 7 + 3 + 3) 7 + (-3 + 3).
    assert int(port[5 * 16 + 3 * 4 + 0, 0 * 16 + 0 * 4 + 3]) == (10 * 7 + 6) * 7 + 0


def test_detmodel_matches_the_reference_in_float32():
    model = draw_(DetModel(CFG, "cobevt", WIDTH, fusion=SMALL), 2)
    assert model.fusion.layers[0].local_norm.normalized_shape == (C,)
    sd = model.state_dict()
    ref_model = DetModel(CFG, "cobevt", WIDTH, fusion=SMALL)
    ref_model.load_state_dict(sd)
    ref = CoBEVTRef(CFG.grid.area_extents, C, A, **SMALL)
    ref.load_state_dict({k[len("fusion."):]: v for k, v in sd.items() if k.startswith("fusion.")})
    ref_model.fusion = RefFusion(ref)
    gen = torch.Generator().manual_seed(3)
    h, w, d = CFG.grid.grid_shape
    occ = (torch.rand(B, A, h, w, d, generator=gen) < 0.05).float()
    _, trans, mask = inputs(4)
    with torch.no_grad():
        got, want = model(occ, trans, mask), ref_model(occ, trans, mask)
    for a, b in ((got.cls_logits, want.cls_logits), (got.reg, want.reg)):
        assert gap(a, b) <= F32_TOL * max(1.0, float(b.abs().max()))


def test_first_gradient_matches_the_reference():
    port, ref = pair(dropout=0.0)
    feats, trans, mask = inputs()
    probe = torch.randn(feats.shape, generator=torch.Generator().manual_seed(5))
    grads = []
    for model in (port, ref):
        x = feats.clone().requires_grad_(True)
        model.zero_grad()
        (model(x, trans, mask, True) * probe).sum().backward()
        leaves = {k: p.grad for k, p in model.named_parameters()}
        grads.append({**leaves, "input": x.grad})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) == 2 * 22 + 4 + 1
    for k, want in grads[1].items():
        assert want.abs().max() > 0, k
        assert gap(grads[0][k], want) <= GRAD_TOL * float(want.abs().max()), k


@pytest.mark.parametrize("window", [2, 4])
def test_bf16_stays_near_float32(window):
    port, ref = pair(window_size=window)
    feats, trans, mask = inputs()
    with torch.no_grad():
        want = ref(feats, trans, mask)
        got = port(feats.bfloat16(), trans, mask)
    assert got.dtype == torch.bfloat16
    assert gap(got.float(), want) <= BF16_TOL * float(want.abs().max())


def _zero(port, pattern):
    with torch.no_grad():
        for name, p in port.named_parameters():
            if pattern(name):
                p.zero_()


POSITION_BIAS = X.FAXAttention.position_bias


def _own_slot_only(self):
    """The bias with every pair of two slots at -inf: each map attends to
    itself alone."""
    bias = POSITION_BIAS(self)
    per_slot = self.window ** 2
    slot = torch.arange(bias.shape[-1]) // per_slot
    return bias.masked_fill(slot[:, None] != slot[None, :], float("-inf"))


def _natural_order(port, mp):
    """Every ego's slots in agent index order: the ego's own map first for
    agent 0 only."""
    port.order.copy_(torch.arange(A).repeat(A, 1))


PERTURBATIONS = {
    "relative_bias_zeroed": lambda port, mp: _zero(port, lambda n: "bias_table" in n),
    "local_block_off": lambda port, mp: _zero(port, lambda n: "local_attn.to_out" in n),
    "grid_block_off": lambda port, mp: _zero(port, lambda n: "grid_attn.to_out" in n),
    "agent_axis_cut": lambda port, mp: mp.setattr(X.FAXAttention, "position_bias",
                                                  _own_slot_only),
    "slots_in_index_order": _natural_order,
}


@pytest.mark.parametrize("perturbation", sorted(PERTURBATIONS))
def test_each_part_moves_the_ego_output(perturbation, monkeypatch):
    port, ref = pair()
    x = full_inputs()
    with torch.no_grad():
        floor = 100 * gap(port(*x), ref(*x))
        before = port(*x)
        PERTURBATIONS[perturbation](port, monkeypatch)
        after = port(*x)
    assert torch.isfinite(after).all()
    assert gap(after, before) > floor > 0


KEY_BIAS = X.CoBEVTFusion.key_bias


def test_a_masked_agent_changes_no_ego_output(monkeypatch):
    port, _ = pair()
    feats, trans, mask = inputs()
    noisy = feats.clone()
    noisy[1, 4:] = 100 * torch.randn(noisy[1, 4:].shape)
    with torch.no_grad():
        a, b = port(feats, trans, mask), port(noisy, trans, mask)
        # With the key bias at zero the padded slots' (zero) maps are keys,
        # and the output moves.
        monkeypatch.setattr(X.CoBEVTFusion, "key_bias",
                            lambda self, m, dt: torch.zeros_like(KEY_BIAS(self, m, dt)))
        c = port(feats, trans, mask)
    assert torch.equal(a, b)
    assert gap(c[1], a[1]) > 1e-3 and torch.equal(c[0], a[0])


def test_dropout_acts_only_in_training():
    port, _ = pair()
    quiet, _ = pair(dropout=0.0)
    feats, trans, mask = inputs()
    with torch.no_grad():
        eval_a, eval_b = port(feats, trans, mask, False), port(feats, trans, mask, False)
        torch.manual_seed(0)
        train_a = port(feats, trans, mask, True)
        train_b = port(feats, trans, mask, True)
        assert torch.equal(eval_a, eval_b) and torch.equal(eval_a, quiet(feats, trans, mask, False))
        assert torch.equal(quiet(feats, trans, mask, True), eval_a)
    assert gap(train_a, eval_a) > 1e-2 and gap(train_a, train_b) > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_with_a_broadcast_bias_and_a_key_mask(dtype):
    """FAX's call: (sequence group x head, window, token, d) operands, one
    bias a group broadcast over its windows, keys masked per group."""
    gen = torch.Generator().manual_seed(8)
    groups, heads, windows, n, d = 3, 2, 5, 24, 8
    q, k, v = (torch.randn(groups * heads, windows, n, d, generator=gen).to(dtype)
               for _ in range(3))
    keys = torch.rand(groups, n, generator=gen) < 0.6
    keys[:, 0] = True
    pos = torch.randn(heads, n, n, generator=gen)
    key_bias = torch.zeros(groups, 1, 1, n).masked_fill(~keys[:, None, None, :], float("-inf"))
    bias = (pos.to(dtype)[None] + key_bias.to(dtype)).reshape(groups * heads, 1, n, n)
    got = window_attention(q, k, v, bias.expand(-1, windows, n, n))
    logits = q.double() @ k.double().transpose(-1, -2) / math.sqrt(d) + bias.double()
    want = torch.softmax(logits, dim=-1) @ v.double()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert gap(got.double(), want) <= tol * float(want.abs().max())
    # A masked key's value reaches no output.
    v2 = v.clone().reshape(groups, heads, windows, n, d)
    v2[~keys[:, None, None, :].expand(-1, heads, windows, n)] = 1e4
    again = window_attention(q, k, v2.reshape(v.shape), bias.expand(-1, windows, n, n))
    assert torch.equal(again, got)


def test_the_mode_sits_beside_the_jax_modes():
    assert PORT_MODES == MODES + ("v2xvit", "cobevt")
    check_mode("cobevt")
    with pytest.raises(ValueError, match="detection-only"):
        SegModel(CFG, "cobevt")
    with pytest.raises(ValueError, match="does not tile"):
        port, _ = pair(window_size=3)
        port(*inputs())
    with pytest.raises(ValueError, match="not a multiple of dim_head"):
        build_fusion("cobevt", CFG.grid, C, A, fusion={"dim_head": 12})


SPEC = SyntheticSpec(points_per_agent=512, num_vehicles=4, max_gt=8)


def _det_module(**kw):
    m = DetModule(CFG, "cobevt", device="cpu", width_mult=WIDTH, fusion=SMALL, **kw)
    draw_(m.model, 7)
    return m


def test_det_module_trains_and_predicts():
    m = _det_module()
    batch = m.to_device(generate_batch(CFG, SPEC, 2, seed=0))
    before = {k: v.clone() for k, v in m.model.fusion.state_dict().items()}
    prepared = m.prepare_batch(batch)
    losses = [float(m.train_step(prepared)["loss"]) for _ in range(2)]
    assert all(math.isfinite(v) for v in losses)
    moved = [k for k, v in m.model.fusion.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
    out = m.predict(batch, 16)
    assert out.boxes.shape == (2, A, 16, 5) and torch.isfinite(out.boxes).all()


def test_the_fusion_opens_its_spans_inside_det_fuse():
    m = _det_module()
    batch = m.to_device(generate_batch(CFG, SPEC, 2, seed=1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.predict(batch, 16)
    paths = _span_paths(prof)
    fuse = "det.predict/det.model/det.fuse"
    inside = {k: v for k, v in paths.items() if k.startswith(fuse + "/")}
    depth = SMALL["depth"]
    assert inside == {f"{fuse}/det.fuse.warp": 1, f"{fuse}/det.fuse.fax_local": depth,
                      f"{fuse}/det.fuse.fax_grid": depth, f"{fuse}/det.fuse.ffn": 2 * depth,
                      f"{fuse}/det.fuse.head": 1}
    assert paths[fuse] == 1


def test_the_state_dict_names_are_the_references():
    port, ref = pair()
    assert isinstance(port.layers[0].local_attn.relative_position_bias_table, nn.Embedding)
    assert port.state_dict().keys() == ref.state_dict().keys()
    assert "layers.0.local_attn.relative_position_index" not in port.state_dict()
