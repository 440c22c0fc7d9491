"""V2X-ViT's fusion (``models/det/v2xvit.py``, the port's ``v2xvit`` mode)
against its plain float32 reference (``baselines/v2xvit_ref.py``) on the
CPU, at a small size: 2 scenes of 6 agents, 32 channels, 16x16 maps,
windows 2, 4 and 8, 2 layers, head counts scaled down (HMSA 4 x 8; MSwin
4 x 8, 2 x 16, 1 x 32; FFN 32), weights drawn so that attention logits
have a std of about 1 (Linear n / sqrt(in), LayerNorm 1 + 0.1 n, relation
and position tables n / sqrt(last axis)).

  * the fusion's output, in six settings, and ``DetModel``'s cls and reg
    outputs, to 1e-4 relative in float32; the first gradient of every
    leaf at dropout 0; bf16 within 2% of the output's scale;
  * the agent types, a relation matrix, the position tables and both
    attentions each move the ego's output by more than 100x the float32
    gap;
  * a masked agent's map, and keys outside an agent's ROI, change no ego
    output; dropout acts only in training;
  * the mode beside ``MODES``, ``DetModule``'s entries in it, and its
    spans under a profiler.
"""

import math

import pytest
import torch
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.nn.modules.conv import _ConvNd

from v2x_sim_tpu_torch.baselines.v2xvit_ref import V2XViTRef
from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det import v2xvit as V
from v2x_sim_tpu_torch.models.det.net import MODES, PORT_MODES, DetModel, build_fusion, check_mode
from v2x_sim_tpu_torch.models.seg.unet import SegModel
from v2x_sim_tpu_torch.ops.warp import roi_all_pairs
from v2x_sim_tpu_torch.train.det_module import DetModule
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

#: A 128x128x8 grid over +-32 m: 16x16 maps of 4 m cells at the fusion layer.
CFG = Config(grid=GridConfig(voxel_size=(0.5, 0.5, 0.625)))
WIDTH = 0.125  # stage widths (8, 8, 16, 32, 64): 32 channels at stage 3
B, A, HW, C = 2, 6, 16, 32
SMALL = dict(depth=2, heads=4, dim_head=8, num_types=2, window_heads=(4, 2, 1),
             window_dim_heads=(8, 16, 32), window_sizes=(2, 4, 8), mlp_dim=32, dropout=0.3)
#: Relative tolerance of the port against the reference in float32.
F32_TOL = 1e-4
#: bf16 against float32, over the output's largest magnitude.
BF16_TOL = 2e-2
#: The first gradient, each leaf's largest gap over its largest entry.
GRAD_TOL = 1e-4


def draw_(model: nn.Module, seed: int) -> nn.Module:
    """Every parameter drawn from ``seed`` by its module's type (see the
    module docstring); convolutions He-normal, BatchNorm as LayerNorm."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                n = torch.randn(p.shape, generator=gen)
                if isinstance(mod, (nn.LayerNorm, _BatchNorm)):
                    p.copy_(1.0 + 0.1 * n if name == "weight" else 0.1 * n)
                elif isinstance(mod, nn.Linear):
                    p.copy_(n / math.sqrt(mod.in_features) if name == "weight" else 0.05 * n)
                elif isinstance(mod, _ConvNd):
                    p.copy_(n * math.sqrt(2.0 / p[0].numel()) if name == "weight" else 0.05 * n)
                else:
                    p.copy_(n / math.sqrt(p.shape[-1]))
    return model


def poses_to_trans(gen: torch.Generator, b: int = B, a: int = A, spread: float = 12.0):
    """(B, A, A, 4, 4) T_{i<-j} of random planar poses (yaw, x, y ~ spread m)."""
    yaw = torch.rand(b, a, generator=gen) * 2 * math.pi
    pose = torch.zeros(b, a, 4, 4)
    pose[..., 0, 0], pose[..., 0, 1] = yaw.cos(), -yaw.sin()
    pose[..., 1, 0], pose[..., 1, 1] = yaw.sin(), yaw.cos()
    pose[..., 2, 2] = pose[..., 3, 3] = 1.0
    pose[..., :2, 3] = torch.randn(b, a, 2, generator=gen) * spread
    return torch.linalg.inv(pose)[:, :, None] @ pose[:, None]


def inputs(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn(B, A, HW, HW, C, generator=gen)
    mask = torch.ones(B, A, dtype=torch.bool)
    mask[1, 4:] = False
    return feats, poses_to_trans(gen), mask


def pair(seed: int = 1, **settings):
    """The port's fusion and the reference, one state dict."""
    kw = {**SMALL, **settings}
    port = draw_(build_fusion("v2xvit", CFG.grid, C, A, fusion=kw), seed)
    ref = V2XViTRef(CFG.grid.area_extents, C, **kw)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port, ref


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def f32_gap(port, ref, x=None) -> float:
    feats, trans, mask = x or inputs()
    with torch.no_grad():
        return gap(port(feats, trans, mask), ref(feats, trans, mask))


SETTINGS = {
    "published": {},
    "one_type": {"num_types": 1},
    "no_roi_mask": {"use_roi_mask": False},
    "naive_merge": {"window_fusion": "naive"},
    "absolute_bias": {"relative_pos_embedding": False},
    "no_rte": {"use_rte": False},
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


class RefFusion(nn.Module):
    """The reference in the port's fusion slot (``train`` ignored)."""

    def __init__(self, ref):
        super().__init__()
        self.ref = ref

    def forward(self, feats, trans, mask, train=False):
        return self.ref(feats, trans, mask)


def test_detmodel_matches_the_reference_in_float32():
    model = draw_(DetModel(CFG, "v2xvit", WIDTH, fusion=SMALL), 2)
    assert model.fusion.layers[0].hmsa_norm.normalized_shape == (C,)
    sd = model.state_dict()
    ref_model = DetModel(CFG, "v2xvit", WIDTH, fusion=SMALL)
    ref_model.load_state_dict(sd)
    ref = V2XViTRef(CFG.grid.area_extents, C, **SMALL)
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
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 40
    for k, want in grads[1].items():
        assert want.abs().max() > 0, k
        assert gap(grads[0][k], want) <= GRAD_TOL * float(want.abs().max()), k


def test_bf16_stays_near_float32():
    port, ref = pair()
    feats, trans, mask = inputs()
    with torch.no_grad():
        want = ref(feats, trans, mask)
        got = port(feats.bfloat16(), trans, mask)
    assert got.dtype == torch.bfloat16
    assert gap(got.float(), want) <= BF16_TOL * float(want.abs().max())


def _all_vehicles(a, n):
    return [V.VEHICLE] * a


def _uniform_keys(logits, keys):
    w = keys.float()
    return (w / w.sum(-1, keepdim=True)).expand_as(logits)


def _uniform_window(q, k, v, bias):
    flat = torch.where(torch.isinf(bias), bias, torch.zeros_like(bias))
    return torch.nn.functional.scaled_dot_product_attention(torch.zeros_like(q), k, v,
                                                            attn_mask=flat)


def _zero(port, pattern):
    with torch.no_grad():
        for name, p in port.named_parameters():
            if pattern(name):
                p.zero_()


PERTURBATIONS = {
    "agent_0_a_vehicle": lambda port, mp: mp.setattr(V, "agent_types", _all_vehicles),
    "relation_matrix_zeroed": lambda port, mp: _zero(port, lambda n: n.endswith("relation_att")),
    "position_tables_zeroed": lambda port, mp: _zero(port, lambda n: "pos_embedding" in n),
    "hmsa_uniform": lambda port, mp: mp.setattr(V, "key_softmax", _uniform_keys),
    "mswin_uniform": lambda port, mp: mp.setattr(V, "window_attention", _uniform_window),
}


@pytest.mark.parametrize("perturbation", sorted(PERTURBATIONS))
def test_each_part_moves_the_ego_output(perturbation, monkeypatch):
    port, ref = pair()
    x = inputs()
    floor = 100 * f32_gap(port, ref, x)
    with torch.no_grad():
        before = port(*x)
        PERTURBATIONS[perturbation](port, monkeypatch)
        after = port(*x)
    assert gap(after, before) > floor > 0


def test_a_masked_agent_changes_no_ego_output():
    port, _ = pair()
    feats, trans, mask = inputs()
    noisy = feats.clone()
    noisy[1, 4:] = 100 * torch.randn(noisy[1, 4:].shape)
    with torch.no_grad():
        a, b = port(feats, trans, mask), port(noisy, trans, mask)
    assert torch.equal(a[:, :4], b[:, :4]) and torch.equal(a[0], b[0])


def test_keys_outside_the_roi_change_no_ego_output():
    port, _ = pair()
    feats, trans, mask = inputs()
    hmsa, types = port.layers[0].hmsa, V.agent_types(A, 2)
    keys = port.key_mask(trans, mask, types, HW, HW)
    roi = roi_all_pairs(trans, CFG.grid, HW, HW)  # (B, Ai, Aj, h, w)
    eye = torch.eye(A, dtype=torch.bool)[None, :, :, None, None]
    outside = (~roi & ~eye)[..., None]
    assert 0.05 < float(outside.float().mean()) < 0.95
    y = torch.randn(B, A, A, HW, HW, C, generator=torch.Generator().manual_seed(6))
    ego = torch.arange(A)
    with torch.no_grad():
        base = hmsa(y, keys, types, False)[:, ego, ego]
        out = hmsa(torch.where(outside, 50 * torch.randn_like(y), y), keys, types, False)
        inside = hmsa(torch.where(roi[..., None] & ~eye[..., None], 50 * torch.randn_like(y), y),
                      keys, types, False)
    assert gap(out[:, ego, ego], base) <= 1e-5
    assert gap(inside[:, ego, ego], base) > 1e-2


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


def test_the_mode_sits_beside_the_jax_modes():
    assert MODES == ("lowerbound", "upperbound", "sum", "mean", "max", "cat", "agent",
                     "when2com", "who2com", "v2v", "disco")
    assert PORT_MODES == MODES + ("v2xvit", "cobevt")
    check_mode("v2xvit")
    with pytest.raises(ValueError, match="detection-only"):
        check_mode("v2xvit", MODES)
    with pytest.raises(ValueError, match="detection-only"):
        SegModel(CFG, "v2xvit")
    with pytest.raises(ValueError, match="unknown mode"):
        check_mode("v2xvit_x")


SPEC = SyntheticSpec(points_per_agent=512, num_vehicles=4, max_gt=8)


def _det_module(**kw):
    m = DetModule(CFG, "v2xvit", device="cpu", width_mult=WIDTH, fusion=SMALL, **kw)
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


def _span_paths(prof):
    paths = {}
    for e in prof.events():
        if not e.name.startswith("det."):
            continue
        names, p = [], e
        while p is not None:
            if p.name.startswith("det."):
                names.append(p.name)
            p = p.cpu_parent
        key = "/".join(reversed(names))
        paths[key] = paths.get(key, 0) + 1
    return paths


def test_the_fusion_opens_its_spans_inside_det_fuse():
    m = _det_module()
    batch = m.to_device(generate_batch(CFG, SPEC, 2, seed=1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.predict(batch, 16)
    paths = _span_paths(prof)
    fuse = "det.predict/det.model/det.fuse"
    inside = {k: v for k, v in paths.items() if k.startswith(fuse + "/")}
    assert inside == {f"{fuse}/det.fuse.sttf": 1, f"{fuse}/det.fuse.hmsa": SMALL["depth"],
                      f"{fuse}/det.fuse.mswin": SMALL["depth"],
                      f"{fuse}/det.fuse.ffn": SMALL["depth"]}
    assert paths[fuse] == 1
