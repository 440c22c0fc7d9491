"""The weights drawn by the owning module's type (``harness/weights.py``):
the disconet and v2vnet state dicts equal bit for bit to the draw by shape
and name that came before it; attention logits behind a LayerNorm at unit
scale under the new rules and all but uniform under the old; and each
rule on a module of its own."""

import math

import pytest
import torch
import torch.nn as nn

from benchmark.harness import cell as C
from benchmark.harness.weights import make_state_dict


def _by_shape_and_name(model, seed, device):
    """``harness/weights.py::make_state_dict`` as it was before the rules
    went by module type (commit 788702d)."""
    shapes = {k: v for k, v in model.state_dict().items()}
    floats = [k for k, v in shapes.items() if v.is_floating_point()]
    total = sum(shapes[k].numel() for k in floats)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, v in shapes.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        n = draw[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
        leaf = k.rsplit(".", 1)[-1]
        if v.dim() == 4:
            out[k] = n * math.sqrt(2.0 / v[0].numel())
        elif ".bn" not in k:
            out[k] = n * 0.05
        elif leaf == "weight":
            out[k] = 1.0 + 0.1 * n
        elif leaf == "running_var":
            out[k] = torch.exp(0.2 * n)
        else:
            out[k] = 0.1 * n
    return out


@pytest.mark.parametrize("cell", ["disco_train", "v2v_predict"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 3141592653])
def test_the_configurations_draws_are_unchanged(cell, seed):
    model = C.skeleton(C.load_cell(cell))
    new, old = make_state_dict(model, seed, "cpu"), _by_shape_and_name(model, seed, "cpu")
    assert list(new) == list(old)
    for k in old:
        assert new[k].dtype == old[k].dtype and torch.equal(new[k], old[k]), k


class Attention(nn.Module):
    """A pre-LayerNorm attention's logits with an edge type's relation
    table, as V2X-ViT's heterogeneous attention forms them: 8 heads of 32."""

    def __init__(self, width=256, heads=8, types=4):
        super().__init__()
        self.heads, self.d = heads, width // heads
        self.norm = nn.LayerNorm(width)
        self.q = nn.Linear(width, width)
        self.k = nn.Linear(width, width)
        self.relation = nn.Parameter(torch.empty(types, heads, self.d, self.d))

    def forward(self, x):
        y = self.norm(x)
        q = self.q(y).reshape(-1, self.heads, self.d)
        k = self.k(y).reshape(-1, self.heads, self.d)
        qw = torch.einsum("nhd,hde->nhe", q, self.relation[0])
        return torch.einsum("nhe,mhe->hnm", qw, k) / math.sqrt(self.d)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_attention_logits_have_unit_scale(seed):
    model = Attention()
    x = torch.randn(256, 256, generator=torch.Generator().manual_seed(seed))
    stds = {}
    for name, draw in (("new", make_state_dict), ("old", _by_shape_and_name)):
        model.load_state_dict(draw(model, seed, "cpu"))
        with torch.no_grad():
            stds[name] = float(model(x).std())
    assert 0.5 < stds["new"] < 2.0 and stds["old"] < 0.05, stds


class Every(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(4, 6, 3)
        self.bn = nn.BatchNorm2d(6)
        self.lin = nn.Linear(400, 300)
        self.ln = nn.LayerNorm(300)
        self.gn = nn.GroupNorm(2, 6)
        self.emb = nn.Embedding(50, 64)
        self.table = nn.Parameter(torch.empty(3, 900))


def test_each_rule():
    torch.manual_seed(0)
    sd = make_state_dict(Every(), 5, "cpu")
    std = lambda k: float(sd[k].std())
    assert std("conv.weight") == pytest.approx(math.sqrt(2 / 36), rel=0.15)
    assert std("conv.bias") < 0.15 and std("lin.bias") < 0.1
    assert std("lin.weight") == pytest.approx(1 / 20, rel=0.05)
    assert std("emb.weight") == pytest.approx(1.0, rel=0.05)
    assert std("table") == pytest.approx(1 / 30, rel=0.05)
    for norm in ("bn", "ln", "gn"):
        assert (sd[f"{norm}.weight"] - 1).abs().max() < 0.6 and std(f"{norm}.bias") < 0.2
    assert (sd["bn.running_var"] > 0).all() and sd["bn.num_batches_tracked"] == 0


def test_a_float_buffer_outside_a_norm_layer_raises():
    m = nn.Linear(3, 3)
    m.register_buffer("scale", torch.ones(3))
    with pytest.raises(ValueError, match="no rule for the float buffer 'scale'"):
        make_state_dict(m, 0, "cpu")
