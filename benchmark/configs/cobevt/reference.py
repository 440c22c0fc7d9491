"""CoBEVT's fused axial attention, FAX (arXiv:2207.02202), the part of the
reference that only the ``cobevt`` configuration has, written from the
paper's section 3 and the public code's ``SwapFusionEncoder``
(github.com/DerrickXuNu/CoBEVT, inside OpenCOOD:
``opencood/models/fuse_modules/swap_fusion_modules.py``) as the
configuration's ``fusion`` block sets them. Every agent acts as ego; for
ego i, over its L = A slots, X[l] = agent order[i][l]'s map warped into
i's frame (``model.warp_all_pairs``, padded agents zeroed), order[i] = (i,
then the others in index order):

    keys[l]  = mask[order[i][l]], keys[0] always
    depth x: local:  X += Attn(LN(X)) over (slot, s, s) windows
                     'b m (x w1) (y w2) d -> b m x y w1 w2 d';  X += FFN(LN(X))
             grid:   X += Attn(LN(X)) over (slot, s, s) dilated groups
                     'b m (w1 x) (w2 y) d -> b m x y w1 w2 d'; X += FFN(LN(X))
    fused_i  = Linear(LN(mean over the slots of X))

Attention: a bias-free ``to_qkv``, C / dim_head heads, ``softmax(q k /
sqrt(d) + P[idx(q, k)])`` with the keys outside ``keys`` at -inf, a
bias-free ``to_out``; P an ``nn.Embedding`` of (2L-1)(2s-1)^2 rows indexed
by the tokens' (slot, row, column) offsets as Video-Swin indexes them.
FFN: Linear, exact GELU, Linear. No dropout (inference).

Every Linear, attention logit and attention product goes through
``Precision`` (the float8 control rounds the attention, not only the
convolutions); LayerNorms, the softmax and the slot mean do not. It runs
one ego at a time: egos never mix. Module names are the port's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.model import Precision, warp_all_pairs


def linear(x: torch.Tensor, lin: nn.Linear, p: Precision) -> torch.Tensor:
    return p.act(F.linear(p.act(x), p.weight(lin.weight), lin.bias))


def relative_position_index(agents: int, s: int, device) -> torch.Tensor:
    """(L s s, L s s) long: Video-Swin's index over (slot, row, column)."""
    coords = torch.stack(torch.meshgrid(torch.arange(agents), torch.arange(s), torch.arange(s),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += agents - 1
    rel[:, :, 1] += s - 1
    rel[:, :, 2] += s - 1
    rel[:, :, 0] *= (2 * s - 1) * (2 * s - 1)
    rel[:, :, 1] *= 2 * s - 1
    return rel.sum(-1).to(device)


class Attention(nn.Module):
    def __init__(self, dim, dim_head, agents, window):
        super().__init__()
        self.heads, self.dim_head, self.agents, self.window = dim // dim_head, dim_head, agents, window
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=False)
        self.relative_position_bias_table = nn.Embedding(
            (2 * agents - 1) * (2 * window - 1) ** 2, self.heads)

    def forward(self, x, keys, p: Precision):
        """x (b, m, x, y, w1, w2, d); keys (b, m) bool."""
        b, m, nx, ny, w1, w2, _ = x.shape
        heads, d = self.heads, self.dim_head
        n = m * w1 * w2
        x = x.permute(0, 2, 3, 1, 4, 5, 6).reshape(b * nx * ny, n, -1)  # (b x y) (m w1 w2) d
        q, k, v = linear(x, self.to_qkv, p).chunk(3, dim=-1)
        q, k, v = (t.reshape(b * nx * ny, n, heads, d).transpose(1, 2) for t in (q, k, v))
        sim = p.act(torch.einsum("bhid,bhjd->bhij", p.act(q), p.act(k)) / math.sqrt(d))
        idx = relative_position_index(self.agents, self.window, x.device)
        table = p.weight(self.relative_position_bias_table.weight)
        sim = sim + table[idx].permute(2, 0, 1)[None]
        key = keys[:, None, None, :, None].expand(b, nx, ny, m, w1 * w2).reshape(-1, 1, 1, n)
        attn = torch.softmax(sim.masked_fill(~key, float("-inf")), dim=-1)
        out = p.act(torch.einsum("bhij,bhjd->bhid", p.act(attn), p.act(v)))
        out = out.reshape(b * nx * ny, heads, m, w1, w2, d).permute(0, 2, 3, 4, 1, 5)
        out = linear(out.reshape(b * nx * ny, m, w1, w2, heads * d), self.to_out, p)
        return out.reshape(b, nx, ny, m, w1, w2, -1).permute(0, 3, 1, 2, 4, 5, 6)


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, p: Precision):
        return linear(F.gelu(linear(x, self.fc1, p)), self.fc2, p)


class Layer(nn.Module):
    def __init__(self, dim, f, agents):
        super().__init__()
        s = self.window = f["window_size"]
        self.local_norm = nn.LayerNorm(dim)
        self.local_attn = Attention(dim, f["dim_head"], agents, s)
        self.local_ffn_norm = nn.LayerNorm(dim)
        self.local_ffn = FeedForward(dim, f["mlp_dim"])
        self.grid_norm = nn.LayerNorm(dim)
        self.grid_attn = Attention(dim, f["dim_head"], agents, s)
        self.grid_ffn_norm = nn.LayerNorm(dim)
        self.grid_ffn = FeedForward(dim, f["mlp_dim"])

    def forward(self, x, keys, p: Precision):
        """x (b, m, h, w, d); keys (b, m) bool."""
        b, m, h, w, d = x.shape
        s = self.window
        t = x.reshape(b, m, h // s, s, w // s, s, d).permute(0, 1, 2, 4, 3, 5, 6)
        t = t + self.local_attn(self.local_norm(t), keys, p)
        t = t + self.local_ffn(self.local_ffn_norm(t), p)
        x = t.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, m, h, w, d)
        t = x.reshape(b, m, s, h // s, s, w // s, d).permute(0, 1, 3, 5, 2, 4, 6)
        t = t + self.grid_attn(self.grid_norm(t), keys, p)
        t = t + self.grid_ffn(self.grid_ffn_norm(t), p)
        return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, m, h, w, d)


class CoBEVTFusion(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        c = config["stage_channels"][config["fusion_layer"]]
        f = config["fusion"]
        self.extents = config["grid"]["area_extents"]
        self.layers = nn.ModuleList(Layer(c, f, config["num_agents"]) for _ in range(f["depth"]))
        self.head_norm = nn.LayerNorm(c)
        self.head = nn.Linear(c, c)

    def forward(self, feats: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor,
                p: Precision) -> torch.Tensor:
        """feats (B, A, C, h, w) -> fused (B, A, C, h, w)."""
        b, a, c, h, w = feats.shape
        warped = warp_all_pairs(feats, trans, self.extents)  # (B, Ai, Aj, C, h, w)
        warped = warped * mask[:, None, :, None, None, None].to(feats.dtype)
        fused = []
        for i in range(a):
            order = [i] + [j for j in range(a) if j != i]
            x = warped[:, i, order].permute(0, 1, 3, 4, 2)  # (B, L, h, w, C)
            keys = mask.bool()[:, order]
            keys[:, 0] = True
            for layer in self.layers:
                x = layer(x, keys, p)
            y = linear(self.head_norm(x.mean(dim=1)), self.head, p)  # (B, h, w, C)
            fused.append(y.permute(0, 3, 1, 2))
        return torch.stack(fused, dim=1)


def build_fusion(config: dict) -> nn.Module:
    return CoBEVTFusion(config)
