"""V2X-ViT's transformer fusion in plain float32 PyTorch: the reference
that ``models/det/v2xvit.py`` is held to.

Written from the paper's section 3 (arXiv:2203.10638) and the public code's
equations (github.com/DerrickXuNu/v2x-vit, inside OpenCOOD), literally:
per-agent Linears chosen by agent type, a (d x d) relation matrix per head
and edge type applied between query and key and to each value, the
masked softmax over the agents, window partitions by reshape, the
relative-position table indexed per token pair, split attention as a
softmax over the branches. Every agent acts as ego; the delay is 0; the
ego's own map is always a key (the port's module docstring lists the
departures from the public code). It has no dropout: compare at
inference, or training at dropout 0.

Imports nothing of the port's fusion (``models/det/v2xvit.py``), its
warp, ``ops/cuda`` or ``csrc``: the warp's bilinear sample and the ROI's
nearest sample are written here over the same metric cell centres.
Module names are the port's, so one state dict loads into both. TF32 is
switched off on import.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def pair_grid(trans: torch.Tensor, extents, h: int, w: int) -> torch.Tensor:
    """(B, Ai, Aj, h, w, 2) float32 ``grid_sample`` coordinates: ego i's
    cell centres p_i mapped to p_j = trans[b, j, i] @ p_i in agent j's
    (h, w) map, (column, row) normalized with align_corners=False."""
    (x0, x1), (y0, y1) = extents[0], extents[1]
    sx, sy = (x1 - x0) / h, (y1 - y0) / w
    xs = x0 + (torch.arange(h, dtype=torch.float32, device=trans.device) + 0.5) * sx
    ys = y0 + (torch.arange(w, dtype=torch.float32, device=trans.device) + 0.5) * sy
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    t = trans.to(torch.float32).transpose(1, 2)  # [b, i, j] = T_{j<-i}
    r, tt = t[..., :2, :2], t[..., :2, 3]
    xj = r[..., 0, 0, None, None] * gx + r[..., 0, 1, None, None] * gy + tt[..., 0, None, None]
    yj = r[..., 1, 0, None, None] * gx + r[..., 1, 1, None, None] * gy + tt[..., 1, None, None]
    px = (xj - x0) / sx - 0.5
    py = (yj - y0) / sy - 0.5
    return torch.stack([(2.0 * py + 1.0) / w - 1.0, (2.0 * px + 1.0) / h - 1.0], dim=-1)


def warp_pairs(feats: torch.Tensor, trans: torch.Tensor, extents) -> torch.Tensor:
    """feats (B, A, h, w, C) -> (B, Ai, Aj, h, w, C): agent j's map in i's
    frame (bilinear, zeros outside)."""
    b, a, h, w, c = feats.shape
    grid = pair_grid(trans, extents, h, w).reshape(b * a * a, h, w, 2)
    src = feats.permute(0, 1, 4, 2, 3)[:, None].expand(b, a, a, c, h, w).reshape(-1, c, h, w)
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out.reshape(b, a, a, c, h, w).permute(0, 1, 2, 4, 5, 3)


def roi_pairs(trans: torch.Tensor, extents, h: int, w: int) -> torch.Tensor:
    """(B, Ai, Aj, h, w) bool: a map of ones of agent j sampled into i's
    frame by nearest neighbour (the public code's ``get_rotated_roi``)."""
    b, a = trans.shape[:2]
    grid = pair_grid(trans, extents, h, w).reshape(b * a * a, h, w, 2)
    ones = torch.ones(b * a * a, 1, h, w, dtype=torch.float32, device=trans.device)
    roi = F.grid_sample(ones, grid, mode="nearest", padding_mode="zeros", align_corners=False)
    return roi.reshape(b, a, a, h, w) > 0.5


class HMSA(nn.Module):
    def __init__(self, dim, heads, dim_head, num_types):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.num_types = heads, dim_head, num_types
        self.q_linears = nn.ModuleList(nn.Linear(dim, inner) for _ in range(num_types))
        self.k_linears = nn.ModuleList(nn.Linear(dim, inner) for _ in range(num_types))
        self.v_linears = nn.ModuleList(nn.Linear(dim, inner) for _ in range(num_types))
        self.a_linears = nn.ModuleList(nn.Linear(inner, dim) for _ in range(num_types))
        self.relation_att = nn.Parameter(torch.zeros(num_types ** 2, heads, dim_head, dim_head))
        self.relation_msg = nn.Parameter(torch.zeros(num_types ** 2, heads, dim_head, dim_head))

    def forward(self, y, keys, types):
        """y (B, I, J, h, w, C); keys (B, I, J, h, w) bool; types: each agent's."""
        b, ai, aj, h, w, _ = y.shape
        m, d = self.heads, self.dim_head

        def per_agent(linears):
            return torch.stack([linears[types[j]](y[:, :, j]) for j in range(aj)], dim=2)

        q, k, v = (per_agent(lin).reshape(b, ai, aj, h, w, m, d)
                   for lin in (self.q_linears, self.k_linears, self.v_linears))
        rel = torch.tensor([[types[j] * self.num_types + types[k] for k in range(aj)]
                            for j in range(aj)], device=y.device)
        w_att, w_msg = self.relation_att[rel], self.relation_msg[rel]  # (J, K, M, d, d)
        logits = torch.einsum("bijxymp,jkmpq,bikxymq->bixymjk", q, w_att, k) / math.sqrt(d)
        logits = logits.masked_fill(~keys.permute(0, 1, 3, 4, 2)[:, :, :, :, None, None, :],
                                    float("-inf"))
        alpha = torch.softmax(logits, dim=-1)
        v_msg = torch.einsum("jkmpc,bikxymp->bixymjkc", w_msg, v)
        out = torch.einsum("bixymjk,bixymjkc->bijxymc", alpha, v_msg).reshape(b, ai, aj, h, w, -1)
        return torch.stack([self.a_linears[types[j]](out[:, :, j]) for j in range(aj)], dim=2)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, dim_head, window, relative):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.window, self.relative = heads, dim_head, window, relative
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        side = 2 * window - 1 if relative else window * window
        self.pos_embedding = nn.Parameter(torch.zeros(side, side))
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x):
        """x (N, h, w, C) -> (N, h, w, C)."""
        n, h, w, _ = x.shape
        s, m, d = self.window, self.heads, self.dim_head
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)

        def windows(t):  # (N, h, w, m d) -> (N, nh nw, m, s s, d)
            t = t.reshape(n, h // s, s, w // s, s, m, d).permute(0, 1, 3, 5, 2, 4, 6)
            return t.reshape(n, (h // s) * (w // s), m, s * s, d)

        q, k, v = windows(q), windows(k), windows(v)
        dots = torch.einsum("nwmic,nwmjc->nwmij", q, k) / math.sqrt(d)
        if self.relative:
            idx = torch.tensor([[x, y] for x in range(s) for y in range(s)], device=x.device)
            rel = idx[None, :, :] - idx[:, None, :] + s - 1  # [i, j] = pos_j - pos_i + s - 1
            dots = dots + self.pos_embedding[rel[:, :, 0], rel[:, :, 1]]
        else:
            dots = dots + self.pos_embedding
        out = torch.einsum("nwmij,nwmjc->nwmic", torch.softmax(dots, dim=-1), v)
        out = out.reshape(n, h // s, w // s, m, s, s, d).permute(0, 1, 4, 2, 5, 3, 6)
        return self.to_out(out.reshape(n, h, w, m * d))


class SplitAttn(nn.Module):
    def __init__(self, dim, branches):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim, bias=False)
        self.norm = nn.LayerNorm(dim)
        self.fc2 = nn.Linear(dim, dim * branches, bias=False)

    def forward(self, outs):
        g = sum(outs).mean(dim=(1, 2))  # (N, C)
        a = self.fc2(torch.relu(self.norm(self.fc1(g))))
        a = torch.softmax(a.reshape(g.shape[0], len(outs), -1), dim=1)
        return sum(a[:, s, None, None, :] * o for s, o in enumerate(outs))


class MSwin(nn.Module):
    def __init__(self, dim, heads, dim_heads, windows, relative, fusion):
        super().__init__()
        self.windows = nn.ModuleList(WindowAttention(dim, m, d, s, relative)
                                     for m, d, s in zip(heads, dim_heads, windows))
        self.split_attn = SplitAttn(dim, len(windows)) if fusion == "split_attn" else None

    def forward(self, x):
        outs = [branch(x) for branch in self.windows]
        return self.split_attn(outs) if self.split_attn is not None else sum(outs) / len(outs)


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Layer(nn.Module):
    def __init__(self, dim, heads, dim_head, num_types, window_heads, window_dim_heads,
                 window_sizes, relative, window_fusion, mlp_dim):
        super().__init__()
        self.hmsa_norm = nn.LayerNorm(dim)
        self.hmsa = HMSA(dim, heads, dim_head, num_types)
        self.mswin_norm = nn.LayerNorm(dim)
        self.mswin = MSwin(dim, window_heads, window_dim_heads, window_sizes, relative,
                           window_fusion)
        self.ffn_norm = nn.LayerNorm(dim)
        self.ffn = FeedForward(dim, mlp_dim)


class V2XViTRef(nn.Module):
    """The fusion: ``forward(feats (B, A, h, w, C), trans (B, A, A, 4, 4),
    mask (B, A)) -> (B, A, h, w, C)``, the keywords the port's
    ``V2XViTFusion``'s (``dropout`` is accepted and not applied)."""

    def __init__(self, area_extents, channels: int, depth: int = 3, heads: int = 8,
                 dim_head: int = 32, num_types: int = 2,
                 window_heads: Sequence[int] = (16, 8, 4),
                 window_dim_heads: Sequence[int] = (16, 32, 64),
                 window_sizes: Sequence[int] = (4, 8, 16), relative_pos_embedding: bool = True,
                 window_fusion: str = "split_attn", mlp_dim: int = 256, dropout: float = 0.3,
                 use_rte: bool = True, rte_ratio: int = 2, use_roi_mask: bool = True):
        super().__init__()
        self.extents = area_extents
        self.num_types, self.rte_ratio, self.use_roi_mask = num_types, rte_ratio, use_roi_mask
        self.rte = nn.Linear(channels, channels) if use_rte else None
        self.layers = nn.ModuleList(
            Layer(channels, heads, dim_head, num_types, window_heads, window_dim_heads,
                  window_sizes, relative_pos_embedding, window_fusion, mlp_dim)
            for _ in range(depth))

    def delay_encoding(self, delay: int, c: int, device) -> torch.Tensor:
        """rte(e(delay * rte_ratio)): the sinusoid's row, over sqrt(C)."""
        t = float(delay * self.rte_ratio)
        e = torch.zeros(c, device=device)
        for i in range(0, c, 2):
            e[i] = math.sin(t * math.exp(-i * math.log(10000.0) / c)) / math.sqrt(c)
            if i + 1 < c:
                e[i + 1] = math.cos(t * math.exp(-i * math.log(10000.0) / c)) / math.sqrt(c)
        return self.rte(e)

    def forward(self, feats, trans, mask, train: bool = False):
        b, a, h, w, c = feats.shape
        x = feats.float()
        if self.rte is not None:
            x = x + self.delay_encoding(0, c, x.device)
        x = warp_pairs(x, trans, self.extents) * mask[:, None, :, None, None, None].float()
        keys = mask.bool()[:, None, :, None, None].expand(b, a, a, h, w)
        if self.use_roi_mask:
            keys = keys & roi_pairs(trans, self.extents, h, w)
        keys = keys | torch.eye(a, dtype=torch.bool, device=x.device)[None, :, :, None, None]
        types = [1 if j == 0 and self.num_types > 1 else 0 for j in range(a)]
        for layer in self.layers:
            x = x + layer.hmsa(layer.hmsa_norm(x), keys, types)
            x = x + layer.mswin(layer.mswin_norm(x).reshape(-1, h, w, c)).reshape(x.shape)
            x = x + layer.ffn(layer.ffn_norm(x))
        return torch.stack([x[:, i, i] for i in range(a)], dim=1)
