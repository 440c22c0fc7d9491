"""V2X-ViT's fusion (arXiv:2203.10638), the part of the reference that only
the ``v2xvit`` configuration has, written from the paper's section 3 and
the public code's equations (github.com/DerrickXuNu/v2x-vit) as the
configuration's ``fusion`` block sets them. Every agent acts as ego; for
ego i, over the A maps X[j] = agent j's map (after the delay encoding)
warped into i's frame (``model.warp_all_pairs``, padded agents zeroed):

    x_j     += rte(e(0))   e: sinusoid table over sqrt(C), delay 0
    keys[j]  = mask[j] and roi[i, j]  (ones of j sampled into i's frame by
               nearest neighbour on the warp's grid), keys[i] always
    depth x: X += HMSA(LN(X));  X += MSwin(LN(X));  X += FFN(LN(X))
    fused_i  = X[i]

HMSA per pixel over the agents: q, k, v and output Linears by agent type
(agent 0 the roadside unit, type 1; the others vehicles, type 0), per
head ``logit[j, k] = q_j W_att[r] k_k / sqrt(d)`` with r = t_j * T + t_k,
the keys outside ``keys`` at -inf, softmax over k, ``out_j =
a_linear[t_j](concat over heads of sum_k alpha v_k W_msg[r])``. MSwin per
(ego, agent) map: per branch s x s windows, a bias-free ``to_qkv``,
``softmax(q k / sqrt(d) + P[dr + s - 1, dc + s - 1]) v``, ``to_out``; the
branches merged by split attention (softmax over the branches of
``fc2(relu(LN(fc1(mean over the map of their sum))))``). FFN:
Linear, exact GELU, Linear. No dropout (inference).

Every Linear, attention logit and attention product goes through
``Precision`` (the float8 control rounds the attention, not only the
convolutions); LayerNorms and softmaxes do not. It runs one ego at a
time: egos never mix. Module names are the port's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.model import Precision, warp_all_pairs


def linear(x: torch.Tensor, lin: nn.Linear, p: Precision) -> torch.Tensor:
    return p.act(F.linear(p.act(x), p.weight(lin.weight), lin.bias))


def roi_all_pairs(trans: torch.Tensor, extents, h: int, w: int) -> torch.Tensor:
    """(B, Ai, Aj, h, w) bool: ones of agent j's map sampled into agent i's
    frame by nearest neighbour, over the grid of ``model.warp_all_pairs``."""
    b, a = trans.shape[:2]
    (x0, x1), (y0, y1) = extents[0], extents[1]
    sx, sy = (x1 - x0) / h, (y1 - y0) / w
    xs = x0 + (torch.arange(h, dtype=torch.float32, device=trans.device) + 0.5) * sx
    ys = y0 + (torch.arange(w, dtype=torch.float32, device=trans.device) + 0.5) * sy
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    t = trans.to(torch.float32).transpose(1, 2).reshape(b * a * a, 4, 4)  # T_{j<-i}
    r, tt = t[:, :2, :2], t[:, :2, 3]
    xj = r[:, 0, 0, None, None] * gx + r[:, 0, 1, None, None] * gy + tt[:, 0, None, None]
    yj = r[:, 1, 0, None, None] * gx + r[:, 1, 1, None, None] * gy + tt[:, 1, None, None]
    px = (xj - x0) / sx - 0.5
    py = (yj - y0) / sy - 0.5
    grid = torch.stack([(2.0 * py + 1.0) / w - 1.0, (2.0 * px + 1.0) / h - 1.0], dim=-1)
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

    def forward(self, y, keys, types, p: Precision):
        """y (B, J, h, w, C), one ego's maps; keys (B, J, h, w) bool."""
        b, aj, h, w, _ = y.shape
        m, d = self.heads, self.dim_head

        def per_agent(linears):
            return torch.stack([linear(y[:, j], linears[types[j]], p) for j in range(aj)], dim=1)

        q, k, v = (per_agent(lin).reshape(b, aj, h, w, m, d)
                   for lin in (self.q_linears, self.k_linears, self.v_linears))
        rel = torch.tensor([[types[j] * self.num_types + types[k] for k in range(aj)]
                            for j in range(aj)], device=y.device)
        w_att, w_msg = p.weight(self.relation_att[rel]), p.weight(self.relation_msg[rel])
        logits = p.act(torch.einsum("bjxymp,jkmpq,bkxymq->bxymjk", p.act(q), w_att, p.act(k))
                       / math.sqrt(d))
        logits = logits.masked_fill(~keys.permute(0, 2, 3, 1)[:, :, :, None, None, :],
                                    float("-inf"))
        alpha = torch.softmax(logits, dim=-1)
        v_msg = p.act(torch.einsum("jkmpc,bkxymp->bxymjkc", w_msg, p.act(v)))
        out = p.act(torch.einsum("bxymjk,bxymjkc->bjxymc", p.act(alpha), v_msg))
        out = out.reshape(b, aj, h, w, m * d)
        return torch.stack([linear(out[:, j], self.a_linears[types[j]], p) for j in range(aj)],
                           dim=1)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, dim_head, window, relative):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.window, self.relative = heads, dim_head, window, relative
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        side = 2 * window - 1 if relative else window * window
        self.pos_embedding = nn.Parameter(torch.zeros(side, side))
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, p: Precision):
        """x (N, h, w, C) -> (N, h, w, C)."""
        n, h, w, _ = x.shape
        s, m, d = self.window, self.heads, self.dim_head
        q, k, v = linear(x, self.to_qkv, p).chunk(3, dim=-1)

        def windows(t):  # (N, h, w, m d) -> (N, nh nw, m, s s, d)
            t = t.reshape(n, h // s, s, w // s, s, m, d).permute(0, 1, 3, 5, 2, 4, 6)
            return t.reshape(n, (h // s) * (w // s), m, s * s, d)

        q, k, v = windows(q), windows(k), windows(v)
        dots = p.act(torch.einsum("nwmic,nwmjc->nwmij", p.act(q), p.act(k)) / math.sqrt(d))
        if self.relative:
            idx = torch.tensor([[r, c] for r in range(s) for c in range(s)], device=x.device)
            rel = idx[None, :, :] - idx[:, None, :] + s - 1  # [i, j] = pos_j - pos_i + s - 1
            dots = dots + p.weight(self.pos_embedding)[rel[:, :, 0], rel[:, :, 1]]
        else:
            dots = dots + p.weight(self.pos_embedding)
        attn = torch.softmax(dots, dim=-1)
        out = p.act(torch.einsum("nwmij,nwmjc->nwmic", p.act(attn), p.act(v)))
        out = out.reshape(n, h // s, w // s, m, s, s, d).permute(0, 1, 4, 2, 5, 3, 6)
        return linear(out.reshape(n, h, w, m * d), self.to_out, p)


class SplitAttn(nn.Module):
    def __init__(self, dim, branches):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim, bias=False)
        self.norm = nn.LayerNorm(dim)
        self.fc2 = nn.Linear(dim, dim * branches, bias=False)

    def forward(self, outs, p: Precision):
        g = sum(outs).mean(dim=(1, 2))  # (N, C)
        a = linear(torch.relu(self.norm(linear(g, self.fc1, p))), self.fc2, p)
        a = torch.softmax(a.reshape(g.shape[0], len(outs), -1), dim=1)
        return sum(a[:, s, None, None, :] * o for s, o in enumerate(outs))


class MSwin(nn.Module):
    def __init__(self, dim, heads, dim_heads, windows, relative, fusion):
        super().__init__()
        self.windows = nn.ModuleList(WindowAttention(dim, m, d, s, relative)
                                     for m, d, s in zip(heads, dim_heads, windows))
        self.split_attn = SplitAttn(dim, len(windows)) if fusion == "split_attn" else None

    def forward(self, x, p: Precision):
        outs = [branch(x, p) for branch in self.windows]
        if self.split_attn is None:
            return sum(outs) / len(outs)
        return self.split_attn(outs, p)


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, p: Precision):
        return linear(F.gelu(linear(x, self.fc1, p)), self.fc2, p)


class Layer(nn.Module):
    def __init__(self, dim, f):
        super().__init__()
        self.hmsa_norm = nn.LayerNorm(dim)
        self.hmsa = HMSA(dim, f["heads"], f["dim_head"], f["num_types"])
        self.mswin_norm = nn.LayerNorm(dim)
        self.mswin = MSwin(dim, f["window_heads"], f["window_dim_heads"], f["window_sizes"],
                           f["relative_pos_embedding"], f["window_fusion"])
        self.ffn_norm = nn.LayerNorm(dim)
        self.ffn = FeedForward(dim, f["mlp_dim"])


class V2XViTFusion(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        c = config["stage_channels"][config["fusion_layer"]]
        f = config["fusion"]
        self.extents = config["grid"]["area_extents"]
        self.num_types, self.rte_ratio, self.use_roi_mask = (f["num_types"], f["rte_ratio"],
                                                             f["use_roi_mask"])
        self.rte = nn.Linear(c, c) if f["use_rte"] else None
        self.layers = nn.ModuleList(Layer(c, f) for _ in range(f["depth"]))

    def delay_encoding(self, delay: int, c: int, device, p: Precision) -> torch.Tensor:
        """rte(e(delay * rte_ratio)): e's even channels sin, odd cos, over sqrt(C)."""
        t = float(delay * self.rte_ratio)
        e = torch.zeros(c, device=device)
        for i in range(0, c, 2):
            angle = t * math.exp(-i * math.log(10000.0) / c)
            e[i] = math.sin(angle) / math.sqrt(c)
            if i + 1 < c:
                e[i + 1] = math.cos(angle) / math.sqrt(c)
        return linear(e, self.rte, p)

    def forward(self, feats: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor,
                p: Precision) -> torch.Tensor:
        """feats (B, A, C, h, w) -> fused (B, A, C, h, w)."""
        b, a, c, h, w = feats.shape
        if self.rte is not None:
            feats = feats + self.delay_encoding(0, c, feats.device, p)[:, None, None]
        warped = warp_all_pairs(feats, trans, self.extents)  # (B, Ai, Aj, C, h, w)
        warped = warped * mask[:, None, :, None, None, None].to(feats.dtype)
        keys = mask.bool()[:, None, :, None, None].expand(b, a, a, h, w)
        if self.use_roi_mask:
            keys = keys & roi_all_pairs(trans, self.extents, h, w)
        types = [1 if j == 0 and self.num_types > 1 else 0 for j in range(a)]
        fused = []
        for i in range(a):
            x = warped[:, i].permute(0, 1, 3, 4, 2)  # (B, J, h, w, C)
            ki = keys[:, i].clone()
            ki[:, i] = True
            for layer in self.layers:
                x = x + layer.hmsa(layer.hmsa_norm(x), ki, types, p)
                x = x + layer.mswin(layer.mswin_norm(x).reshape(-1, h, w, c), p).reshape(x.shape)
                x = x + layer.ffn(layer.ffn_norm(x), p)
            fused.append(x[:, i].permute(0, 3, 1, 2))
        return torch.stack(fused, dim=1)


def build_fusion(config: dict) -> nn.Module:
    return V2XViTFusion(config)
