"""V2X-ViT's transformer fusion (Xu et al., ECCV 2022, arXiv:2203.10638).

A mode of the port only (``models/det/net.py::PORT_MODES``): the JAX
package has no counterpart. Every agent acts as ego at once, as the
port's other fusions do. For ego i, the fusion runs the paper's encoder
over the A maps warped into i's frame:

  1. RTE, the delay encoding: ``x_j += rte(e(dt_j * rte_ratio))`` with
     ``e`` the sinusoid table over 1/sqrt(C) (even channels sin, odd cos)
     and ``rte`` an ``nn.Linear(C, C)``. V2X-Sim is synchronous, so every
     delay is 0 and every agent gets ``rte(e(0))``.
  2. STTF: ``X[:, i, j] = warp_neighbors(x)`` (the port's bilinear warp,
     padded sources zeroed): (B, Ai, Aj, h, w, C). The key mask
     ``M[i, j](p) = mask[j] and roi[i, j](p)``, roi being where agent j's
     map covers i's cells (``ops/warp.py::roi_all_pairs``: a map of ones
     sampled by nearest neighbour on the warp's grid, as the public code's
     ``get_rotated_roi``).
  3. ``depth`` layers, each pre-LayerNorm with a residual around every
     part:
       * HMSA, heterogeneous multi-agent attention, per pixel over the A
         maps. Agent j of type t_j has its own q, k, v and output Linears;
         the edge (j, k) of type r = t_j * num_types + t_k its own
         per-head relation matrices W_att[r], W_msg[r] (d x d):
         ``logit[j, k] = q_j W_att[r] k_k^T / sqrt(d)`` (keys outside
         ``M[i, k]`` at -inf), softmax over k, ``out_j =
         a_linear[t_j](concat over heads of sum_k alpha[j, k] v_k W_msg[r])``;
       * MSwin, multi-scale window attention, on every (i, j) map alone:
         per branch (heads, head size, window s) non-overlapping s x s
         windows, a bias-free ``to_qkv``, ``logit = q k^T / sqrt(d) +
         P[row_k - row_q + s - 1, col_k - col_q + s - 1]`` (one (2s-1)^2
         table a branch, shared by its heads), softmax over the window,
         ``to_out``; the branches merged by split attention: ``g`` the
         spatial mean of their sum, ``a = fc2(relu(LN(fc1(g))))`` split
         into (branch, channel), softmax over the branches, ``out = sum_s
         a_s o_s``;
       * FFN: Linear(C, mlp_dim), exact GELU, Linear(mlp_dim, C).
  4. ``fused[:, i] = X[:, i, i]``, the ego's own slice.

Dropout (rate ``dropout``) follows HMSA's output Linear, each window
branch's ``to_out``, and both FFN Linears, in training only (``train``).

Agent types: agent 0 is the roadside unit (type 1), the others vehicles
(type 0), as V2X-Sim lays out its agents (``configs/config.py``); with
``num_types`` 1 every agent is a vehicle.

Departures from the public code (github.com/DerrickXuNu/v2x-vit, inside
OpenCOOD):
  * every agent is ego, not agent 0 alone, and the warp is the port's
    all-pairs warp on the STPN's stage map;
  * the delay table is a non-persistent buffer (the public code's
    ``nn.Embedding`` would be redrawn with the weights);
  * the ego's own map is always a key (``M[i, i] = 1``): for a real ego
    that is ``mask[i] and roi[i, i]``, and a padded ego (every agent acts
    as one) keeps its softmax defined;
  * module names are shorter (``to_out`` is a Linear, not a Sequential
    with its dropout; ``windows`` for ``pwmsa``; ``norm`` for
    ``split_attn.bn1``, a LayerNorm); the unused ``prior_feed`` is left
    out;
  * for speed, HMSA folds W_att and W_msg into the key and value Linears,
    one variant for each query type, so every token meets one GEMM per
    agent type (the same sums, rounded once more); MSwin's window
    attention is ``scaled_dot_product_attention`` with the position bias
    as its additive mask.

Numerics in bf16: the residual stream (X) is held in float32, so that its
nine additions do not round it to bf16 each time; LayerNorm (statistics
and output), both softmaxes and the split attention's gate run in
float32; every other map, and every GEMM's operands, are in the
activation dtype.
``baselines/v2xvit_ref.py`` is the plain float32 reference, with this
module's state-dict names.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.models.det.fusion import warp_neighbors
from v2x_sim_tpu_torch.ops.warp import roi_all_pairs
from v2x_sim_tpu_torch.utils.spans import span

#: Agent types (the public code's infrastructure flag).
VEHICLE, RSU = 0, 1
#: Rows of the delay table (the public code's ``max_len``).
RTE_MAX_LEN = 100
LN_EPS = 1e-5
#: Window tokens the attention kernel is handed at least, windows packed.
PACK_TOKENS = 64


def agent_types(num_agents: int, num_types: int) -> List[int]:
    """Each agent's type: agent 0 the roadside unit where there are two
    types, every other agent a vehicle."""
    return [RSU if j == 0 and num_types > 1 else VEHICLE for j in range(num_agents)]


def type_runs(types: Sequence[int]) -> List[Tuple[int, int, int]]:
    """(type, start, stop) of each run of equal consecutive types."""
    runs: List[Tuple[int, int, int]] = []
    for j, t in enumerate(types):
        if runs and runs[-1][0] == t:
            runs[-1] = (t, runs[-1][1], j + 1)
        else:
            runs.append((t, j, j + 1))
    return runs


def sinusoid_table(max_len: int, dim: int) -> torch.Tensor:
    """(max_len, dim) float32: even channels sin, odd cos of position *
    10000^(-2i/dim), over sqrt(dim) (the public code's RelTemporalEncoding)."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * -(math.log(10000.0) / dim))
    table = torch.zeros(max_len, dim)
    table[:, 0::2] = torch.sin(pos * div) / math.sqrt(dim)
    table[:, 1::2] = torch.cos(pos * div)[:, : dim // 2] / math.sqrt(dim)
    return table


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """``norm`` of the residual stream ``x`` (float32 at least), in ``dtype``."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                        norm.eps).to(dtype)


def key_softmax(logits: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Softmax of float32 ``logits`` over the last axis, the keys where
    ``keys`` is False at -inf."""
    return torch.softmax(logits.masked_fill(~keys, float("-inf")), dim=-1)


def window_backends(tokens: int) -> List[SDPBackend]:
    """The card's attention kernels for windows of ``tokens``, fastest
    first (an H100 at the configurations' shapes: the memory-efficient
    kernel at 16 and 64 tokens, cuDNN's at 256, and at CoBEVT's 384 with
    a (ego x head) bias broadcast over the windows and holding each ego's
    key mask: 2.27 ms a block against the memory-efficient kernel's 4.89,
    bf16 (768, 16, 384, 32) operands. cuDNN's takes no float32: the
    memory-efficient kernel runs a float32 witness)."""
    if tokens <= 64:
        return [SDPBackend.EFFICIENT_ATTENTION]
    return [SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v over each window's tokens: (N,
    heads, tokens, d) in and out."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    with sdpa_kernel(window_backends(q.shape[-2])):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def relative_index(s: int) -> torch.Tensor:
    """(s^2, s^2) long: the flat index into a (2s-1, 2s-1) table of token
    pair (q, k) of an s x s window (row-major tokens), at
    (row_k - row_q + s - 1, col_k - col_q + s - 1)."""
    rows = torch.arange(s).repeat_interleave(s)
    cols = torch.arange(s).repeat(s)
    dr = rows[None, :] - rows[:, None] + s - 1
    dc = cols[None, :] - cols[:, None] + s - 1
    return dr * (2 * s - 1) + dc


class HMSA(nn.Module):
    """Heterogeneous multi-agent self-attention (the public code's
    ``HGTCavAttention``); see the module docstring."""

    def __init__(self, dim: int, heads: int, dim_head: int, num_types: int, dropout: float):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.num_types = heads, dim_head, num_types
        self.dropout = dropout
        self.q_linears = nn.ModuleList(nn.Linear(dim, inner) for _ in range(num_types))
        self.k_linears = nn.ModuleList(nn.Linear(dim, inner) for _ in range(num_types))
        self.v_linears = nn.ModuleList(nn.Linear(dim, inner) for _ in range(num_types))
        self.a_linears = nn.ModuleList(nn.Linear(inner, dim) for _ in range(num_types))
        self.relation_att = nn.Parameter(torch.empty(num_types ** 2, heads, dim_head, dim_head))
        self.relation_msg = nn.Parameter(torch.empty(num_types ** 2, heads, dim_head, dim_head))
        nn.init.xavier_uniform_(self.relation_att)
        nn.init.xavier_uniform_(self.relation_msg)

    def projections(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The float32 weight and bias that map a type-``t`` token to its
        query, then its key with W_att folded in for each query type, then
        its value with W_msg folded in for each query type:
        ((1 + 2 num_types) heads d, C)."""
        h, d, n = self.heads, self.dim_head, self.num_types
        q, k, v = self.q_linears[t], self.k_linears[t], self.v_linears[t]
        wk, bk = k.weight.reshape(h, d, -1), k.bias.reshape(h, d)
        wv, bv = v.weight.reshape(h, d, -1), v.bias.reshape(h, d)
        ws, bs = [q.weight], [q.bias]
        for tq in range(n):  # k'[p] = sum_q W_att[p, q] k[q]
            att = self.relation_att[tq * n + t]
            ws.append(torch.einsum("mpq,mqc->mpc", att, wk).reshape(h * d, -1))
            bs.append(torch.einsum("mpq,mq->mp", att, bk).reshape(h * d))
        for tq in range(n):  # v'[c] = sum_p v[p] W_msg[p, c]
            msg = self.relation_msg[tq * n + t]
            ws.append(torch.einsum("mpc,mpx->mcx", msg, wv).reshape(h * d, -1))
            bs.append(torch.einsum("mpc,mp->mc", msg, bv).reshape(h * d))
        return torch.cat(ws), torch.cat(bs)

    def forward(self, y: torch.Tensor, keys: torch.Tensor, types: Sequence[int],
                train: bool) -> torch.Tensor:
        """y (B, Ai, Aj, h, w, C) normalized maps; keys (B, Ai, h*w, 1, Aj,
        num_types Aj) bool, each query's keys in each variant
        (``V2XViTFusion.key_mask``). Returns (B, Ai, Aj, h, w, C)."""
        b, ai, aj, hh, ww, c = y.shape
        heads, d, n = self.heads, self.dim_head, self.num_types
        dt = y.dtype
        runs = type_runs(types)
        # Each run of one type through its projections, gathered as
        # (B, Ai, hw, H, 1 + 2n, Aj, d): queries, then keys and values in
        # each query type's variant.
        parts = []
        for t, s, e in runs:
            w, bias = self.projections(t)
            p = F.linear(y[:, :, s:e], w.to(dt), bias.to(dt))
            parts.append(p.reshape(b, ai, e - s, hh * ww, 1 + 2 * n, heads, d)
                         .permute(0, 1, 3, 5, 4, 2, 6))
        p = torch.cat(parts, dim=5) if len(parts) > 1 else parts[0].contiguous()
        q = p[..., 0, :, :]  # (.., Aj, d)
        k = p[..., 1:1 + n, :, :].flatten(-3, -2)  # (.., n Aj, d)
        v = p[..., 1 + n:, :, :].flatten(-3, -2)
        # Each query scores every key in each variant; ``keys`` leaves
        # only its own type's variant.
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * d ** -0.5  # (.., Aj, n Aj)
        alpha = key_softmax(logits, keys)
        out = torch.matmul(alpha.to(dt), v).permute(0, 1, 4, 2, 3, 5)  # (B, Ai, Aj, hw, H, d)
        outs = []
        for t, s, e in runs:
            a = self.a_linears[t]
            o = out[:, :, s:e].reshape(b, ai, e - s, hh, ww, heads * d)
            outs.append(F.dropout(F.linear(o, a.weight.to(dt), a.bias.to(dt)), self.dropout, train))
        return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


class WindowAttention(nn.Module):
    """One MSwin branch (the public code's ``BaseWindowAttention``)."""

    def __init__(self, dim: int, heads: int, dim_head: int, window: int, relative: bool,
                 dropout: float):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.window, self.relative = heads, dim_head, window, relative
        self.dropout = dropout
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        side = 2 * window - 1 if relative else window * window
        self.pos_embedding = nn.Parameter(torch.randn(side, side))
        self.to_out = nn.Linear(inner, dim)
        if relative:
            self.register_buffer("rel_index", relative_index(window), persistent=False)

    def position_bias(self) -> torch.Tensor:
        """(s^2, s^2) float32: the bias of each (query, key) token pair."""
        if self.relative:
            return self.pos_embedding.flatten()[self.rel_index]
        return self.pos_embedding

    def forward(self, y: torch.Tensor, train: bool) -> torch.Tensor:
        """y (N, h, w, C) -> (N, h, w, C)."""
        n, h, w, c = y.shape
        s, m, d = self.window, self.heads, self.dim_head
        if h % s or w % s:
            raise ValueError(f"window {s} does not tile a {h}x{w} map")
        dt = y.dtype
        # Windows first, so that q, k and v are strided views of one GEMM's output.
        y = y.reshape(n, h // s, s, w // s, s, c).transpose(2, 3).reshape(-1, s * s, c)
        qkv = F.linear(y, self.to_qkv.weight.to(dt))  # (N nh nw, s^2, 3 m d)
        bias = self.position_bias().to(dt)
        # Small windows go to the kernel ``pack`` at a time as one sequence
        # whose bias keeps each window to itself.
        pack = max(1, PACK_TOKENS // (s * s))
        if (h // s) * (w // s) % pack:
            pack = 1
        if pack > 1:
            bias = torch.block_diag(*[bias] * pack)
            block = torch.ones(s * s, s * s, dtype=torch.bool, device=bias.device)
            own = torch.block_diag(*[block] * pack)
            bias = bias.masked_fill(~own, float("-inf"))
        qkv = qkv.reshape(-1, pack * s * s, 3, m, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (N nh nw / pack, m, pack s^2, d)
        out = window_attention(q, k, v, bias)
        out = out.transpose(1, 2).reshape(-1, s * s, m * d)
        out = F.linear(out, self.to_out.weight.to(dt), self.to_out.bias.to(dt))
        out = out.reshape(n, h // s, w // s, s, s, c).transpose(2, 3).reshape(n, h, w, c)
        return F.dropout(out, self.dropout, train)


class SplitAttn(nn.Module):
    """The branches' merge by a channel-wise softmax over them."""

    def __init__(self, dim: int, branches: int):
        super().__init__()
        self.branches = branches
        self.fc1 = nn.Linear(dim, dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc2 = nn.Linear(dim, dim * branches, bias=False)

    def forward(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """outs: branches of (N, h, w, C) -> (N, h, w, C); the gate in float32."""
        g = outs[0].mean(dim=(1, 2), dtype=torch.float32)  # (N, C)
        for o in outs[1:]:
            g = g + o.mean(dim=(1, 2), dtype=torch.float32)
        g = torch.relu(F.layer_norm(F.linear(g, self.fc1.weight), self.norm.normalized_shape,
                                    self.norm.weight, self.norm.bias, self.norm.eps))
        a = torch.softmax(F.linear(g, self.fc2.weight).reshape(g.shape[0], self.branches, -1),
                          dim=1)
        a = a.to(outs[0].dtype)[:, :, None, None, :]
        out = a[:, 0] * outs[0]
        for s in range(1, len(outs)):
            out = torch.addcmul(out, a[:, s], outs[s])
        return out


class MSwin(nn.Module):
    """Multi-scale window attention (the public code's
    ``PyramidWindowAttention``): ``split_attn`` or ``naive`` (the mean)
    merge of its branches."""

    def __init__(self, dim: int, heads: Sequence[int], dim_heads: Sequence[int],
                 windows: Sequence[int], relative: bool, fusion: str, dropout: float):
        super().__init__()
        if not len(heads) == len(dim_heads) == len(windows):
            raise ValueError("window_heads, window_dim_heads and window_sizes differ in length")
        if fusion not in ("split_attn", "naive"):
            raise ValueError(f"window_fusion must be 'split_attn' or 'naive', got {fusion!r}")
        self.windows = nn.ModuleList(
            WindowAttention(dim, m, d, s, relative, dropout)
            for m, d, s in zip(heads, dim_heads, windows))
        self.split_attn = SplitAttn(dim, len(windows)) if fusion == "split_attn" else None

    def forward(self, y: torch.Tensor, train: bool) -> torch.Tensor:
        outs = [branch(y, train) for branch in self.windows]
        if self.split_attn is None:
            return sum(outs) / len(outs)
        return self.split_attn(outs)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, y: torch.Tensor, train: bool) -> torch.Tensor:
        dt = y.dtype
        x = F.gelu(F.linear(y, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        x = F.dropout(x, self.dropout, train)
        x = F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        return F.dropout(x, self.dropout, train)


class V2XViTLayer(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, num_types: int,
                 window_heads, window_dim_heads, window_sizes, relative: bool,
                 window_fusion: str, mlp_dim: int, dropout: float):
        super().__init__()
        self.hmsa_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.hmsa = HMSA(dim, heads, dim_head, num_types, dropout)
        self.mswin_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.mswin = MSwin(dim, window_heads, window_dim_heads, window_sizes, relative,
                           window_fusion, dropout)
        self.ffn_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = FeedForward(dim, mlp_dim, dropout)


class V2XViTFusion(nn.Module):
    """V2X-ViT's fusion over ``channels``-wide maps; the keywords are the
    configuration's names (``benchmark/configs/v2xvit/config.json``)."""

    def __init__(self, grid: GridConfig, channels: int, depth: int = 3, heads: int = 8,
                 dim_head: int = 32, num_types: int = 2,
                 window_heads: Sequence[int] = (16, 8, 4),
                 window_dim_heads: Sequence[int] = (16, 32, 64),
                 window_sizes: Sequence[int] = (4, 8, 16), relative_pos_embedding: bool = True,
                 window_fusion: str = "split_attn", mlp_dim: int = 256, dropout: float = 0.3,
                 use_rte: bool = True, rte_ratio: int = 2, use_roi_mask: bool = True):
        super().__init__()
        if num_types not in (1, 2):
            raise ValueError(f"num_types must be 1 or 2 (vehicles, roadside unit), got {num_types}")
        self.grid = grid
        self.num_types = num_types
        self.rte_ratio = rte_ratio
        self.use_roi_mask = use_roi_mask
        self.rte = nn.Linear(channels, channels) if use_rte else None
        if use_rte:
            self.register_buffer("rte_table", sinusoid_table(RTE_MAX_LEN, channels),
                                 persistent=False)
        self.layers = nn.ModuleList(
            V2XViTLayer(channels, heads, dim_head, num_types, window_heads, window_dim_heads,
                        window_sizes, relative_pos_embedding, window_fusion, mlp_dim, dropout)
            for _ in range(depth))

    def key_mask(self, trans: torch.Tensor, mask: torch.Tensor, types: Sequence[int], h: int,
                 w: int) -> torch.Tensor:
        """(B, Ai, h*w, 1, Aj, num_types Aj) bool: for query j (in ego i's
        frame), key k in the variant of j's type where ``mask[k]``, and with
        ``use_roi_mask`` agent k's cover of ego i's cells; the ego's own
        map always."""
        b, a = mask.shape
        dev = mask.device
        keys = mask.to(torch.bool)[:, None, :, None, None].expand(b, a, a, h, w)
        if self.use_roi_mask:
            keys = keys & roi_all_pairs(trans, self.grid, h, w)
        keys = keys | torch.eye(a, dtype=torch.bool, device=dev)[None, :, :, None, None]
        keys = keys.permute(0, 1, 3, 4, 2).reshape(b, a, h * w, 1, 1, a)
        query_type = torch.empty(a, dtype=torch.long, device=dev)
        for t, s, e in type_runs(types):
            query_type[s:e] = t
        variant = torch.arange(self.num_types * a, device=dev) // a
        own = variant[None, :] == query_type[:, None]  # (Aj, num_types Aj)
        return keys.repeat(1, 1, 1, 1, 1, self.num_types) & own

    def forward(self, feats: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """feats (B, A, h, w, C) -> (B, A, h, w, C): each agent's map after
        the encoder over the A maps in its frame."""
        b, a, h, w, c = feats.shape
        dt = feats.dtype
        with span("det.fuse.sttf"):
            if self.rte is not None:
                delay = 0  # V2X-Sim's agents are synchronous
                e = self.rte_table[delay * self.rte_ratio]
                feats = feats + F.linear(e, self.rte.weight, self.rte.bias).to(dt)
            # The residual stream in float32 at least: (B, Ai, Aj, h, w, C).
            x = warp_neighbors(feats, trans, mask, self.grid).to(
                torch.promote_types(dt, torch.float32)).contiguous()
            types = agent_types(a, self.num_types)
            keys = self.key_mask(trans, mask, types, h, w)
        for layer in self.layers:
            with span("det.fuse.hmsa"):
                x = x + layer.hmsa(layer_norm(x, layer.hmsa_norm, dt), keys, types, train)
            with span("det.fuse.mswin"):
                y = layer_norm(x, layer.mswin_norm, dt).reshape(b * a * a, h, w, c)
                x = x + layer.mswin(y, train).reshape(x.shape)
            with span("det.fuse.ffn"):
                x = x + layer.ffn(layer_norm(x, layer.ffn_norm, dt), train)
        ego = torch.arange(a, device=x.device)
        return x[:, ego, ego].to(dt)
