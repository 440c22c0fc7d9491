"""CoBEVT's fused axial attention, FAX (Xu et al., CoRL 2022,
arXiv:2207.02202).

A mode of the port only (``models/det/net.py::PORT_MODES``): the JAX
package has no counterpart. Every agent acts as ego at once, as the
port's other fusions do. For ego i, the fusion runs the paper's FAX
encoder over the A maps warped into i's frame:

  1. Slots: ``X[:, i, l] = warp_neighbors(x)[:, i, order[i, l]]`` (the
     port's bilinear warp, padded sources zeroed), with ``order[i] = (i,
     then the other agents in index order)``: the ego's own map in slot 0,
     as the public code's ``regroup`` lays out its agents. (B, Ai, L = A,
     h, w, C). The key mask ``keys[i, l] = mask[order[i, l]]``, slot 0
     always a key.
  2. ``depth`` layers, each pre-LayerNorm with a residual around every
     part:
       * local attention: the map cut into (h/s)(w/s) windows of s x s
         pixels, ``(x w1) (y w2)``, each window one sequence of L s^2
         tokens across the L slots;
       * FFN: Linear(C, mlp_dim), exact GELU, Linear(mlp_dim, C);
       * grid attention: the same on the dilated partition ``(w1 x) (w2
         y)``: group (x, y) holds pixel (w1 h/s + x, w2 w/s + y), tokens
         h/s pixels apart, so every token sees the whole map at a stride;
       * FFN again.
     Attention (the public code's ``Attention``): ``to_qkv`` Linear(C, 3C)
     without bias, C/dim_head heads, ``logit = q k^T / sqrt(dim_head) +
     P[idx(q, k)]`` with keys outside ``keys[i]`` at -inf, softmax,
     ``to_out`` Linear(C, C) without bias. P is an ``nn.Embedding`` of
     (2L-1)(2s-1)(2s-1) rows, one column a head, indexed over the tokens'
     (slot, row, column) offsets as Video-Swin does:
     ``((l_q - l_k + L - 1)(2s - 1) + r_q - r_k + s - 1)(2s - 1) + c_q -
     c_k + s - 1``.
  3. ``fused[:, i] = head(LN(mean over the L slots of X[:, i]))`` (the
     public ``mlp_head``: ``Reduce('b m d h w -> b d h w', 'mean')``,
     LayerNorm, Linear), padded slots included in the mean as in the
     public code.

Dropout (rate ``dropout``) follows each attention's ``to_out`` and both
FFN Linears, in training only (``train``). The key mask always applies
(the public code's ``SwapFusionBlockMask``).

Departures from the public code (github.com/DerrickXuNu/CoBEVT;
``opencood/models/fuse_modules/swap_fusion_modules.py`` inside OpenCOOD):
  * every agent is ego, not agent 0 alone;
  * the port's all-pairs feature warp on the STPN's stage map replaces
    OpenCOOD's point-cloud projection and the PointPillars backbone with
    its shrink header; the key mask is per agent, not per projected pixel;
  * the relative index and the slot order are non-persistent buffers
    (they are computed, and persistent ones would be redrawn with the
    weights; held on the device, they cost no copy from the host a call);
  * module names: one LayerNorm and one part per residual
    (``local_norm``, ``local_attn``, ``local_ffn_norm``, ``local_ffn``,
    then ``grid_*``) where the public code nests ``PreNormResidual``s;
    ``to_out`` is a Linear, not a Sequential with its dropout; the head is
    ``head_norm`` and ``head``.

The card's attention path: q, k and v are laid out as (ego x head,
window, token, dim_head), so that one (E heads, L s^2, L s^2) bias, the
position bias plus the ego's key mask, is built once a block and
broadcast over the windows (a stride of 0): never per window. The key
mask is an additive -inf, so the same kernel runs whatever the agent mask
holds and nothing waits on the host.

Numerics in bf16, as ``models/det/v2xvit.py``: the residual stream (X) is
held in float32; LayerNorm (statistics and output) and the slot mean run
in float32; every GEMM's operands and the attention's in the activation
dtype. ``baselines/cobevt_ref.py`` is the plain float32 reference, with
this module's state-dict names.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.models.det.fusion import warp_neighbors
from v2x_sim_tpu_torch.models.det.v2xvit import LN_EPS, FeedForward, layer_norm, window_attention
from v2x_sim_tpu_torch.utils.spans import span


def slot_order(num_agents: int) -> torch.Tensor:
    """(Ai, L) long: ego i's agent in each slot, i first, then the others
    in index order."""
    return torch.tensor([[i] + [j for j in range(num_agents) if j != i]
                         for i in range(num_agents)])


def relative_index(agents: int, s: int) -> torch.Tensor:
    """(L s^2, L s^2) long: the row of the bias table of token pair (q, k)
    of an (agents, s, s) window, tokens in (slot, row, column) order."""
    coords = torch.stack(torch.meshgrid(torch.arange(agents), torch.arange(s), torch.arange(s),
                                        indexing="ij")).flatten(1)  # (3, N)
    rel = coords[:, :, None] - coords[:, None, :]  # [., q, k] = coord_q - coord_k
    dl, dr, dc = rel[0] + agents - 1, rel[1] + s - 1, rel[2] + s - 1
    return (dl * (2 * s - 1) + dr) * (2 * s - 1) + dc


class FAXAttention(nn.Module):
    """Attention over (slot, s, s) windows (the public code's ``Attention``)."""

    def __init__(self, dim: int, dim_head: int, agents: int, window: int, dropout: float):
        super().__init__()
        if dim % dim_head:
            raise ValueError(f"channels {dim} are not a multiple of dim_head {dim_head}")
        self.heads, self.dim_head, self.window = dim // dim_head, dim_head, window
        self.dropout = dropout
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=False)
        self.relative_position_bias_table = nn.Embedding(
            (2 * agents - 1) * (2 * window - 1) ** 2, self.heads)
        self.register_buffer("relative_position_index", relative_index(agents, window),
                             persistent=False)

    def position_bias(self) -> torch.Tensor:
        """(heads, N, N) float32: each head's bias of each token pair."""
        return self.relative_position_bias_table.weight[self.relative_position_index].permute(2, 0, 1)

    def forward(self, y: torch.Tensor, key_bias: torch.Tensor, grid: bool,
                train: bool) -> torch.Tensor:
        """y (E, L, h, w, C) normalized maps, one row of slots an ego;
        key_bias (E, 1, 1, L s^2) 0 or -inf in y's dtype; ``grid``: the
        dilated partition, else windows. Returns (E, L, h, w, C)."""
        e, slots, h, w, c = y.shape
        s, m, d = self.window, self.heads, self.dim_head
        nx, ny, n = h // s, w // s, slots * s * s
        dt = y.dtype
        qkv = F.linear(y, self.to_qkv.weight.to(dt))
        if grid:  # pixel (w1 nx + x, w2 ny + y)
            qkv = qkv.reshape(e, slots, s, nx, s, ny, 3, m, d).permute(6, 0, 7, 3, 5, 1, 2, 4, 8)
        else:  # pixel (x s + w1, y s + w2)
            qkv = qkv.reshape(e, slots, nx, s, ny, s, 3, m, d).permute(6, 0, 7, 2, 4, 1, 3, 5, 8)
        q, k, v = qkv.reshape(3, e * m, nx * ny, n, d).unbind(0)
        # One bias an (ego, head), the same in each of its windows.
        bias = (self.position_bias().to(dt)[None] + key_bias).reshape(e * m, 1, n, n)
        out = window_attention(q, k, v, bias.expand(e * m, nx * ny, n, n))
        out = out.reshape(e, m, nx, ny, slots, s, s, d)
        out = out.permute(0, 4, 5, 2, 6, 3, 1, 7) if grid else out.permute(0, 4, 2, 5, 3, 6, 1, 7)
        out = F.linear(out.reshape(e, slots, h, w, m * d), self.to_out.weight.to(dt))
        return F.dropout(out, self.dropout, train)


class FAXLayer(nn.Module):
    def __init__(self, dim: int, dim_head: int, agents: int, window: int, mlp_dim: int,
                 dropout: float):
        super().__init__()
        self.local_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.local_attn = FAXAttention(dim, dim_head, agents, window, dropout)
        self.local_ffn_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.local_ffn = FeedForward(dim, mlp_dim, dropout)
        self.grid_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.grid_attn = FAXAttention(dim, dim_head, agents, window, dropout)
        self.grid_ffn_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.grid_ffn = FeedForward(dim, mlp_dim, dropout)


class CoBEVTFusion(nn.Module):
    """CoBEVT's FAX fusion over ``channels``-wide maps of ``num_agents``
    agents; the keywords are the configuration's names
    (``benchmark/configs/cobevt/config.json``)."""

    def __init__(self, grid: GridConfig, channels: int, num_agents: int, depth: int = 3,
                 dim_head: int = 32, mlp_dim: int = 256, window_size: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.grid = grid
        self.window_size = window_size
        self.layers = nn.ModuleList(
            FAXLayer(channels, dim_head, num_agents, window_size, mlp_dim, dropout)
            for _ in range(depth))
        self.head_norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.head = nn.Linear(channels, channels)
        self.register_buffer("order", slot_order(num_agents), persistent=False)

    def key_bias(self, mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B Ai, 1, 1, L s^2) in ``dtype``: 0 where the token's slot is a
        key of the ego (its agent is real, or it is slot 0), else -inf."""
        b, a = mask.shape
        keys = mask.to(torch.bool)[:, self.order]  # (B, Ai, L)
        keys[:, :, 0] = True
        s2 = self.window_size ** 2
        bias = torch.zeros(keys.shape, dtype=dtype, device=mask.device)
        bias = bias.masked_fill(~keys, float("-inf"))
        return bias.repeat_interleave(s2, dim=-1).reshape(b * a, 1, 1, a * s2)

    def forward(self, feats: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """feats (B, A, h, w, C) -> (B, A, h, w, C): each agent's map after
        the encoder over the A maps in its frame."""
        b, a, h, w, c = feats.shape
        s = self.window_size
        if h % s or w % s:
            raise ValueError(f"window {s} does not tile a {h}x{w} map")
        dt = feats.dtype
        with span("det.fuse.warp"):
            ego = torch.arange(a, device=feats.device)[:, None]
            # The residual stream in float32 at least: (B Ai, L, h, w, C).
            x = warp_neighbors(feats, trans, mask, self.grid)[:, ego, self.order]
            x = x.to(torch.promote_types(dt, torch.float32)).reshape(b * a, a, h, w, c)
            key_bias = self.key_bias(mask, dt)
        for layer in self.layers:
            with span("det.fuse.fax_local"):
                x = x + layer.local_attn(layer_norm(x, layer.local_norm, dt), key_bias, False,
                                         train)
            with span("det.fuse.ffn"):
                x = x + layer.local_ffn(layer_norm(x, layer.local_ffn_norm, dt), train)
            with span("det.fuse.fax_grid"):
                x = x + layer.grid_attn(layer_norm(x, layer.grid_norm, dt), key_bias, True, train)
            with span("det.fuse.ffn"):
                x = x + layer.grid_ffn(layer_norm(x, layer.grid_ffn_norm, dt), train)
        with span("det.fuse.head"):
            y = layer_norm(x.mean(dim=1), self.head_norm, dt)
            y = F.linear(y, self.head.weight.to(dt), self.head.bias.to(dt))
            return y.reshape(b, a, h, w, c)
