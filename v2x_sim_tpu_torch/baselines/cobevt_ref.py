"""CoBEVT's fused axial attention (FAX) in plain float32 PyTorch: the
reference that ``models/det/cobevt.py`` is held to.

Written from the paper's section 3 (arXiv:2207.02202) and the public
code's ``SwapFusionEncoder`` (github.com/DerrickXuNu/CoBEVT, inside
OpenCOOD: ``opencood/models/fuse_modules/swap_fusion_modules.py``),
literally: each ``rearrange`` as a reshape and a permute, the (agent,
row, column) relative index built from a meshgrid as Video-Swin builds
it, the logits ``q k^T / sqrt(d) + bias`` with the keys outside the ego's
mask filled with -inf, the softmax, and the mean over the agent slots
before the head. Every agent acts as ego, one row of slots an ego with
its own map first (the port's module docstring lists the departures from
the public code). It has no dropout: compare at inference, or training
at dropout 0.

Imports nothing of the port's fusion (``models/det/cobevt.py``), its warp,
``ops/cuda`` or ``csrc``: the bilinear warp is ``baselines/v2xvit_ref.py``'s,
written there over the same metric cell centres. Module names are the
port's, so one state dict loads into both. TF32 is switched off on
import.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from v2x_sim_tpu_torch.baselines.v2xvit_ref import warp_pairs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Attention(nn.Module):
    def __init__(self, dim, dim_head, agents, window):
        super().__init__()
        self.heads, self.dim_head = dim // dim_head, dim_head
        self.window_size = (agents, window, window)
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=False)
        self.relative_position_bias_table = nn.Embedding(
            (2 * agents - 1) * (2 * window - 1) * (2 * window - 1), self.heads)

    def relative_position_index(self, device) -> torch.Tensor:
        wd, wh, ww = self.window_size
        coords = torch.stack(torch.meshgrid(torch.arange(wd), torch.arange(wh), torch.arange(ww),
                                            indexing="ij"))
        flat = coords.flatten(1)  # 3, Wd*Wh*Ww
        rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
        rel[:, :, 0] += wd - 1
        rel[:, :, 1] += wh - 1
        rel[:, :, 2] += ww - 1
        rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
        rel[:, :, 1] *= 2 * ww - 1
        return rel.sum(-1).to(device)

    def forward(self, x, keys):
        """x (b, m, x, y, w1, w2, d); keys (b, m) bool."""
        b, m, nx, ny, w1, w2, _ = x.shape
        heads, d = self.heads, self.dim_head
        n = m * w1 * w2
        # 'b m x y w1 w2 d -> (b x y) (m w1 w2) d'
        x = x.permute(0, 2, 3, 1, 4, 5, 6).reshape(b * nx * ny, n, -1)
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        # 'b n (h d) -> b h n d'
        q, k, v = (t.reshape(b * nx * ny, n, heads, d).transpose(1, 2) for t in (q, k, v))
        sim = torch.einsum("bhid,bhjd->bhij", q / math.sqrt(d), k)
        idx = self.relative_position_index(x.device)
        bias = self.relative_position_bias_table(idx.reshape(-1)).reshape(n, n, heads)
        sim = sim + bias.permute(2, 0, 1)[None]
        # The keys of each sequence: its ego's slots, over (m w1 w2).
        key = keys[:, None, None, :, None].expand(b, nx, ny, m, w1 * w2).reshape(-1, 1, 1, n)
        sim = sim.masked_fill(~key, float("-inf"))
        out = torch.einsum("bhij,bhjd->bhid", torch.softmax(sim, dim=-1), v)
        # 'b h (l w1 w2) d -> b l w1 w2 (h d)'
        out = out.reshape(b * nx * ny, heads, m, w1, w2, d).permute(0, 2, 3, 4, 1, 5)
        out = self.to_out(out.reshape(b * nx * ny, m, w1, w2, heads * d))
        # '(b x y) l w1 w2 d -> b l x y w1 w2 d'
        return out.reshape(b, nx, ny, m, w1, w2, -1).permute(0, 3, 1, 2, 4, 5, 6)


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Layer(nn.Module):
    """The public ``SwapFusionBlockMask``: window attention and its FFN,
    then grid attention and its FFN, each ``x + fn(LayerNorm(x))``."""

    def __init__(self, dim, dim_head, agents, window, mlp_dim):
        super().__init__()
        self.window = window
        self.local_norm = nn.LayerNorm(dim)
        self.local_attn = Attention(dim, dim_head, agents, window)
        self.local_ffn_norm = nn.LayerNorm(dim)
        self.local_ffn = FeedForward(dim, mlp_dim)
        self.grid_norm = nn.LayerNorm(dim)
        self.grid_attn = Attention(dim, dim_head, agents, window)
        self.grid_ffn_norm = nn.LayerNorm(dim)
        self.grid_ffn = FeedForward(dim, mlp_dim)

    def forward(self, x, keys):
        """x (b, m, h, w, d); keys (b, m) bool."""
        b, m, h, w, d = x.shape
        s = self.window
        # 'b m (x w1) (y w2) d -> b m x y w1 w2 d'
        t = x.reshape(b, m, h // s, s, w // s, s, d).permute(0, 1, 2, 4, 3, 5, 6)
        t = t + self.local_attn(self.local_norm(t), keys)
        t = t + self.local_ffn(self.local_ffn_norm(t))
        x = t.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, m, h, w, d)
        # 'b m (w1 x) (w2 y) d -> b m x y w1 w2 d'
        t = x.reshape(b, m, s, h // s, s, w // s, d).permute(0, 1, 3, 5, 2, 4, 6)
        t = t + self.grid_attn(self.grid_norm(t), keys)
        t = t + self.grid_ffn(self.grid_ffn_norm(t))
        return t.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, m, h, w, d)


class CoBEVTRef(nn.Module):
    """The fusion: ``forward(feats (B, A, h, w, C), trans (B, A, A, 4, 4),
    mask (B, A)) -> (B, A, h, w, C)``; ``num_agents`` and the keywords are
    the port's ``CoBEVTFusion``'s (``dropout`` is accepted and not
    applied)."""

    def __init__(self, area_extents, channels: int, num_agents: int, depth: int = 3,
                 dim_head: int = 32, mlp_dim: int = 256, window_size: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.extents = area_extents
        self.layers = nn.ModuleList(Layer(channels, dim_head, num_agents, window_size, mlp_dim)
                                    for _ in range(depth))
        self.head_norm = nn.LayerNorm(channels)
        self.head = nn.Linear(channels, channels)

    def forward(self, feats, trans, mask, train: bool = False):
        b, a, h, w, c = feats.shape
        x = warp_pairs(feats.float(), trans, self.extents) * mask[:, None, :, None, None, None].float()
        order = [[i] + [j for j in range(a) if j != i] for i in range(a)]  # the ego first
        x = torch.stack([x[:, i, order[i]] for i in range(a)], dim=1)  # (B, Ai, L, h, w, C)
        keys = torch.stack([mask.bool()[:, order[i]] for i in range(a)], dim=1)
        keys[:, :, 0] = True
        x, keys = x.reshape(b * a, a, h, w, c), keys.reshape(b * a, a)
        for layer in self.layers:
            x = layer(x, keys)
        # Reduce('b m d h w -> b d h w', 'mean'), LayerNorm, Linear
        return self.head(self.head_norm(x.mean(dim=1))).reshape(b, a, h, w, c)
