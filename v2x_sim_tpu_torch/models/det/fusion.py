"""Intermediate fusion over the agent axis.

Port of ``v2x_sim_tpu/models/det/fusion.py``: ``warp_neighbors``, the
parameter-free ``fuse_sum``/``fuse_mean``/``fuse_max``, and
``CatFusion``, ``AgentWiseWeightedFusion`` and ``DiscoFusion``. Contract:

    fuse(feats[B, A, h, w, C], trans[B, A, A, 4, 4], mask[B, A]) ->
        fused[B, A, h, w, C]

where every agent acts as ego at once. Padded agents (mask False)
contribute nothing: their warped maps are zeroed and their scores sit at
-1e9 before the softmax over the source axis.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.ops.warp import warp_all_pairs

NEG_INF = -1e9


def _src_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, A) -> (B, 1, A, 1, 1, 1) broadcast mask over warped pairs."""
    return mask[:, None, :, None, None, None]


def warp_neighbors(feats, trans, mask, grid: GridConfig) -> torch.Tensor:
    """All-pairs warp with padded sources zeroed: (B, Ai, Aj, h, w, C)."""
    warped = warp_all_pairs(feats, trans, grid)
    return warped * _src_mask(mask).to(feats.dtype)


def fuse_sum(feats, trans, mask, grid: GridConfig) -> torch.Tensor:
    """SumFusion: elementwise sum of the warped neighbor maps."""
    return warp_neighbors(feats, trans, mask, grid).sum(dim=2)


def fuse_mean(feats, trans, mask, grid: GridConfig) -> torch.Tensor:
    """MeanFusion: the sum over real agents over their count (at least 1)."""
    n = mask.sum(dim=1).clamp(min=1).to(feats.dtype)
    return fuse_sum(feats, trans, mask, grid) / n[:, None, None, None, None]


def fuse_max(feats, trans, mask, grid: GridConfig) -> torch.Tensor:
    """MaxFusion: elementwise max over sources, padded ones at -1e9.
    ``amax`` splits the gradient evenly among tied maxima, as JAX's max
    does (``max(dim=...)`` would send it all to one)."""
    warped = warp_all_pairs(feats, trans, grid)
    warped = torch.where(_src_mask(mask), warped, torch.full((), NEG_INF, dtype=warped.dtype,
                                                             device=warped.device))
    return warped.amax(dim=2)


class CatFusion(nn.Module):
    """CatFusion: the A warped maps concatenated agent-major along channels
    (channel ``j*C + c`` is source j's channel c), a 1x1 conv back to C,
    ReLU. The concatenation is never built: the conv is one contraction
    over (source, channel)."""

    def __init__(self, grid: GridConfig, channels: int, num_agents: int):
        super().__init__()
        self.grid = grid
        self.compress = nn.Conv2d(num_agents * channels, channels, 1)

    def forward(self, feats, trans, mask, train: bool = False) -> torch.Tensor:
        b, a, h, w, c = feats.shape
        dt = feats.dtype
        warped = warp_neighbors(feats, trans, mask, self.grid)  # (B, Ai, Aj, h, w, C)
        wt = self.compress.weight[:, :, 0, 0].to(dt).reshape(c, a, c)  # (out, Aj, C)
        x = torch.einsum("bijhwc,ojc->bihwo", warped, wt) + self.compress.bias.to(dt)
        return torch.relu(x)


class AgentWiseWeightedFusion(nn.Module):
    """AgentWiseWeightedFusion: one scalar weight per (ego, source) pair from
    the spatial mean of ``cat([ego, warped])`` through a 2-layer MLP,
    softmax over sources, weighted sum of the warped maps. The mean of the
    concatenation is the concatenation of the two means."""

    def __init__(self, grid: GridConfig, channels: int, hidden: int = 32):
        super().__init__()
        self.grid = grid
        self.score_hidden = nn.Linear(2 * channels, hidden)
        self.score = nn.Linear(hidden, 1)

    def forward(self, feats, trans, mask, train: bool = False) -> torch.Tensor:
        dt = feats.dtype
        warped = warp_neighbors(feats, trans, mask, self.grid)
        ego = feats.mean(dim=(2, 3))[:, :, None].expand(-1, -1, feats.shape[1], -1)
        pooled = torch.cat([ego, warped.mean(dim=(3, 4))], dim=-1)  # (B, Ai, Aj, 2C)
        s = torch.relu(F.linear(pooled, self.score_hidden.weight.to(dt),
                                self.score_hidden.bias.to(dt)))
        s = F.linear(s, self.score.weight.to(dt), self.score.bias.to(dt))[..., 0]  # (B, Ai, Aj)
        s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG_INF))
        attn = torch.softmax(s, dim=-1)
        return torch.einsum("baj,bajhwc->bahwc", attn, warped)


class DiscoFusion(nn.Module):
    """DiscoNet pixel-weighted fusion: a 1x1-conv edge encoder scores each
    (ego, warped source) pair per pixel, softmax across sources, weighted sum.

    ``edge_hidden`` acts on ``cat([ego, warped])``; it is applied as two
    products with the halves of its weight, so the ego half runs once per
    ego agent and the A-fold concatenated map never exists.
    """

    def __init__(self, grid: GridConfig, channels: int, hidden: int = 32):
        super().__init__()
        self.grid = grid
        self.edge_hidden = nn.Conv2d(2 * channels, hidden, 1)
        self.edge_score = nn.Conv2d(hidden, 1, 1)

    def forward(self, feats, trans, mask, train: bool = False) -> torch.Tensor:
        """feats (B, A, h, w, C) NHWC -> fused (B, A, h, w, C). ``train`` is
        accepted for the JAX signature; the fusion has no BatchNorm."""
        c = feats.shape[-1]
        dt = feats.dtype
        warped = warp_neighbors(feats, trans, mask, self.grid)
        w_hidden = self.edge_hidden.weight[:, :, 0, 0].to(dt)  # (hidden, 2C)
        s = F.linear(feats, w_hidden[:, :c])[:, :, None] + F.linear(
            warped, w_hidden[:, c:], self.edge_hidden.bias.to(dt)
        )
        s = F.linear(
            torch.relu(s),
            self.edge_score.weight[:, :, 0, 0].to(dt),
            self.edge_score.bias.to(dt),
        )  # (B, Ai, Aj, h, w, 1)
        s = torch.where(_src_mask(mask), s, torch.full_like(s, NEG_INF))
        attn = torch.softmax(s, dim=2)
        return (attn * warped).sum(dim=2)
