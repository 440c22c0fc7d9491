"""Intermediate fusion over the agent axis.

Port of ``v2x_sim_tpu/models/det/fusion.py`` (``warp_neighbors`` and
``DiscoFusion``). Contract:

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
