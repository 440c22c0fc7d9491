"""V2VNet spatial GNN message passing.

Port of ``v2x_sim_tpu/models/det/v2vnet.py::V2VNetFusion``. Per round,
every agent warps the others' current hidden maps into its frame, encodes
each (neighbor, ego) pair into a message with two 3x3 convs, averages the
messages of its real neighbors (self and padded agents excluded), and
updates its hidden map with a ConvGRU step.

The pair is ``cat([warped, ego])``, the reverse of DiscoNet's order. The
first message conv is applied as two convs with the halves of its weight,
so the ego half runs once per ego agent instead of once per pair; the sum
is the conv of the concatenation.

``msg_norm`` GroupNorms the averaged message with flax's rule, written
out: ``min(32, C)`` groups, statistics in float32 (float64 for float64
maps), the variance as E[x^2] - E[x]^2 clipped at 0, epsilon 1e-6 (torch's
GroupNorm uses 1e-5 and the two-pass variance).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.models.backbone import fold_agents, unfold_agents
from v2x_sim_tpu_torch.models.convrnn import ConvGRUCell
from v2x_sim_tpu_torch.models.det.fusion import warp_neighbors
from v2x_sim_tpu_torch.utils.spans import span

GN_EPS = 1e-6


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """flax ``nn.GroupNorm`` of a channel-last (N, ..., C) map, in its dtype."""
    g = norm.num_groups
    acc = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(x.shape[0], -1, g, x.shape[-1] // g).to(acc)  # (N, S, G, C/G)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.to(acc).reshape(g, -1)
    y = (xg - mean) * mul + norm.bias.to(acc).reshape(g, -1)
    return y.reshape(x.shape).to(x.dtype)


class V2VNetFusion(nn.Module):
    """Multi-round GNN fusion with ConvGRU state updates."""

    def __init__(self, grid: GridConfig, channels: int, rounds: int = 3, msg_norm: bool = False):
        super().__init__()
        self.grid = grid
        self.rounds = rounds
        c = channels
        self.conv_gru = ConvGRUCell(c, c)
        self.msg_hidden = nn.Conv2d(2 * c, c, 3, padding=1)
        self.msg_out = nn.Conv2d(c, c, 3, padding=1)
        self.msg_norm = nn.GroupNorm(min(32, c), c, eps=GN_EPS) if msg_norm else None

    def forward(self, feats, trans, mask, train: bool = False) -> torch.Tensor:
        """feats (B, A, h, w, C) NHWC -> (B, A, h, w, C). ``train`` is
        accepted for the JAX signature; nothing here depends on it."""
        b, a, h, w, c = feats.shape
        dt = feats.dtype
        eye = torch.eye(a, dtype=dt, device=feats.device)
        pair_w = (1.0 - eye)[None, :, :, None, None, None] * mask[:, None, :, None, None, None].to(dt)
        n_nbr = pair_w[..., 0, 0, 0].sum(dim=2).clamp(min=1.0)  # (B, Ai)
        w1 = self.msg_hidden.weight.to(dt)
        w_nbr, w_ego = w1[:, :c], w1[:, c:]
        b1 = self.msg_hidden.bias.to(dt)
        w2, b2 = self.msg_out.weight.to(dt), self.msg_out.bias.to(dt)

        def conv(x, weight, bias=None):
            """3x3 pad-1 conv of an NHWC (N, h, w, C) map; NHWC out."""
            return F.conv2d(x.permute(0, 3, 1, 2), weight, bias, 1, 1).permute(0, 2, 3, 1)

        state = feats
        for _ in range(self.rounds):
            with span("det.fuse.round"):
                warped = warp_neighbors(state, trans, mask, self.grid)  # (B, Ai, Aj, h, w, C)
                m_nbr = conv(warped.reshape(b * a * a, h, w, c), w_nbr).reshape(b, a, a, h, w, c)
                m_ego = conv(fold_agents(state), w_ego, b1).reshape(b, a, 1, h, w, c)
                msg = torch.relu(m_nbr + m_ego)
                msg = torch.relu(conv(msg.reshape(b * a * a, h, w, c), w2, b2)).reshape(
                    b, a, a, h, w, c)
                agg = (msg * pair_w).sum(dim=2) / n_nbr[..., None, None, None]
                if self.msg_norm is not None:
                    agg = unfold_agents(group_norm(fold_agents(agg), self.msg_norm), a)
                state = self.conv_gru(state, agg)
        return state
