"""V2VNet's fusion (arXiv:2008.07519), the part of the reference that only
the ``v2vnet`` configuration has, written from the paper's equations as
the port's configuration sets them (3 rounds, no message norm):

    for each round:
        m_{j->i} = relu(conv_out(relu(conv_hidden(cat([warp_{j->i}(h_j), h_i])))))
        M_i      = mean of m_{j->i} over the real neighbours j != i
        h_i      = ConvGRU(h_i, M_i)

with 3x3 pad-1 convs, the warp of ``model.warp_all_pairs`` and a ConvGRU
whose ``gates`` conv gives (z, r) from ``cat([h, M])`` and whose
``candidate`` conv reads ``cat([r * h, M])``: h' = (1 - z) h + z tanh(cand).
Only the A(A-1) neighbour messages are computed; ``conv_hidden`` runs as
two convs with the halves of its weight, the warped half once a pair and
the ego half once an agent (the same sum). Module names are the port's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.model import Precision, warp_all_pairs


class ConvGRU(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gates = nn.Conv2d(2 * c, 2 * c, 3, padding=1)
        self.candidate = nn.Conv2d(2 * c, c, 3, padding=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor, p: Precision) -> torch.Tensor:
        z, r = torch.sigmoid(p.conv(torch.cat([h, x], dim=1), self.gates)).chunk(2, dim=1)
        cand = p.conv(torch.cat([r * h, x], dim=1), self.candidate)
        return (1.0 - z) * h + z * torch.tanh(cand)


class V2VFusion(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        c = config["stage_channels"][config["fusion_layer"]]
        self.rounds = config["fusion"]["rounds"]
        self.extents = config["grid"]["area_extents"]
        self.conv_gru = ConvGRU(c)
        self.msg_hidden = nn.Conv2d(2 * c, c, 3, padding=1)
        self.msg_out = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, feats: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor,
                p: Precision) -> torch.Tensor:
        """feats (B, A, C, h, w) -> fused (B, A, C, h, w)."""
        b, a, c, h, w = feats.shape
        ii, jj = (~torch.eye(a, dtype=torch.bool, device=feats.device)).nonzero(as_tuple=True)
        nbr_w = mask[:, jj].to(feats.dtype).reshape(b, a, a - 1, 1, 1, 1)
        n_nbr = nbr_w.sum(dim=2).clamp(min=1.0)
        w1 = p.weight(self.msg_hidden.weight)
        state = feats
        for _ in range(self.rounds):
            warped = warp_all_pairs(state, trans, self.extents)[:, ii, jj]  # (B, A(A-1), C, h, w)
            m_nbr = p.act(F.conv2d(p.act(warped.reshape(-1, c, h, w)), w1[:, :c], None, 1, 1))
            m_ego = p.act(F.conv2d(p.act(state.reshape(b * a, c, h, w)), w1[:, c:],
                                   self.msg_hidden.bias, 1, 1))
            msg = torch.relu(m_nbr.reshape(b, a, a - 1, c, h, w) + m_ego.reshape(b, a, 1, c, h, w))
            msg = torch.relu(p.conv(msg.reshape(-1, c, h, w), self.msg_out))
            agg = (msg.reshape(b, a, a - 1, c, h, w) * nbr_w).sum(dim=2) / n_nbr
            state = self.conv_gru(state.reshape(b * a, c, h, w), agg.reshape(b * a, c, h, w),
                                  p).reshape(b, a, c, h, w)
        return state


def build_fusion(config: dict) -> nn.Module:
    return V2VFusion(config)
