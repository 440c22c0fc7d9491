"""DiscoNet's fusion (arXiv:2111.00643), the part of the reference that
only the ``disconet`` configuration has.

Frozen copy of ``DiscoFusion`` in ``v2x_sim_tpu_torch/baselines/torch_ref.py``
(commit 73ef7cd): every agent is ego at once; each (ego, warped source)
pair is scored per pixel by a 1x1 edge encoder on ``cat([ego, warped])``,
the scores are softmaxed over the sources (padded ones at -1e9, their maps
zeroed) and weight the sum of the warped maps. One departure: the edge
encoder's first conv runs as two convs with the halves of its weight, the
ego half once an ego agent and the warped half once a pair, which is the
same sum and the work the analytic count (``flops.py``) counts.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.model import Precision, warp_all_pairs

NEG_INF = -1e9


class DiscoFusion(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        c = config["stage_channels"][config["fusion_layer"]]
        hidden = config["fusion"]["edge_hidden"]
        self.extents = config["grid"]["area_extents"]
        self.edge_hidden = nn.Conv2d(2 * c, hidden, 1)
        self.edge_score = nn.Conv2d(hidden, 1, 1)

    def forward(self, feats: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor,
                p: Precision) -> torch.Tensor:
        """feats (B, A, C, h, w) -> fused (B, A, C, h, w)."""
        b, a, c, h, w = feats.shape
        src = mask[:, None, :, None, None, None]
        warped = warp_all_pairs(feats, trans, self.extents) * src.to(feats.dtype)
        wh = p.weight(self.edge_hidden.weight)
        ego = p.act(F.conv2d(p.act(feats.reshape(b * a, c, h, w)), wh[:, :c]))
        pair = p.act(F.conv2d(p.act(warped.reshape(b * a * a, c, h, w)), wh[:, c:],
                              self.edge_hidden.bias))
        hid = ego.reshape(b, a, 1, -1, h, w) + pair.reshape(b, a, a, -1, h, w)
        s = p.conv(torch.relu(hid).reshape(b * a * a, -1, h, w), self.edge_score)
        s = torch.where(src, s.reshape(b, a, a, 1, h, w), torch.full((), NEG_INF, device=s.device))
        return (torch.softmax(s, dim=2) * warped).sum(dim=2)


def build_fusion(config: dict) -> nn.Module:
    return DiscoFusion(config)
