"""When2com / Who2com learned communication gating.

Port of ``v2x_sim_tpu/models/det/when2com.py``. Each agent pools its map
into a query and a key (``QueryKeyNet``); scores q_i . W k_j / sqrt(32)
over real sources, softmaxed, weight the ego-frame warped neighbor maps.

In training the soft attention is used as it is. At inference, who2com
keeps self plus the single best partner at 1/2 each (full self weight
when there is no real partner), and when2com zeroes the links weaker than
uniform (1 / real agents, self always kept) and renormalizes.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.models.det.fusion import NEG_INF, warp_neighbors

QUERY_DIM = 32
KEY_DIM = 256


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class QueryKeyNet(nn.Module):
    """Three 3x3 stride-2 convs (64, 128, 256; pad 1 each side) with ReLU,
    a global average pool, and Dense query/key projections. Flax names
    the convs ``Conv_0..2``, and so does the port."""

    def __init__(self, channels: int):
        super().__init__()
        cin = channels
        for i, ch in enumerate((64, 128, 256)):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, ch, 3, stride=2, padding=1))
            cin = ch
        self.query_proj = nn.Linear(cin, QUERY_DIM)
        self.key_proj = nn.Linear(cin, KEY_DIM)

    def forward(self, x: torch.Tensor):
        """(N, h, w, C) NHWC -> query (N, 32), key (N, 256)."""
        y = x.permute(0, 3, 1, 2)
        for i in range(3):
            conv = getattr(self, f"Conv_{i}")
            y = torch.relu(F.conv2d(y, conv.weight.to(x.dtype), conv.bias.to(x.dtype), 2, 1))
        v = y.mean(dim=(2, 3))
        return _linear(v, self.query_proj), _linear(v, self.key_proj)


class When2comFusion(nn.Module):
    """Attention-gated fusion.

    Args:
      argmax_mode: who2com's hard partner choice at inference.
      threshold: when2com's pruning of links below uniform at inference.
      warp_flag: warp the neighbors into the ego frame first; without it
        the raw neighbor maps are mixed (the reference's ablation).
    """

    def __init__(self, grid: GridConfig, channels: int, argmax_mode: bool = False,
                 threshold: bool = True, warp_flag: bool = True):
        super().__init__()
        self.grid = grid
        self.argmax_mode = argmax_mode
        self.threshold = threshold
        self.warp_flag = warp_flag
        self.query_key_net = QueryKeyNet(channels)
        self.attn_w = nn.Linear(KEY_DIM, QUERY_DIM, bias=False)

    def attention(self, feats, mask, train: bool = False) -> torch.Tensor:
        """(B, A, h, w, C), (B, A) -> the (B, Ai, Aj) weights the fusion uses."""
        b, a, h, w, c = feats.shape
        dt = feats.dtype
        q, k = self.query_key_net(feats.reshape(b * a, h, w, c))
        q, k = q.reshape(b, a, -1), k.reshape(b, a, -1)
        wk = _linear(k, self.attn_w)
        # Scaled in the feature dtype, as JAX's sqrt of a feature-dtype 32.
        scores = torch.einsum("biq,bjq->bij", q, wk) / torch.tensor(
            float(QUERY_DIM), dtype=dt, device=feats.device).sqrt()
        scores = torch.where(mask[:, None, :], scores, torch.full_like(scores, NEG_INF))
        attn = torch.softmax(scores, dim=-1)
        if train:
            return attn
        eye = torch.eye(a, dtype=torch.bool, device=feats.device)[None]
        if self.argmax_mode:
            partner = torch.where(eye, torch.full_like(scores, NEG_INF), scores)
            hard = F.one_hot(partner.argmax(dim=-1), a).to(attn.dtype)
            # An ego with no real partner keeps full self weight.
            has_partner = (partner.amax(dim=-1) > NEG_INF / 2)[..., None].to(attn.dtype)
            self_hot = eye.to(attn.dtype)
            return 0.5 * (hard * has_partner + self_hot) + 0.5 * self_hot * (1.0 - has_partner)
        if self.threshold:
            uniform = 1.0 / mask.sum(dim=1).clamp(min=1).to(torch.float32)
            keep = (attn >= uniform[:, None, None]) | eye
            attn = attn * keep
            attn = attn / attn.sum(dim=-1, keepdim=True).clamp(min=1e-6)
        return attn

    def forward(self, feats, trans, mask, train: bool = False) -> torch.Tensor:
        """feats (B, A, h, w, C) NHWC -> fused (B, A, h, w, C)."""
        attn = self.attention(feats, mask, train)
        if self.warp_flag:
            return torch.einsum("bij,bijhwc->bihwc", attn,
                                warp_neighbors(feats, trans, mask, self.grid))
        # Unwarped, every ego sees the same masked source maps.
        src = feats * mask[:, :, None, None, None].to(feats.dtype)
        return torch.einsum("bij,bjhwc->bihwc", attn, src)
