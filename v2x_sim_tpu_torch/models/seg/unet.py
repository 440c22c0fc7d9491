"""BEV semantic segmentation: a UNet with collaboration fusion at its
bottleneck, in every collaboration mode.

Port of ``v2x_sim_tpu/models/seg/unet.py::{DoubleConv, SegModel}`` in its
plain layout (``s2d=False``; the JAX package's space-to-depth execution
re-arranges the same math for the TPU and keeps the same param tree).
Input contract as ``models/det/net.py``: occupancy (B, A, H, W, D),
trans (B, A, A, 4, 4), agent_mask (B, A). Output: ``SegOutput(logits
(B, A, H, W, num_seg_classes))`` in float32.

Each down stage is a ``DoubleConv`` whose output is kept as the skip
before a 2x2 max pool; the bottleneck's map (B*A, C, H/2^depth, ...) is
fused across agents by the det fusion modules (none for lowerbound and
upperbound, whose input is already merged); each up stage resizes
bilinearly to its skip's size and convolves ``cat([up, skip])``; a 1x1
conv with a bias gives the logits. Module names follow the flax tree
through ``bridge.seg_key_map``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.models.backbone import (
    BatchNormGroup,
    ConvBlock,
    _conv,
    fold_agents,
    unfold_agents,
    upsample_bilinear,
)
from v2x_sim_tpu_torch.models.det.net import NO_FUSION, build_fusion, check_mode, fuse_agents

UNET_CHANNELS: Tuple[int, ...] = (32, 64, 128, 256)


class DoubleConv(ConvBlock):
    """2 x (3x3 conv without bias, BatchNorm with flax's momentum 0.9,
    ReLU), stride 1: the det backbone's ``ConvBlock`` (flax's SAME pad is
    the explicit pad of 1 at stride 1)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, stride=1)


class SegOutput(NamedTuple):
    """logits (B, A, H, W, num_seg_classes), float32."""

    logits: torch.Tensor


class SegModel(BatchNormGroup, nn.Module):
    """UNet with collaboration fusion at the bottleneck.

    Args:
      width_mult: uniform scale of UNET_CHANNELS and the bottleneck, each
        width ``max(8, round(c * width_mult))``.
      depth: down/up stages, 1..4; the bottleneck sits at H / 2^depth.

    ``set_process_group``: as ``DetModel``'s.
    """

    def __init__(self, config: Config, mode: str = "lowerbound", width_mult: float = 1.0,
                 depth: int = 4):
        super().__init__()
        check_mode(mode)
        if not 1 <= depth <= len(UNET_CHANNELS):
            raise ValueError(f"depth must be in [1, {len(UNET_CHANNELS)}], got {depth}")
        self.config = config
        self.mode = mode
        self.depth = depth

        def w(c):
            return max(8, int(round(c * width_mult)))

        chans = [w(c) for c in UNET_CHANNELS[:depth]]
        cin = config.grid.grid_shape[2]
        downs = []
        for ch in chans:
            downs.append(DoubleConv(cin, ch))
            cin = ch
        self.downs = nn.ModuleList(downs)
        width = w(2 * UNET_CHANNELS[depth - 1])
        self.bottleneck = DoubleConv(cin, width)
        ups, cin = [], width
        for ch in reversed(chans):
            ups.append(DoubleConv(cin + ch, ch))  # cat([upsampled, skip])
            cin = ch
        self.ups = nn.ModuleList(ups)
        self.head = nn.Conv2d(cin, config.num_seg_classes, 1)
        # No warp_flag (when2com always warps), 3 v2v rounds, no message norm.
        self.fusion = build_fusion(mode, config.grid, width, config.num_agents)

    # The forward pass in stages, so a profiler can time each one. Maps
    # are NCHW views of channels-last memory, as in the det backbone.

    def encode(self, occupancy: torch.Tensor, train: bool = False
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B, A, H, W, D) -> the pooled last stage's map (B*A, C, h, w)
        and the skips, each down stage's output before its pool."""
        x = fold_agents(occupancy).permute(0, 3, 1, 2)
        skips = []
        for down in self.downs:
            x = down(x, train)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        return x, skips

    def fuse(self, x: torch.Tensor, trans, agent_mask, train: bool = False) -> torch.Tensor:
        """The bottleneck's map fused across agents (as it is for
        lowerbound and upperbound)."""
        if self.mode in NO_FUSION:
            return x
        f = unfold_agents(x.permute(0, 2, 3, 1), agent_mask.shape[1])  # (B, A, h, w, C)
        fused = fuse_agents(self.mode, self.fusion, f, trans, agent_mask, self.config.grid, train)
        return fold_agents(fused).permute(0, 3, 1, 2)

    def decode(self, x: torch.Tensor, skips: List[torch.Tensor], num_agents: int,
               train: bool = False) -> SegOutput:
        """Up stages over the skips, deepest first, then the 1x1 head."""
        for up, skip in zip(self.ups, reversed(skips)):
            x = upsample_bilinear(x, skip.shape[-2:])
            x = up(torch.cat([x, skip.to(x.dtype)], dim=1), train)
        logits = _conv(x, self.head).permute(0, 2, 3, 1).float()
        return SegOutput(unfold_agents(logits, num_agents))

    def forward(self, occupancy, trans, agent_mask, train: bool = False) -> SegOutput:
        x, skips = self.encode(occupancy, train)
        x = self.fuse(self.bottleneck(x, train), trans, agent_mask, train)
        return self.decode(x, skips, occupancy.shape[1], train)
