"""Collaborative detection model.

Port of ``v2x_sim_tpu/models/det/net.py::DetModel`` for the ``lowerbound``
and ``disco`` modes, in the plain layout. Input contract:

  occupancy  (B, A, H, W, D)   per-agent BEV voxel occupancy, D z-slices
                               as channels;
  trans      (B, A, A, 4, 4)   pairwise agent transforms, trans[b, i, j] = T_{i<-j};
  agent_mask (B, A)            real-agent mask.

Output: ``DetOutput(cls_logits (B, A, H, W, K, C), reg (B, A, H, W, K, 6))``
in the activation dtype (the dtype of ``occupancy``).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn as nn

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.models.backbone import (
    ClassificationHead,
    RegressionHead,
    STPNDecoder,
    STPNEncoder,
    fold_agents,
    unfold_agents,
    width_mult as scaled_widths,
)
from v2x_sim_tpu_torch.models.det.fusion import DiscoFusion

#: Modes this port implements.
MODES = ("lowerbound", "disco")

#: The JAX package's other modes, and the ROADMAP.md queue item that ports each.
DEFERRED_MODES = {
    "upperbound": "queue 1 item 4 (upperbound/teacher and merged_occupancy)",
    **dict.fromkeys(
        ("sum", "mean", "max", "cat", "agent", "when2com", "who2com", "v2v"),
        "queue 1 item 8 (the rest of the det fusion set)",
    ),
}


def check_mode(mode: str) -> None:
    """Raise for a mode the port does not implement (yet)."""
    if mode in DEFERRED_MODES:
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet: ROADMAP.md {DEFERRED_MODES[mode]}"
        )
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")


class DetOutput(NamedTuple):
    """cls_logits (B, A, H, W, K, C); reg (B, A, H, W, K, 6)."""

    cls_logits: torch.Tensor
    reg: torch.Tensor


class DetModel(nn.Module):
    """Backbone + (optional) fusion + heads."""

    def __init__(self, config: Config, mode: str = "lowerbound", width_mult: float = 1.0):
        super().__init__()
        check_mode(mode)
        self.config = config
        self.mode = mode
        chans = scaled_widths(width_mult)
        self.encoder = STPNEncoder(config.grid.grid_shape[2], chans)
        self.decoder = STPNDecoder(chans)
        k = config.anchors.num_anchors
        self.cls_head = ClassificationHead(chans[0], k, config.num_classes)
        self.reg_head = RegressionHead(chans[0], k, config.anchors.box_code_size)
        if mode == "disco":
            self.fusion = DiscoFusion(config.grid, chans[config.fusion_layer])

    # The forward pass in stages, so a profiler can time each one.

    # ``train`` selects BatchNorm's training semantics (models/backbone.py).

    def encode(self, occupancy: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        """(B, A, H, W, D) -> pyramid of (B*A, C, h, w) maps (channels-last memory)."""
        return self.encoder(fold_agents(occupancy).permute(0, 3, 1, 2), train)

    def fuse(self, feats: List[torch.Tensor], trans, agent_mask, train: bool = False) -> List[torch.Tensor]:
        """Fuse the fusion-layer map across agents (no-op for lowerbound)."""
        if self.mode == "lowerbound":
            return feats
        k = self.config.fusion_layer
        a = agent_mask.shape[1]
        f = unfold_agents(feats[k].permute(0, 2, 3, 1), a)  # (B, A, h, w, C)
        fused = self.fusion(f, trans, agent_mask, train)
        feats = list(feats)
        feats[k] = fold_agents(fused).permute(0, 3, 1, 2)
        return feats

    def decode_heads(self, feats: List[torch.Tensor], num_agents: int, train: bool = False) -> DetOutput:
        decoded = self.decoder(feats, train)
        cls = unfold_agents(self.cls_head(decoded), num_agents)
        reg = unfold_agents(self.reg_head(decoded), num_agents)
        return DetOutput(cls, reg)

    def forward(self, occupancy, trans, agent_mask, train: bool = False) -> DetOutput:
        feats = self.fuse(self.encode(occupancy, train), trans, agent_mask, train)
        return self.decode_heads(feats, occupancy.shape[1], train)
