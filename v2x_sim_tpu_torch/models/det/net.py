"""Collaborative detection model, every collaboration mode.

Port of ``v2x_sim_tpu/models/det/net.py`` (``DetModel`` and
``TeacherModel``) in the plain layout. Input contract:

  occupancy  (B, A, H, W, D)   per-agent BEV voxel occupancy, D z-slices
                               as channels (2·D with ``use_vis``: the
                               visibility map's slices follow);
  trans      (B, A, A, 4, 4)   pairwise agent transforms, trans[b, i, j] = T_{i<-j};
  agent_mask (B, A)            real-agent mask.

Output: ``DetOutput(cls_logits (B, A, H, W, K, C), reg (B, A, H, W, K, 6),
fused_feat)`` in the activation dtype (the dtype of ``occupancy``);
``fused_feat`` is the (B, A, h, w, C) map at the fusion layer after
fusion when ``kd`` is set (the KD student feature), else None.

With a ``spatial_group`` (JAX's ``spatial_mesh``), H above is this rank's
rows of the BEV plane (``parallel/spatial.py``: rank r of n holds rows
[r·H/n, (r+1)·H/n)), in the input and in every output: the encoder, the
decoder and the heads run on the shard, and the fusion gathers the
fusion layer's rows, fuses the whole map on every rank of the group and
takes its rows back, as JAX's partitioner all-gathers the map the warp
needs. The encoder's stride-2 stages need H % (n · 2^4) == 0.
"""

from __future__ import annotations

from typing import Any, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from v2x_sim_tpu_torch.configs.config import Config
from v2x_sim_tpu_torch.models.backbone import (
    BatchNormGroup,
    ClassificationHead,
    RegressionHead,
    STPNDecoder,
    STPNEncoder,
    fold_agents,
    unfold_agents,
    width_mult as scaled_widths,
)
from v2x_sim_tpu_torch.models.det import fusion as F
from v2x_sim_tpu_torch.models.det.cobevt import CoBEVTFusion
from v2x_sim_tpu_torch.models.det.v2vnet import V2VNetFusion
from v2x_sim_tpu_torch.models.det.v2xvit import V2XViTFusion
from v2x_sim_tpu_torch.models.det.when2com import When2comFusion
from v2x_sim_tpu_torch.parallel.spatial import gather_rows, take_rows
from v2x_sim_tpu_torch.utils.spans import span, spanned

#: The collaboration modes, as the JAX package's.
MODES = (
    "lowerbound",
    "upperbound",
    "sum",
    "mean",
    "max",
    "cat",
    "agent",
    "when2com",
    "who2com",
    "v2v",
    "disco",
)

#: The port's detection modes: the JAX package's, then V2X-ViT's
#: transformer fusion (``models/det/v2xvit.py``) and CoBEVT's fused axial
#: attention (``models/det/cobevt.py``), which the JAX package does not
#: have.
PORT_MODES = MODES + ("v2xvit", "cobevt")

#: Modes that run no fusion (upperbound's input is already merged).
NO_FUSION = ("lowerbound", "upperbound")

_FUSE_FNS = {"sum": F.fuse_sum, "mean": F.fuse_mean, "max": F.fuse_max}

#: Each fusion module's settings under a configuration's names, with their
#: defaults; ``build_fusion`` takes them in ``fusion`` (a configuration's
#: ``fusion`` block) and hands them on under the constructor's names.
FUSION_KEYWORDS = {
    "disco": {"edge_hidden": 32},
    "cat": {},
    "agent": {"hidden": 32},
    "when2com": {"warp_flag": True},
    "who2com": {"warp_flag": True},
    "v2v": {"rounds": 3, "msg_norm": False},
    "v2xvit": {"depth": 3, "heads": 8, "dim_head": 32, "num_types": 2,
               "window_heads": (16, 8, 4), "window_dim_heads": (16, 32, 64),
               "window_sizes": (4, 8, 16), "relative_pos_embedding": True,
               "window_fusion": "split_attn", "mlp_dim": 256, "dropout": 0.3, "use_rte": True,
               "rte_ratio": 2, "use_roi_mask": True},
    "cobevt": {"depth": 3, "dim_head": 32, "mlp_dim": 256, "window_size": 8, "dropout": 0.1},
}


def check_mode(mode: str, modes: Tuple[str, ...] = PORT_MODES) -> None:
    """Raise ValueError for a mode that is not one of ``modes`` (the
    detection model's by default; the segmentation model passes MODES)."""
    if mode not in modes:
        if mode in PORT_MODES:
            raise ValueError(f"mode {mode!r} is detection-only; expected one of {modes}")
        raise ValueError(f"unknown mode {mode!r}; expected one of {modes}")


def build_fusion(mode: str, grid, channels: int, num_agents: int,
                 fusion: Optional[Mapping[str, Any]] = None) -> Optional[nn.Module]:
    """The trained fusion module of ``mode`` over ``channels``-wide maps, or
    None for the modes without one (lowerbound, upperbound, sum, mean, max).

    ``fusion``: the module's settings under a configuration's names
    (``FUSION_KEYWORDS``); a key the mode does not take raises ValueError."""
    fusion = dict(fusion or {})
    known = FUSION_KEYWORDS.get(mode, {})
    unknown = sorted(set(fusion) - set(known))
    if unknown:
        raise ValueError(f"mode {mode!r} takes no fusion setting {unknown}; "
                         f"it takes {sorted(known)}")
    kw = {**known, **fusion}
    if mode == "disco":
        return F.DiscoFusion(grid, channels, hidden=kw["edge_hidden"])
    if mode == "cat":
        return F.CatFusion(grid, channels, num_agents)
    if mode == "agent":
        return F.AgentWiseWeightedFusion(grid, channels, hidden=kw["hidden"])
    if mode in ("when2com", "who2com"):
        return When2comFusion(grid, channels, argmax_mode=mode == "who2com",
                              warp_flag=kw["warp_flag"])
    if mode == "v2v":
        return V2VNetFusion(grid, channels, **kw)
    if mode == "v2xvit":
        return V2XViTFusion(grid, channels, **kw)
    if mode == "cobevt":
        return CoBEVTFusion(grid, channels, num_agents, **kw)
    return None


def fuse_agents(mode: str, fusion: Optional[nn.Module], feats, trans, agent_mask, grid,
                train: bool = False):
    """(B, A, h, w, C) maps fused across agents by ``mode``: its parameter-free
    fusion, or its ``fusion`` module (``build_fusion``)."""
    if mode in _FUSE_FNS:
        return _FUSE_FNS[mode](feats, trans, agent_mask, grid)
    return fusion(feats, trans, agent_mask, train)


class DetOutput(NamedTuple):
    """cls_logits (B, A, H, W, K, C); reg (B, A, H, W, K, 6); fused_feat
    (B, A, h, w, C) or None."""

    cls_logits: torch.Tensor
    reg: torch.Tensor
    fused_feat: Optional[torch.Tensor] = None


class DetModel(BatchNormGroup, nn.Module):
    """Backbone + (optional) fusion + heads for any collaboration mode.

    Args:
      fusion_layer: encoder stage whose map is fused (None: the config's).
      fusion: the fusion module's settings under a configuration's names
        (``FUSION_KEYWORDS``): V2VNet's ``rounds`` and ``msg_norm``,
        When2com's ``warp_flag``, ...; the defaults where not given.
      kd: return the fusion-layer map as ``fused_feat``.
      use_vis: the input carries D visibility channels after the D
        occupancy ones (DetModule's ``use_vis``): the encoder's first conv
        takes 2·D channels.
      spatial_group: the process group the BEV rows are sharded over (see
        the module docstring); None: whole maps.

    ``set_process_group(group)`` (JAX's ``axis_name``): the group
    train-mode BatchNorm averages its batch moments over, set by the task
    module for data parallelism, after the spatial group; inference never
    syncs.
    """

    def __init__(self, config: Config, mode: str = "lowerbound", width_mult: float = 1.0,
                 fusion_layer: Optional[int] = None, kd: bool = False,
                 use_vis: bool = False, spatial_group=None,
                 fusion: Optional[Mapping[str, Any]] = None):
        super().__init__()
        check_mode(mode)
        self.config = config
        self.mode = mode
        self.kd = kd
        self.layer = config.fusion_layer if fusion_layer is None else fusion_layer
        chans = scaled_widths(width_mult)
        depth = config.grid.grid_shape[2]
        self.encoder = STPNEncoder(2 * depth if use_vis else depth, chans)
        self.decoder = STPNDecoder(chans)
        k = config.anchors.num_anchors
        self.cls_head = ClassificationHead(chans[0], k, config.num_classes)
        self.reg_head = RegressionHead(chans[0], k, config.anchors.box_code_size)
        self.fusion = build_fusion(mode, config.grid, chans[self.layer], config.num_agents,
                                   fusion=fusion)
        self.spatial_group = spatial_group
        self.set_process_group(None)

    # The forward pass in stages, so a profiler can time each one: each
    # opens its span (utils/spans.py) while a profiler records.

    # ``train`` selects BatchNorm's training semantics (models/backbone.py)
    # and When2com's training attention.

    @spanned("det.encode")
    def encode(self, occupancy: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        """(B, A, H, W, D) -> pyramid of (B*A, C, h, w) maps (channels-last memory)."""
        return self.encoder(fold_agents(occupancy).permute(0, 3, 1, 2), train)

    def fuse(self, feats: List[torch.Tensor], trans, agent_mask, train: bool = False) -> List[torch.Tensor]:
        """Fuse the fusion-layer map across agents (no-op for lowerbound
        and upperbound); on row shards, over the whole map gathered from
        the spatial group, keeping this rank's rows of the result."""
        if self.mode in NO_FUSION:
            return feats
        with span("det.fuse"):
            k, g = self.layer, self.spatial_group
            a = agent_mask.shape[1]
            f = feats[k] if g is None else gather_rows(feats[k], g)
            f = unfold_agents(f.permute(0, 2, 3, 1), a)  # (B, A, h, w, C)
            fused = fuse_agents(self.mode, self.fusion, f, trans, agent_mask, self.config.grid,
                                train)
            fused = fold_agents(fused).permute(0, 3, 1, 2)
            feats = list(feats)
            feats[k] = fused if g is None else take_rows(fused, g)
            return feats

    @spanned("det.heads")
    def decode_heads(self, feats: List[torch.Tensor], num_agents: int, train: bool = False) -> DetOutput:
        decoded = self.decoder(feats, train)
        cls = unfold_agents(self.cls_head(decoded), num_agents)
        reg = unfold_agents(self.reg_head(decoded), num_agents)
        fused = unfold_agents(feats[self.layer].permute(0, 2, 3, 1), num_agents) if self.kd else None
        return DetOutput(cls, reg, fused)

    @spanned("det.model")
    def forward(self, occupancy, trans, agent_mask, train: bool = False) -> DetOutput:
        feats = self.fuse(self.encode(occupancy, train), trans, agent_mask, train)
        return self.decode_heads(feats, occupancy.shape[1], train)


class TeacherModel(DetModel):
    """Early-fusion teacher for DiscoNet's KD: the upperbound model (backbone
    and heads on merged-cloud occupancy, no fusion, no visibility input,
    also under a ``use_vis`` student), exposing the
    fusion-layer map as the KD target. An upperbound model's weights load
    as the teacher (``bridge.key_map("upperbound")``)."""

    def __init__(self, config: Config, width_mult: float = 1.0, fusion_layer: Optional[int] = None,
                 spatial_group=None):
        super().__init__(config, "upperbound", width_mult, fusion_layer, kd=True,
                         spatial_group=spatial_group)

    def kd_target(self, occupancy: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, A, H, W, D) merged occupancy -> the (B, A, h, w, C) map at the
        fusion layer; runs the encoder only as deep as that layer."""
        x = fold_agents(occupancy).permute(0, 3, 1, 2)
        f = self.encoder(x, train, depth=self.layer + 1)[self.layer]
        return unfold_agents(f.permute(0, 2, 3, 1), occupancy.shape[1])

    def forward(self, occupancy: torch.Tensor, train: bool = False) -> DetOutput:
        """Logits, regression and the fusion-layer map (``fused_feat``)."""
        return self.decode_heads(self.encode(occupancy, train), occupancy.shape[1], train)
