"""MotionNet-style STPN backbone and detection heads.

Port of ``v2x_sim_tpu/models/backbone.py`` in its plain layout (the JAX
package's space-to-depth execution re-arranges the same math for the TPU
and shares this param tree). Public tensors are NHWC as in the JAX
package; inside, convs take ``permute``d NCHW views, so activations stay
channels-last in memory.

Module names follow the reference torch graph, so one flax
``{params, batch_stats}`` tree loads through ``bridge.py``:
``encoder.blocks.{i}.{conv1,bn1,conv2,bn2}``, ``decoder.blocks.{i}...``,
``{cls,reg}_head.{conv1,conv2}``.

Mixed precision follows the JAX package: parameters stay float32 and are
cast to the activation dtype per op; BatchNorm runs on its float32
running stats (eps 1e-5) and returns the activation dtype.

``train=True`` runs BatchNorm as flax does in training: batch statistics
in float32 (float64 for float64 maps) over every folded map, padded
agents included; the biased variance E[x^2] - E[x]^2 clipped at 0; and
running stats updated in place as 0.9 * old + 0.1 * batch, with that
biased variance. (PyTorch's own training BatchNorm would store the
unbiased variance.) With a process group (``DetModel.set_process_group``,
JAX's ``axis_name``), the batch moments E[x] and E[x^2] are averaged over
the group's ranks before the variance, with the gradient flowing through
that average, so every rank normalizes by the global batch's statistics
and stores the same running stats.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from v2x_sim_tpu_torch.parallel.mesh import psum

#: Encoder channel plan per stage (stage 0 is the stride-1 stem).
STAGE_CHANNELS: Tuple[int, ...] = (32, 64, 128, 256, 512)

BN_EPS = 1e-5
#: flax's BatchNorm momentum: running = MOMENTUM * running + (1 - MOMENTUM) * batch.
BN_MOMENTUM = 0.9


def width_mult(mult: float) -> Tuple[int, ...]:
    """Stage widths scaled by ``mult`` (DetModel's ``width_mult``)."""
    return tuple(max(8, int(round(c * mult))) for c in STAGE_CHANNELS)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied with its params cast to the activation dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool = False, group=None) -> torch.Tensor:
    """BatchNorm of an NCHW map. Inference uses the float32 running stats
    (PyTorch normalizes a bf16 input in float32 and returns bf16);
    training uses the batch statistics with flax's semantics (see the
    module docstring), averaged over ``group`` when one is given, and
    updates the running stats."""
    if not train:
        return F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=False, eps=bn.eps,
        )
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, msq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    if group is not None:
        mean, msq = (psum(torch.stack([mean, msq]), group) / dist.get_world_size(group)).unbind()
    var = (msq - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    shift = bn.bias - mean * inv
    return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class ConvBlock(nn.Module):
    """Two 3x3 conv + BN + ReLU layers; optional stride 2 on the first.

    The pad is an explicit 1 (torch convention), not SAME: identical at
    stride 1, one pixel shifted at stride 2.
    """

    #: The process group train-mode BatchNorm averages its batch moments
    #: over (None: this process's batch alone); set through the model's
    #: ``set_process_group`` (:class:`BatchNormGroup`).
    process_group = None

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NCHW in, NCHW out."""
        x = torch.relu(_bn(_conv(x, self.conv1), self.bn1, train, self.process_group))
        return torch.relu(_bn(_conv(x, self.conv2), self.bn2, train, self.process_group))


class BatchNormGroup:
    """Mixin of the models (``DetModel``, ``SegModel``) whose train-mode
    BatchNorm can sync over a process group."""

    def set_process_group(self, group) -> None:
        """Sync the train-mode BatchNorm of every ``ConvBlock`` inside over
        ``group`` (None: unsynced)."""
        for m in self.modules():
            if isinstance(m, ConvBlock):
                m.process_group = group


class STPNEncoder(nn.Module):
    """Pyramid encoder: all 5 stage outputs, highest resolution first."""

    def __init__(self, in_channels: int, channels: Sequence[int] = STAGE_CHANNELS):
        super().__init__()
        blocks, cin = [], in_channels
        for i, ch in enumerate(channels):
            blocks.append(ConvBlock(cin, ch, stride=1 if i == 0 else 2))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, train: bool = False, depth: Optional[int] = None) -> List[torch.Tensor]:
        """NCHW input in the activation dtype -> list of NCHW maps, of the
        first ``depth`` stages (all by default)."""
        feats = []
        for block in self.blocks[:depth]:
            x = block(x, train)
            feats.append(x)
        return feats


class STPNDecoder(nn.Module):
    """Decoder with skip connections back to stage-0 resolution.

    Each stage upsamples bilinearly (``jax.image.resize`` bilinear is
    ``interpolate(align_corners=False)``) and convolves
    ``cat([up, skip])``: the JAX package's ``_SplitConv`` is one
    (3, 3, Ca+Cb, Cout) kernel whose first Ca inputs see the upsampled map.
    """

    def __init__(self, channels: Sequence[int] = STAGE_CHANNELS):
        super().__init__()
        chs = list(channels)
        self.blocks = nn.ModuleList(
            ConvBlock(chs[-1 - i] + chs[-2 - i], chs[-2 - i])
            for i in range(len(chs) - 1)
        )

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False) -> torch.Tensor:
        x = feats[-1]
        for i, block in enumerate(self.blocks):
            skip = feats[-2 - i]
            x = F.interpolate(
                x, size=skip.shape[-2:], mode="bilinear", align_corners=False
            )
            x = block(torch.cat([x, skip.to(x.dtype)], dim=1), train)
        return x


class _Head(nn.Module):
    """3x3 conv (bias) + ReLU + 1x1 conv (bias) -> (N, H, W, K, out_per_anchor)."""

    def __init__(self, cin: int, num_anchors: int, out_per_anchor: int, hidden: int = 32):
        super().__init__()
        self.num_anchors = num_anchors
        self.out_per_anchor = out_per_anchor
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, num_anchors * out_per_anchor, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in; NHWC (N, H, W, K, out) out, in the activation dtype."""
        y = _conv(torch.relu(_conv(x, self.conv1)), self.conv2)
        n, _, h, w = y.shape
        return y.permute(0, 2, 3, 1).reshape(n, h, w, self.num_anchors, self.out_per_anchor)


class ClassificationHead(_Head):
    """Per-cell per-anchor class logits."""


class RegressionHead(_Head):
    """Per-anchor 6-dim box deltas."""


def fold_agents(x: torch.Tensor) -> torch.Tensor:
    """(B, A, ...) -> (B*A, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unfold_agents(x: torch.Tensor, num_agents: int) -> torch.Tensor:
    """(B*A, ...) -> (B, A, ...)."""
    return x.reshape((x.shape[0] // num_agents, num_agents) + tuple(x.shape[1:]))
