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
running stats (eps 1e-5) and returns the activation dtype. Two bf16 ops
round where flax and XLA round: a conv adds its bias after the conv's
own rounding (:func:`_conv`), and the bilinear upsample resizes rows,
rounds, then resizes columns (:func:`upsample_bilinear`). Without them
the bf16 train step's loss terms stand farther from JAX's float32 than
1.25 x JAX's own bf16 error (``tests/test_torch_bf16_step.py``). A bf16
decoder stage's input, that upsample concatenated with its skip map,
runs as one autograd Function (:func:`upsample_cat`,
``ops/cuda/upsample_cu.py``) with the same two roundings, its gradient
rounded once a pass.

``train=True`` runs BatchNorm as flax does in training: batch statistics
in float32 (float64 for float64 maps) over every folded map, padded
agents included; the biased variance E[x^2] - E[x]^2 clipped at 0; and
running stats updated in place as 0.9 * old + 0.1 * batch, with that
biased variance. (PyTorch's own training BatchNorm would store the
unbiased variance.) A bf16 map is normalized in flax's form, ``(x -
mean) * (scale * rsqrt(var + eps)) + bias`` in float32, and rounded to
bf16 once. With a process group (``DetModel.set_process_group``, JAX's
``axis_name``), the batch moments E[x] and E[x^2] are averaged over the
group's ranks before the variance, with the gradient flowing through
that average, so every rank normalizes by the global batch's statistics
and stores the same running stats. A bf16 map in training takes
:func:`bn_relu`'s fused path: BatchNorm and the ReLU after it as one
autograd Function of four passes (``ops/cuda/bn_cu.py``; hand-written
CUDA on the card, their plain PyTorch version on the CPU), the same
function with its gradient in closed form, saving no float32 copy of the
map. A bf16 map in inference, where autograd records nothing, takes the
second of those passes alone: normalize + ReLU in the same form on the
running stats. Float32 and float64 maps, and inference that records a
graph, run :func:`_bn` and a ReLU.

Row sharding (a model's ``spatial_group``, JAX's ``spatial_mesh``): each
rank holds its rows of every map (``parallel/spatial.py``); the 3x3 convs
exchange halo rows, the upsample reads one row of each neighbour, and
train-mode BatchNorm averages its moments over the spatial group and the
data group in turn: all shards hold as many elements, so the mean of the
shards' means is the mean of the whole batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from v2x_sim_tpu_torch.ops.cuda import bn_cu, upsample_cu
from v2x_sim_tpu_torch.parallel import spatial
from v2x_sim_tpu_torch.parallel.mesh import group_size, psum

#: Encoder channel plan per stage (stage 0 is the stride-1 stem).
STAGE_CHANNELS: Tuple[int, ...] = (32, 64, 128, 256, 512)

BN_EPS = 1e-5
#: flax's BatchNorm momentum: running = MOMENTUM * running + (1 - MOMENTUM) * batch.
BN_MOMENTUM = 0.9


def width_mult(mult: float) -> Tuple[int, ...]:
    """Stage widths scaled by ``mult`` (DetModel's ``width_mult``)."""
    return tuple(max(8, int(round(c * mult))) for c in STAGE_CHANNELS)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied with its params cast to the activation dtype. In
    bf16 the bias is added to the rounded conv output, as flax adds it."""
    if conv.bias is None or x.dtype != torch.bfloat16:
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding)
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
    return y + conv.bias.to(x.dtype)[:, None, None]


def upsample_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW map to ``size`` (``jax.image.resize``'s
    bilinear is ``interpolate(align_corners=False)``). In bf16 rows are
    resized and rounded before columns, as XLA contracts
    ``jax.image.resize``'s two weight matrices."""
    if x.dtype == torch.bfloat16:
        x = F.interpolate(x, size=(size[0], x.shape[-1]), mode="bilinear", align_corners=False)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def conv3x3(x: torch.Tensor, conv: nn.Conv2d, group=None) -> torch.Tensor:
    """A 3x3 pad-1 ``conv`` (stride 1 or 2) of a map, as :func:`_conv`, or
    of a row shard over the spatial ``group``."""
    if group is None:
        return _conv(x, conv)
    if conv.stride[0] == 2:
        return spatial.conv3x3s2_halo(x, conv.weight, group)
    return spatial.conv3x3_halo(x, conv.weight, group, conv.bias)


def upsample_like(x: torch.Tensor, skip: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` upsampled bilinearly to ``skip``'s rows and columns
    (:func:`upsample_bilinear`); on a row shard over ``group``, where the
    size must double, ``spatial.upsample_bilinear_halo``."""
    if group is None:
        return upsample_bilinear(x, skip.shape[-2:])
    if tuple(skip.shape[-2:]) != (2 * x.shape[-2], 2 * x.shape[-1]):
        raise ValueError(f"a sharded upsample doubles the shard: {tuple(x.shape)} -> "
                         f"{tuple(skip.shape)}")
    return spatial.upsample_bilinear_halo(x, group)


def upsample_cat(x: torch.Tensor, skip: torch.Tensor, group=None) -> torch.Tensor:
    """A decoder stage's input, ``cat([upsample_like(x, skip, group), skip])``
    along channels. A bf16 ``x`` on whole maps (no ``group``) whose
    ``skip`` is exactly twice its size, both with channels a multiple of 8,
    takes the fused Function (``upsample_cu.UpsampleCat``): the kernels
    for CUDA maps, their plain version for CPU ones, the same numbers
    forward, its gradient rounded once a pass. Everything else (float32,
    float64, row shards, sizes that do not double) runs the two ops."""
    skip = skip.to(x.dtype)
    c, h, w = x.shape[1:]
    if (group is None and x.dtype == torch.bfloat16 and c % upsample_cu.VEC == 0
            and skip.shape[1] % upsample_cu.VEC == 0 and tuple(skip.shape[-2:]) == (2 * h, 2 * w)):
        return upsample_cu.UpsampleCat.apply(x, skip)
    return torch.cat([upsample_like(x, skip, group), skip], dim=1)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool = False, group=None) -> torch.Tensor:
    """BatchNorm of an NCHW map. Inference uses the float32 running stats
    (PyTorch normalizes a bf16 input in float32 and returns bf16);
    training uses the batch statistics with flax's semantics (see the
    module docstring), averaged over ``group`` (a group or a sequence of
    groups, ``mesh.group_list``) when one is given, and updates the
    running stats; a bf16 map is normalized in float32 and rounded once,
    as flax does. ``ConvBlock`` takes :func:`bn_relu`, which sends a bf16
    map to the fused passes instead, in training and in inference; this
    form is what they are held to."""
    if not train:
        return F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
            training=False, eps=bn.eps,
        )
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, msq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    if group is not None:
        mean, msq = (psum(torch.stack([mean, msq]), group) / group_size(group)).unbind()
    var = (msq - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    if x.dtype == torch.bfloat16:
        y = (xf - mean[:, None, None]) * inv[:, None, None] + bn.bias[:, None, None]
        return y.to(x.dtype)
    shift = bn.bias - mean * inv
    return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def bn_relu(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool = False, group=None) -> torch.Tensor:
    """``relu(_bn(x, bn, train, group))``. A bf16 map in training takes the
    fused Function (``bn_cu.batch_norm_relu``). A bf16 map in inference
    whose channels the kernel takes (a multiple of ``bn_cu.VEC``, at most
    ``bn_cu.MAX_CHANNELS``), where autograd records nothing, takes its
    normalize + ReLU pass alone on the running stats, with ``inv = weight *
    rsqrt(running_var + eps)`` in float32: one read and one write of the
    map. Both run the kernels for a CUDA map, their plain versions for a
    CPU one. Elsewhere the ReLU runs in place on ``_bn``'s fresh output:
    the caller still holds ``x``, so a second output would hold three maps
    at once where the block held two."""
    if x.dtype == torch.bfloat16:
        if train:
            return bn_cu.batch_norm_relu(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                         bn.eps, BN_MOMENTUM, group)
        c = x.shape[1]
        records = torch.is_grad_enabled() and (x.requires_grad or bn.weight.requires_grad
                                               or bn.bias.requires_grad)
        if c % bn_cu.VEC == 0 and c <= bn_cu.MAX_CHANNELS and not records:
            inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            return bn_cu.normalize_relu(bn_cu._layout(x), bn.running_mean, inv, bn.bias)
    return torch.relu_(_bn(x, bn, train, group))


class ConvBlock(nn.Module):
    """Two 3x3 conv + BN + ReLU layers; optional stride 2 on the first.

    The pad is an explicit 1 (torch convention), not SAME: identical at
    stride 1, one pixel shifted at stride 2.
    """

    #: The process group(s) train-mode BatchNorm averages its batch moments
    #: over (None: this process's batch alone), and the spatial group whose
    #: row shard the block convolves (None: the whole map); set through the
    #: model (:class:`BatchNormGroup`).
    process_group = None
    spatial_group = None

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NCHW in, NCHW out."""
        return self.run(x, train, self.process_group, self.spatial_group)

    def run(self, x: torch.Tensor, train: bool, bn_group, spatial_group) -> torch.Tensor:
        """The block with the groups given: BatchNorm's moments over
        ``bn_group``, the convs on a row shard over ``spatial_group``."""
        x = bn_relu(conv3x3(x, self.conv1, spatial_group), self.bn1, train, bn_group)
        return bn_relu(conv3x3(x, self.conv2, spatial_group), self.bn2, train, bn_group)


class BatchNormGroup:
    """Mixin of the models (``DetModel``, ``SegModel``) whose train-mode
    BatchNorm can sync over a process group and whose maps can be row
    shards over a spatial group."""

    #: The spatial group the model's maps are row-sharded over (None: each
    #: rank holds whole maps); given to the model's constructor.
    spatial_group = None

    def set_process_group(self, group) -> None:
        """Sync the train-mode BatchNorm of every ``ConvBlock`` inside over
        the spatial group, then ``group`` (both None: unsynced), and point
        the blocks, the decoder and the heads at the spatial group."""
        groups = tuple(g for g in (self.spatial_group, group) if g is not None)
        for m in self.modules():
            if isinstance(m, ConvBlock):
                m.process_group = groups or None
            if isinstance(m, (ConvBlock, STPNDecoder, _Head)):
                m.spatial_group = self.spatial_group


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

    Each stage upsamples bilinearly (:func:`upsample_bilinear`) and convolves
    ``cat([up, skip])`` (:func:`upsample_cat`): the JAX package's
    ``_SplitConv`` is one (3, 3, Ca+Cb, Cout) kernel whose first Ca inputs
    see the upsampled map.
    """

    def __init__(self, channels: Sequence[int] = STAGE_CHANNELS):
        super().__init__()
        chs = list(channels)
        self.blocks = nn.ModuleList(
            ConvBlock(chs[-1 - i] + chs[-2 - i], chs[-2 - i])
            for i in range(len(chs) - 1)
        )

    #: Row shards over this group (set by the model); None: whole maps.
    spatial_group = None

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False) -> torch.Tensor:
        x = feats[-1]
        for i, block in enumerate(self.blocks):
            x = block(upsample_cat(x, feats[-2 - i], self.spatial_group), train)
        return x


class _Head(nn.Module):
    """3x3 conv (bias) + ReLU + 1x1 conv (bias) -> (N, H, W, K, out_per_anchor)."""

    def __init__(self, cin: int, num_anchors: int, out_per_anchor: int, hidden: int = 32):
        super().__init__()
        self.num_anchors = num_anchors
        self.out_per_anchor = out_per_anchor
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, num_anchors * out_per_anchor, 1)

    #: Row shards over this group (set by the model); None: whole maps.
    spatial_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in; NHWC (N, H, W, K, out) out, in the activation dtype."""
        y = _conv(torch.relu(conv3x3(x, self.conv1, self.spatial_group)), self.conv2)
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
