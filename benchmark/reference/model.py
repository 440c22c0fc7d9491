"""The plain reference detection graph: STPN encoder, decoder and heads.

Frozen copy of ``v2x_sim_tpu_torch/baselines/torch_ref.py::build_model``
(commit 73ef7cd), in plain float32 PyTorch: NCHW maps, ``nn.BatchNorm2d``
(eval mode reads the running statistics; train mode normalizes by the
batch's biased variance), ``F.interpolate`` for the decoder's upsample and
``F.grid_sample`` for the warp. Module names are the port's state-dict
names, so one state dict loads into both. Departures from the copy:

  * the fusion is a module of the configuration's own
    (``configs/<name>/reference.py``), built by the caller;
  * every convolution goes through :meth:`Precision.conv`, which rounds
    its input, weight and output with the model's ``rounding`` (none for
    the reference; ``fp8_round`` for the control, the precision below the
    configurations' bf16: every map a convolution reads or writes, the
    heads' logits and box codes among them, is held in float8).

Imports nothing of the port.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def no_rounding(x: torch.Tensor) -> torch.Tensor:
    return x


class _Fp8(torch.autograd.Function):
    """Round to float8 under a per-tensor scale: e4m3 forward, e5m2 for
    the gradient, as fp8 training recipes do."""

    @staticmethod
    def forward(ctx, x):
        return _scaled(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, FP8_E5M2_MAX)


def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).clamp(-top, top).to(dtype).to(x.dtype) / scale


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 (e4m3, its largest magnitude scaled to 448)
    and its gradient to float8 e5m2 likewise; float32 in and out."""
    return _Fp8.apply(x)


class Precision:
    """What a reference model rounds each convolution's operands to."""

    def __init__(self, rounding: Callable[[torch.Tensor], torch.Tensor] = no_rounding):
        self.rounding = rounding

    def conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        r = self.rounding
        return r(F.conv2d(r(x), r(conv.weight), conv.bias, conv.stride, conv.padding))

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return self.rounding(w)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self.rounding(x)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor, p: Precision) -> torch.Tensor:
        x = torch.relu(self.bn1(p.conv(x, self.conv1)))
        return torch.relu(self.bn2(p.conv(x, self.conv2)))


class Encoder(nn.Module):
    def __init__(self, depth: int, chans: Sequence[int]):
        super().__init__()
        blocks, cin = [], depth
        for i, ch in enumerate(chans):
            blocks.append(ConvBlock(cin, ch, stride=1 if i == 0 else 2))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, p: Precision) -> List[torch.Tensor]:
        feats = []
        for b in self.blocks:
            x = b(x, p)
            feats.append(x)
        return feats


class Decoder(nn.Module):
    def __init__(self, chans: Sequence[int]):
        super().__init__()
        chs = list(chans)
        self.blocks = nn.ModuleList(
            ConvBlock(chs[-1 - i] + chs[-2 - i], chs[-2 - i]) for i in range(len(chs) - 1))

    def forward(self, feats: List[torch.Tensor], p: Precision) -> torch.Tensor:
        x = feats[-1]
        for i, block in enumerate(self.blocks):
            skip = feats[-2 - i]
            x = F.interpolate(x, size=skip.shape[-2:], mode="bilinear", align_corners=False)
            x = block(torch.cat([x, skip], dim=1), p)
        return x


class Head(nn.Module):
    def __init__(self, cin: int, out: int, hidden: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, out, 1)

    def forward(self, x: torch.Tensor, p: Precision) -> torch.Tensor:
        return p.conv(torch.relu(p.conv(x, self.conv1)), self.conv2)


def warp_all_pairs(feats: torch.Tensor, trans: torch.Tensor, extents) -> torch.Tensor:
    """feats (B, A, C, h, w); trans[b, i, j] = T_{i<-j}. Returns
    (B, A, A, C, h, w): out[b, i, j] = agent j's map in agent i's frame,
    agent j's map sampled at p_j = trans[b, j, i] @ p_i over metric cell
    centres (bilinear, zeros outside, align_corners=False)."""
    b, a, c, h, w = feats.shape
    (x0, x1), (y0, y1) = extents[0], extents[1]
    sx, sy = (x1 - x0) / h, (y1 - y0) / w
    xs = x0 + (torch.arange(h, dtype=torch.float32, device=feats.device) + 0.5) * sx
    ys = y0 + (torch.arange(w, dtype=torch.float32, device=feats.device) + 0.5) * sy
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    t = trans.to(torch.float32).transpose(1, 2).reshape(b * a * a, 4, 4)  # T_{j<-i}
    r, tt = t[:, :2, :2], t[:, :2, 3]
    xj = r[:, 0, 0, None, None] * gx + r[:, 0, 1, None, None] * gy + tt[:, 0, None, None]
    yj = r[:, 1, 0, None, None] * gx + r[:, 1, 1, None, None] * gy + tt[:, 1, None, None]
    px = (xj - x0) / sx - 0.5  # fractional row in j's map
    py = (yj - y0) / sy - 0.5  # fractional column
    # grid_sample's last grid axis is (x over the width, y over the height).
    grid = torch.stack([(2.0 * py + 1.0) / w - 1.0, (2.0 * px + 1.0) / h - 1.0], dim=-1)
    src = feats[:, None].expand(b, a, a, c, h, w).reshape(b * a * a, c, h, w)
    out = F.grid_sample(src, grid.to(feats.dtype), mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(b, a, a, c, h, w)


class Reference(nn.Module):
    """Encoder -> the configuration's fusion at ``fusion_layer`` ->
    decoder -> heads. ``forward(occupancy (B, A, D, H, W), trans (B, A, A,
    4, 4), mask (B, A) bool)`` returns cls (B, A, H, W, K, C) and reg
    (B, A, H, W, K, code), the port's output layout."""

    def __init__(self, config: dict, fusion: Optional[nn.Module]):
        super().__init__()
        chans = config["stage_channels"]
        self.depth = config["grid"]["shape"][2]
        self.num_anchors = len(config["anchors"]["sizes"])
        self.num_classes = config["num_classes"]
        self.box_code = config["anchors"]["box_code_size"]
        self.fusion_layer = config["fusion_layer"]
        self.encoder = Encoder(self.depth, chans)
        self.decoder = Decoder(chans)
        self.cls_head = Head(chans[0], self.num_anchors * self.num_classes)
        self.reg_head = Head(chans[0], self.num_anchors * self.box_code)
        self.fusion = fusion
        self.precision = Precision()

    def forward(self, occupancy: torch.Tensor, trans: torch.Tensor, mask: torch.Tensor):
        p = self.precision
        b, a = occupancy.shape[:2]
        feats = self.encoder(occupancy.reshape((b * a,) + occupancy.shape[2:]), p)
        if self.fusion is not None:
            k = self.fusion_layer
            f = feats[k].reshape((b, a) + feats[k].shape[1:])
            fused = self.fusion(f, trans, mask, p)
            feats[k] = fused.reshape((b * a,) + fused.shape[2:])
        x = self.decoder(feats, p)
        h, w = x.shape[-2:]
        k, c, code = self.num_anchors, self.num_classes, self.box_code
        cls = self.cls_head(x, p).reshape(b, a, k, c, h, w).permute(0, 1, 4, 5, 2, 3)
        reg = self.reg_head(x, p).reshape(b, a, k, code, h, w).permute(0, 1, 4, 5, 2, 3)
        return cls, reg
