"""The reference detection graph, FaFNet/DiscoNet, as the reference's own
PyTorch stack runs it.

The port's copy of ``v2x_sim_tpu/baselines/torch_ref.py`` (the port
imports nothing of the JAX package): a reconstruction of the reference's
MotionNet-style STPN backbone 32->64->128->256->512, cls/reg heads and
pixel-weighted DiscoNet fusion, in the reference's own idiom: NCHW
``nn.BatchNorm2d``, ``F.grid_sample`` for the warp. ``build_model`` keeps
the original's graph and numerics; its tensors follow the input's device,
so the graph also runs on the card. Module names are the port's
(``bridge.key_map``), so one state dict loads into both.

``measure`` times this graph on the port's card, at the bench's batch, as
the baseline the bench divides by (``bench.py``'s ``vs_baseline``).

Conventions:
  * all backbone convs 3x3 pad-1 bias-free + BatchNorm + ReLU;
  * decoder: bilinear 2x upsample (align_corners=False) + concat skip;
  * heads: 3x3 conv (bias) + ReLU + 1x1 conv (bias);
  * warp: grid_sample(bilinear, zeros, align_corners=False) sampling
    agent j's map at p_j = T_{j<-i} @ p_i over metric cell centers.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import torch

from v2x_sim_tpu_torch import resolve_device
from v2x_sim_tpu_torch.configs.config import Config

STAGE_CHANNELS = (32, 64, 128, 256, 512)


def build_model(grid_shape: Tuple[int, int, int], area_extents, num_anchors=6,
                num_classes=2, box_code=6, fusion_layer=3):
    """Build the torch DiscoNet reference model class."""
    import torch.nn as nn
    import torch.nn.functional as TF

    d = grid_shape[2]

    class ConvBlock(nn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)

        def forward(self, x):
            x = torch.relu(self.bn1(self.conv1(x)))
            return torch.relu(self.bn2(self.conv2(x)))

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            blocks, cin = [], d
            for i, ch in enumerate(STAGE_CHANNELS):
                blocks.append(ConvBlock(cin, ch, stride=1 if i == 0 else 2))
                cin = ch
            self.blocks = nn.ModuleList(blocks)

        def forward(self, x):
            feats = []
            for b in self.blocks:
                x = b(x)
                feats.append(x)
            return feats

    class Decoder(nn.Module):
        def __init__(self):
            super().__init__()
            chs = list(STAGE_CHANNELS)
            self.blocks = nn.ModuleList(
                ConvBlock(chs[-1 - i] + chs[-2 - i], chs[-2 - i])
                for i in range(len(chs) - 1)
            )

        def forward(self, feats):
            x = feats[-1]
            for i, block in enumerate(self.blocks):
                skip = feats[-2 - i]
                x = TF.interpolate(
                    x, size=skip.shape[-2:], mode="bilinear",
                    align_corners=False,
                )
                x = block(torch.cat([x, skip], dim=1))
            return x

    class Head(nn.Module):
        def __init__(self, out):
            super().__init__()
            self.conv1 = nn.Conv2d(32, 32, 3, padding=1)
            self.conv2 = nn.Conv2d(32, out, 1)

        def forward(self, x):
            return self.conv2(torch.relu(self.conv1(x)))

    class DiscoFusion(nn.Module):
        """Pixel-weighted fusion over ego-frame-warped neighbor maps."""

        def __init__(self, channels):
            super().__init__()
            self.edge_hidden = nn.Conv2d(2 * channels, 32, 1)
            self.edge_score = nn.Conv2d(32, 1, 1)

        def _warp_all_pairs(self, feats, trans):
            """feats (B, A, C, h, w); trans[b, i, j] = T_{i<-j}.

            Returns (B, A, A, C, h, w): out[b, i, j] = agent j's map in
            agent i's frame — sample j at p_j = trans[b, j, i] @ p_i.
            """
            b, a, c, h, w = feats.shape
            (x0, x1), (y0, y1) = area_extents[0], area_extents[1]
            sx = (x1 - x0) / h
            sy = (y1 - y0) / w
            xs = x0 + (torch.arange(h, dtype=feats.dtype, device=feats.device) + 0.5) * sx
            ys = y0 + (torch.arange(w, dtype=feats.dtype, device=feats.device) + 0.5) * sy
            gx, gy = torch.meshgrid(xs, ys, indexing="ij")  # (h, w)
            t = trans.transpose(1, 2).reshape(b * a * a, 4, 4)  # T_{j<-i}
            r, tt = t[:, :2, :2], t[:, :2, 3]
            xj = r[:, 0, 0, None, None] * gx + r[:, 0, 1, None, None] * gy \
                + tt[:, 0, None, None]
            yj = r[:, 1, 0, None, None] * gx + r[:, 1, 1, None, None] * gy \
                + tt[:, 1, None, None]
            px = (xj - x0) / sx - 0.5  # fractional row in j's map
            py = (yj - y0) / sy - 0.5  # fractional col
            # grid_sample normalized coords (align_corners=False):
            # last dim = (x over WIDTH, y over HEIGHT).
            gxn = (2.0 * py + 1.0) / w - 1.0
            gyn = (2.0 * px + 1.0) / h - 1.0
            grid = torch.stack([gxn, gyn], dim=-1)  # (BAA, h, w, 2)
            src = (
                feats[:, None, :, :, :, :]
                .expand(b, a, a, c, h, w)
                .reshape(b * a * a, c, h, w)
            )
            out = TF.grid_sample(
                src, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False,
            )
            return out.reshape(b, a, a, c, h, w)

        def forward(self, feats, trans, mask):
            b, a, c, h, w = feats.shape
            warped = self._warp_all_pairs(feats, trans)
            warped = warped * mask[:, None, :, None, None, None].to(feats.dtype)
            ego = feats[:, :, None].expand(b, a, a, c, h, w)
            pair = torch.cat([ego, warped], dim=3).reshape(b * a * a, 2 * c, h, w)
            s = self.edge_score(torch.relu(self.edge_hidden(pair)))
            s = s.reshape(b, a, a, 1, h, w)
            s = torch.where(
                mask[:, None, :, None, None, None], s,
                torch.tensor(-1e9, dtype=s.dtype, device=s.device),
            )
            attn = torch.softmax(s, dim=2)
            return (attn * warped).sum(dim=2)

    class DiscoNet(nn.Module):
        """Reference DiscoNet graph: encoder -> fuse at `fusion_layer`
        -> decoder -> heads. mode='lowerbound' skips fusion (FaFNet)."""

        def __init__(self, mode="disco"):
            super().__init__()
            self.mode = mode
            self.encoder = Encoder()
            self.decoder = Decoder()
            self.cls_head = Head(num_anchors * num_classes)
            self.reg_head = Head(num_anchors * box_code)
            if mode == "disco":
                self.fusion = DiscoFusion(STAGE_CHANNELS[fusion_layer])

        def forward(self, occupancy, trans, mask):
            """occupancy (B, A, D, H, W); trans (B, A, A, 4, 4);
            mask (B, A) bool. Returns cls (B, A, H, W, K, C) and reg
            (B, A, H, W, K, 6) — the port's DetOutput layout."""
            b, a = occupancy.shape[:2]
            x = occupancy.reshape((b * a,) + occupancy.shape[2:])
            feats = self.encoder(x)
            if self.mode == "disco":
                k = fusion_layer
                f = feats[k].reshape((b, a) + feats[k].shape[1:])
                fused = self.fusion(f, trans, mask)
                feats[k] = fused.reshape((b * a,) + fused.shape[2:])
            decoded = self.decoder(feats)
            h, w = decoded.shape[-2:]
            cls = self.cls_head(decoded).reshape(
                b, a, num_anchors, num_classes, h, w
            ).permute(0, 1, 4, 5, 2, 3)
            reg = self.reg_head(decoded).reshape(
                b, a, num_anchors, box_code, h, w
            ).permute(0, 1, 4, 5, 2, 3)
            return cls, reg

    return DiscoNet


def measure(occupancy: torch.Tensor, trans: torch.Tensor, agent_mask: torch.Tensor,
            device: Optional[Union[str, torch.device]] = None, steps: int = 20,
            warmup: int = 2, config: Optional[Config] = None) -> float:
    """Scenes per second of the reference DiscoNet graph at ``config``'s
    geometry (``Config()`` by default: 256x256x13, 6 agents, fusion at
    stage 3), as the reference's own stack runs it: float32, eval mode,
    forward only, NCHW ``nn.BatchNorm2d`` and ``F.grid_sample``, with
    PyTorch's default TF32 settings (cuDNN convs in TF32, matmuls not),
    set for the call and restored after it. The reference's host-side
    postprocess is not timed, so the rate is the reference's best case.

    ``occupancy`` is the port's (B, A, H, W, D) map (a bench batch's own),
    permuted here to the graph's (B, A, D, H, W), with its ``trans``
    (B, A, A, 4, 4) and ``agent_mask`` (B, A). On the card: a host clock
    over ``steps`` calls after ``warmup``, bracketed by synchronizes.
    """
    dev = resolve_device(device)
    cfg = Config() if config is None else config
    occ = occupancy.to(dev, torch.float32).permute(0, 1, 4, 2, 3).contiguous()
    trans = trans.to(dev, torch.float32)
    mask = agent_mask.to(dev, torch.bool)
    model = build_model(cfg.grid.grid_shape, cfg.grid.area_extents, cfg.anchors.num_anchors,
                        cfg.num_classes, cfg.anchors.box_code_size, cfg.fusion_layer)(mode="disco")
    model = model.to(dev).eval()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        with torch.no_grad():
            for _ in range(warmup):
                model(occ, trans, mask)
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                model(occ, trans, mask)
            sync()
            dt = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return occ.shape[0] * steps / dt
