"""The plain reference of the training path: the anchor assignment, the
loss, the backward and Adam.

Written from the semantics the port states (``DetModule.prepare_batch``
and ``train_step`` with ``ops/assign.py``'s rules), in float32:

  * candidates: each BEV cell takes the two valid GT whose centres lie
    nearest its centre (the first index on ties); every anchor of the cell
    gets the exact rotated IoU with both and keeps the larger (the first
    when equal);
  * forcing: each valid GT whose own cell (the cell holding its centre,
    clamped into the grid) has an anchor it overlaps takes the first of
    that cell's anchors with the largest IoU; where that anchor is not yet
    positive it becomes positive for that GT (the largest GT index where
    several GT force one anchor);
  * labels: positive at IoU >= pos_iou_threshold, background under
    neg_iou_threshold, ignored between; positives in cells beyond the
    first ``sparse_cell_capacity`` positive cells (in cell order) are
    demoted to ignored and carry no regression target;
  * regression targets at positive anchors: (dx, dy) over the anchor's
    diagonal, log size ratios, sin and cos of the GT's yaw;
  * loss: softmax focal loss (gamma, alpha) over the non-ignored anchors
    of real agents, plus smooth-L1 (delta) over the positive anchors'
    codes, each summed and divided by max(positive count, 1);
  * Adam (lr, betas, eps) with bias correction; BatchNorm normalizes by the
    batch's statistics over every agent map.

Imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch

from benchmark.reference.detect import anchor_grid, voxelize
from benchmark.reference.iou import rotated_iou

#: Pairs of (anchor, GT) clipped at once.
IOU_BLOCK = 1 << 21


class Targets(NamedTuple):
    """labels (N, n) int64 in {1, 0, -1}; reg (N, n, 6); pos (N, n) bool."""

    labels: torch.Tensor
    reg: torch.Tensor
    pos: torch.Tensor


def _pair_iou(anchors: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of (P, 5) anchors and (P, 5) GT boxes. Pairs whose
    circumscribed circles lie apart cannot overlap and read 0 unclipped."""
    d2 = (anchors[:, :2] - gts[:, :2]).square().sum(dim=-1)
    r = lambda t: 0.5 * torch.sqrt(t[:, 2] ** 2 + t[:, 3] ** 2)
    near = d2 <= (r(anchors) + r(gts)).square() * 1.001 + 1e-3
    out = torch.zeros(anchors.shape[0], device=anchors.device)
    idx = near.nonzero()[:, 0]
    for s in range(0, idx.numel(), IOU_BLOCK):
        i = idx[s:s + IOU_BLOCK]
        out[i] = rotated_iou(anchors[i], gts[i])
    return out


def encode(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    ax, ay, al, aw = anchors[..., 0], anchors[..., 1], anchors[..., 2], anchors[..., 3]
    diag = torch.sqrt(al * al + aw * aw)
    return torch.stack([(gt[..., 0] - ax) / diag, (gt[..., 1] - ay) / diag,
                        torch.log(gt[..., 2] / al), torch.log(gt[..., 3] / aw),
                        torch.sin(gt[..., 4]), torch.cos(gt[..., 4])], dim=-1)


def assign(gt_boxes: torch.Tensor, gt_mask: torch.Tensor, config: dict) -> Targets:
    """(N, M, 5) GT boxes with (N, M) mask -> the targets of every anchor."""
    dev = gt_boxes.device
    anchors = anchor_grid(config, dev)
    h, w, k, _ = anchors.shape
    n_cells, n = h * w, h * w * k
    rows, m = gt_mask.shape
    pos_thr = config["anchors"]["pos_iou_threshold"]
    neg_thr = config["anchors"]["neg_iou_threshold"]
    flat = anchors.reshape(n, 5)
    centre = anchors[:, :, 0, :2].reshape(n_cells, 2)
    labels, regs, poss = [], [], []
    for r in range(rows):
        gt, ok = gt_boxes[r], gt_mask[r].to(torch.bool)
        d2 = (centre[:, None, :] - gt[None, :, :2]).square().sum(dim=-1)
        d2 = torch.where(ok[None], d2, torch.full_like(d2, float("inf")))
        c1 = d2.argmin(dim=1)
        d2[torch.arange(n_cells, device=dev), c1] = float("inf")
        c2 = d2.argmin(dim=1)
        ious = []
        for c in (c1, c2):
            ca = c.repeat_interleave(k)
            ious.append(_pair_iou(flat, gt[ca]) * ok[ca].float())
        take2 = ious[1] > ious[0]
        iou = torch.where(take2, ious[1], ious[0])
        best = torch.where(take2, c2.repeat_interleave(k), c1.repeat_interleave(k))
        # Forcing: each GT's own cell, its anchors' IoU, the first largest.
        (x0, _), (y0, _) = config["grid"]["area_extents"][:2]
        vx, vy = config["grid"]["voxel_size"][:2]
        gr = torch.floor((gt[:, 0] - x0) / vx).long().clamp(0, h - 1)
        gc = torch.floor((gt[:, 1] - y0) / vy).long().clamp(0, w - 1)
        own = anchors[gr, gc]  # (M, K, 5)
        own_iou = rotated_iou(gt[:, None, :].expand(m, k, 5), own)
        own_k = own_iou.argmax(dim=1)
        force = ok & (own_iou.amax(dim=1) > 0.0)
        target = torch.where(force, (gr * w + gc) * k + own_k, n)  # n: a sink
        forced_gt = torch.full((n + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, target, torch.arange(m, device=dev), reduce="amax")[:n]
        take_forced = (forced_gt >= 0) & (iou < pos_thr)
        best_iou = torch.where(take_forced, torch.full_like(iou, pos_thr), iou)
        best = torch.where(take_forced, forced_gt, best)
        pos = best_iou >= pos_thr
        lab = torch.where(pos, 1, torch.where(best_iou < neg_thr, 0, -1))
        # The positive-cell capacity: positives beyond it are ignored.
        cell_pos = pos.reshape(n_cells, k).any(dim=1)
        in_cap = (torch.cumsum(cell_pos.long(), 0) <= config["sparse_cell_capacity"])
        kept = pos & in_cap.repeat_interleave(k)
        lab = torch.where(pos & ~kept, -1, lab)
        reg = torch.where(kept[:, None], encode(gt[best], flat), torch.zeros(n, 6, device=dev))
        labels.append(lab)
        regs.append(reg)
        poss.append(kept)
    return Targets(torch.stack(labels), torch.stack(regs), torch.stack(poss))


def loss(cls: torch.Tensor, reg: torch.Tensor, targets: Targets, agent_mask: torch.Tensor,
         config: dict) -> torch.Tensor:
    """Focal + smooth-L1 loss of (B, A, H, W, K, C) logits and (B, A, H, W,
    K, 6) codes against the (B*A, n) targets of every anchor."""
    spec = config["loss"]
    gamma, alpha, delta = spec["focal_gamma"], spec["focal_alpha"], spec["smooth_l1_delta"]
    c = cls.shape[-1]
    real = agent_mask.reshape(-1, 1).to(torch.bool)
    labels = torch.where(real, targets.labels, -1).reshape(-1)
    logp = torch.log_softmax(cls.reshape(-1, c).float(), dim=-1)
    lp = logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
    alpha_t = torch.where(labels > 0, alpha, 1.0 - alpha)
    focal = -alpha_t * (1.0 - lp.exp()) ** gamma * lp
    cls_sum = (focal * (labels >= 0)).sum()
    pos = (targets.pos & real).reshape(-1)
    diff = (reg.reshape(-1, reg.shape[-1]).float() - targets.reg.reshape(-1, 6)).abs()
    huber = torch.where(diff < delta, 0.5 * diff * diff / delta, diff - 0.5 * delta)
    loc_sum = (huber.sum(dim=-1) * pos).sum()
    return (cls_sum + loc_sum) / (labels > 0).sum().clamp(min=1).float()


class Adam:
    """Adam with bias correction, parameter by parameter."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, betas, eps: float):
        self.params, self.lr, self.betas, self.eps = list(params), lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            m.mul_(b1).add_(p.grad, alpha=1 - b1)
            v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
            denom = (v / (1 - b2 ** self.t)).sqrt_().add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))


class Steps(NamedTuple):
    """What the reference's first steps give: each step's loss, every
    parameter's gradient at the first step, and every parameter's change
    over the steps, by state-dict name."""

    losses: List[float]
    grads: Dict[str, torch.Tensor]
    deltas: Dict[str, torch.Tensor]


def train_steps(model, batches: Sequence[dict], config: dict) -> Steps:
    """One step of ``model`` (train mode) a batch, from its current
    weights; each batch holds points, point_mask, trans, agent_mask,
    gt_boxes and gt_mask."""
    opt_spec = config["optimizer"]
    named = [(k, p) for k, p in model.named_parameters()]
    start = {k: p.detach().clone() for k, p in named}
    opt = Adam([p for _, p in named], opt_spec["lr"], tuple(opt_spec["betas"]), opt_spec["eps"])
    model.train()
    losses, grads = [], {}
    for i, batch in enumerate(batches):
        b, a = batch["agent_mask"].shape
        mask = batch["agent_mask"].to(torch.bool)
        with torch.no_grad():
            occ = voxelize(batch["points"], batch["point_mask"], config)
            targets = assign(batch["gt_boxes"].reshape(b * a, -1, 5),
                             batch["gt_mask"].reshape(b * a, -1), config)
        for p in model.parameters():
            p.grad = None
        cls, reg = model(occ, batch["trans"], mask)
        value = loss(cls, reg, targets, mask, config)
        value.backward()
        losses.append(float(value.detach()))
        if i == 0:
            grads = {k: p.grad.detach().clone() for k, p in named}
        del cls, reg, value
        opt.step()
    deltas = {k: p.detach() - start[k] for k, p in named}
    return Steps(losses, grads, deltas)
