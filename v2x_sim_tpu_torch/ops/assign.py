"""GT -> anchor target assignment.

Port of ``v2x_sim_tpu/ops/assign.py``: ``sparse_cell_capacity``,
``target_fingerprint``, ``SparseTargets``, ``AnchorTargets``,
``assign_targets_batched`` in its three layouts (dense, ``flat=True``
and ``flat="sparse"``), ``assign_targets``, and the sparse label wire
format of baked caches (``labels_from_sparse_idx``, ``sparse_label_idx``,
``label_counts``). For a batch of padded GT sets:

  1. every BEV cell keeps its two nearest GT centers as candidates;
  2. exact rotated IoU of every anchor against both candidates: the
     (5, n) anchor table against (5, B*n) looked-up GT boxes, one launch
     of the periodic CUDA entry point per candidate (``ops/cuda/iou_cu.py``);
  3. each GT's best anchor shape at its own cell is forced positive
     unless some GT already makes it positive: the own cell, the IoU of
     the GT against its K anchors and their first maximum in one launch of
     the forced-anchor entry point (``iou_cu.forced_anchor``);
  4. labels, and regression targets: at every anchor (dense and flat), or
     at the top-Pc positive cells' K anchors only (sparse, the training
     path's layout).

The GT lookups are gathers (the JAX package's one-hot einsums are a TPU
matrix-unit layout), and the forced-anchor test is a scatter-max over the
B*M forced anchors instead of a (B, n, M) comparison.
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.ops import iou_sh
from v2x_sim_tpu_torch.ops.anchors import anchor_grid
from v2x_sim_tpu_torch.ops.boxes import encode_boxes
from v2x_sim_tpu_torch.ops.cuda import iou_cu
from v2x_sim_tpu_torch.utils.spans import span, spanned

#: Positive-cell capacity at coarse grids (>= 1 m voxels), where a vehicle
#: covers a handful of cells.
_SPARSE_CELLS = 256
#: Capacity at finer grids: at 0.25 m a vehicle has IoU >= 0.4 anchors in
#: ~100 cells, and 210-672 positive cells per agent-scene were measured.
_SPARSE_CELLS_FINE = 1024


def sparse_cell_capacity(config: Config) -> int:
    """Positive-cell capacity of the sparse layout for ``config``'s grid.
    Positive anchors in cells beyond it are demoted to ignore (-1)."""
    cap = _SPARSE_CELLS if float(config.grid.voxel_size[0]) >= 1.0 else _SPARSE_CELLS_FINE
    h, w = config.grid.bev_shape
    return min(cap, h * w)


def target_fingerprint(config: Config) -> int:
    """CRC32 of everything the meaning of baked targets depends on: the
    anchor grid's float32 values, the assignment thresholds, the box-code
    width, the positive-cell capacity and a semantics version (2.0).

    Stored in a cache's ``tgt_meta`` (``tools/create_data_det.py
    --targets 1``) and checked by ``tools/common.py::strip_stale_targets``.
    The bytes are the JAX package's, so both packages accept each other's
    caches."""
    a = config.anchors
    payload = (
        np.ascontiguousarray(anchor_grid(config), dtype=np.float32).tobytes()
        + np.asarray([a.pos_iou_threshold, a.neg_iou_threshold, float(a.box_code_size)],
                     np.float32).tobytes()
        + np.asarray([float(sparse_cell_capacity(config)), 2.0], np.float32).tobytes()
    )
    return zlib.crc32(payload) & 0x7FFFFFFF  # fits an int32


class SparseTargets(NamedTuple):
    """Sparse positive-anchor training targets, anchors in (H, W, K) order.

    labels: (B, n) int8 classification labels {1, 0, -1}, n = H*W*K.
    cells: (B, Pc) int64 BEV cells, the positive ones first, each group in
      index order.
    wts: (B, Pc*K) float32, 1.0 where that cell's anchor is positive.
    reg: (B, Pc*K, 6) float32 encoded deltas at those anchors.
    overflow: (B,) int32 positive cells beyond the capacity Pc.
    iou: (B, n) float32 each anchor's IoU with its better candidate, before
      forcing (what the label thresholds read; not in the JAX package).
    """

    labels: torch.Tensor
    cells: torch.Tensor
    wts: torch.Tensor
    reg: torch.Tensor
    overflow: torch.Tensor
    iou: torch.Tensor


class AnchorTargets(NamedTuple):
    """Training targets at every anchor (the dense and flat layouts).

    labels: int32 classification labels {1, 0, -1}: (B, H, W, K) dense,
      (B, n) flat.
    reg_targets: float32 encoded deltas, zero where not positive:
      (B, H, W, K, 6) dense, field-major (B, 6, n) flat.
    reg_mask: float32, 1.0 where the anchor is positive; the labels' shape.
    best_iou: float32 each anchor's IoU with its better candidate, forced
      anchors lifted to the positive threshold; the labels' shape.
    """

    labels: torch.Tensor
    reg_targets: torch.Tensor
    reg_mask: torch.Tensor
    best_iou: torch.Tensor


@spanned("det.assign.nearest")
def nearest_gt(
    gt_boxes: torch.Tensor, gt_mask: torch.Tensor, anchors: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two GT nearest to each BEV cell's center.

    Returns c1, c2 (B, H, W) int64 GT indices (the first index on ties; 0
    when no GT is valid) and v1, v2 (B, H, W) bool, whether each is a valid GT.
    """
    cell_x, cell_y = anchors[:, :, 0, 0], anchors[:, :, 0, 1]
    dx = cell_x[None, :, :, None] - gt_boxes[:, None, None, :, 0]
    dy = cell_y[None, :, :, None] - gt_boxes[:, None, None, :, 1]
    d2 = (dx * dx + dy * dy).masked_fill_(~gt_mask[:, None, None, :], float("inf"))
    c1 = d2.argmin(dim=-1)
    c2 = d2.scatter_(-1, c1[..., None], float("inf")).argmin(dim=-1)
    valid = lambda c: torch.gather(gt_mask, 1, c.flatten(1)).view_as(c)
    return c1, c2, valid(c1), valid(c2)


def gt_soa(gt_boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Field-major (5, B*n) GT boxes at the (B, n) per-anchor indices."""
    b, n = idx.shape
    fields = gt_boxes.permute(2, 0, 1)  # (5, B, M)
    return torch.gather(fields, 2, idx[None].expand(5, b, n)).reshape(5, b * n)


def own_cell(gt_boxes: torch.Tensor, grid: GridConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, M) row and column of the BEV cell that holds each GT centre
    (clamped into the grid)."""
    h, w = grid.bev_shape
    (x0, _), (y0, _) = grid.area_extents[0], grid.area_extents[1]
    gr = torch.floor((gt_boxes[..., 0] - x0) / grid.voxel_size[0]).to(torch.int64).clamp(0, h - 1)
    gc = torch.floor((gt_boxes[..., 1] - y0) / grid.voxel_size[1]).to(torch.int64).clamp(0, w - 1)
    return gr, gc


def own_cell_pairs(
    gt_boxes: torch.Tensor, anchors: torch.Tensor, gr: torch.Tensor, gc: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Field-major (5, B*M*K) operands of the forced-anchor test: each GT
    repeated K times against the K anchors of its own cell."""
    b, m = gt_boxes.shape[:2]
    k = anchors.shape[2]
    gt_rep = gt_boxes[:, :, None, :].expand(b, m, k, 5)
    return gt_rep.reshape(-1, 5).T.contiguous(), anchors[gr, gc].reshape(-1, 5).T.contiguous()


def forced_anchor_plain(
    gt_boxes: torch.Tensor, gt_mask: torch.Tensor, anchors: torch.Tensor, grid: GridConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of ``iou_cu.forced_anchor``: each GT against the
    K anchors of its own cell.

    Returns own_iou (B, M, K), own_k (B, M) the first index of the largest
    (the tie order of torch's and JAX's argmax), force (B, M) gt_mask &
    (largest > 0), and cell (B, M) the own cell's row * W + column.
    """
    b, m = gt_boxes.shape[:2]
    k = anchors.shape[2]
    gr, gc = own_cell(gt_boxes, grid)
    gt_op, own_op = own_cell_pairs(gt_boxes, anchors, gr, gc)
    own_iou = iou_sh.rotated_iou(gt_op.T, own_op.T).view(b, m, k)
    force = gt_mask & (own_iou.amax(dim=-1) > 0.0)
    return own_iou, own_iou.argmax(dim=-1), force, gr * anchors.shape[1] + gc


def assign_targets_batched(
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    anchors: torch.Tensor,
    config: Config,
    flat: Union[bool, str] = False,
) -> Union[AnchorTargets, SparseTargets]:
    """Assign GT boxes to anchors for a whole batch at once.

    Args:
      gt_boxes: (B, M, 5) float32 padded GT (x, y, l, w, yaw).
      gt_mask: (B, M) validity.
      anchors: (H, W, K, 5) float32 anchor grid (ops.anchors.anchor_grid).
      config: thresholds and grid geometry.
      flat: the output layout. False: :class:`AnchorTargets` over the
        (B, H, W, K) grid; True: :class:`AnchorTargets` with (B, n) labels
        and field-major (B, 6, n) regression targets; "sparse":
        :class:`SparseTargets`, regression targets at the top-Pc positive
        cells only (the training path's layout).
    """
    if flat not in (False, True, "sparse"):
        raise ValueError(f"flat must be False, True or 'sparse', not {flat!r}")
    h, w, k, _ = anchors.shape
    b, m = gt_boxes.shape[:2]
    n = h * w * k
    dev, dtype = anchors.device, anchors.dtype
    pos_thr = config.anchors.pos_iou_threshold
    neg_thr = config.anchors.neg_iou_threshold
    gt_mask = gt_mask.to(torch.bool)

    # 1-2. Two candidates per cell, exact IoU of every anchor against each.
    c1, c2, v1, v2 = nearest_gt(gt_boxes, gt_mask, anchors)
    per_anchor = lambda t: t[..., None].expand(b, h, w, k).reshape(b, n)
    with span("det.assign.iou"):
        c1f, c2f = per_anchor(c1), per_anchor(c2)
        anchors_soa = anchors.reshape(n, 5).T.contiguous()
        iou1 = iou_cu.rotated_iou_pairs_soa_periodic(anchors_soa, gt_soa(gt_boxes, c1f)).view(b, n)
        iou2 = iou_cu.rotated_iou_pairs_soa_periodic(anchors_soa, gt_soa(gt_boxes, c2f)).view(b, n)
        iou1 = iou1 * per_anchor(v1).to(dtype)
        iou2 = iou2 * per_anchor(v2).to(dtype)
        take2 = iou2 > iou1
        iou = torch.where(take2, iou2, iou1)
        best_gt = torch.where(take2, c2f, c1f)

    # 3. Force each GT's best anchor at its own cell.
    grid = config.grid
    (x0, _), (y0, _) = grid.area_extents[0], grid.area_extents[1]
    vx, vy = grid.voxel_size[0], grid.voxel_size[1]
    with span("det.assign.forced"):
        _, own_k, force, cell = iou_cu.forced_anchor(gt_boxes.contiguous(),
                                                     gt_mask.contiguous(), anchors, grid)
        # Anchor n is a sink for GT that force nothing. Where several GT
        # force one anchor, the largest GT index wins.
        forced_anchor = torch.where(force, cell * k + own_k, n)
        gt_index = torch.arange(m, device=dev).expand(b, m)
        forced_gt = torch.full((b, n + 1), -1, dtype=torch.int64, device=dev).scatter_reduce_(
            1, forced_anchor, gt_index, reduce="amax")[:, :n]
    # Only anchors not already positive for some GT are upgraded, exactly
    # to the positive threshold.
    take_forced = (forced_gt >= 0) & (iou < pos_thr)
    best_iou = torch.where(take_forced, torch.full_like(iou, pos_thr), iou)
    best_gt = torch.where(take_forced, forced_gt, best_gt)

    # 4. Labels and regression targets.
    pos = best_iou >= pos_thr
    labels = torch.where(pos, 1, torch.where(best_iou < neg_thr, 0, -1))
    if flat != "sparse":
        reg_mask = pos.to(dtype)
        anchors_flat = anchors.reshape(n, 5)
        matched = torch.gather(gt_boxes, 1, best_gt[..., None].expand(b, n, 5))
        # Non-positive anchors encode against their own anchor (exact
        # zeros), so padded GT never reaches the log.
        own = torch.cat([anchors_flat[:, :4], torch.zeros_like(anchors_flat[:, :1])], dim=-1)
        reg = encode_boxes(torch.where(pos[..., None], matched, own), anchors_flat) * reg_mask[..., None]
        labels = labels.to(torch.int32)
        if flat:
            return AnchorTargets(labels, reg.transpose(1, 2).contiguous(), reg_mask, best_iou)
        grid_shape = (b, h, w, k)
        return AnchorTargets(labels.view(grid_shape), reg.view(grid_shape + (6,)),
                             reg_mask.view(grid_shape), best_iou.view(grid_shape))

    # The top-Pc positive cells, their K anchors' targets.
    labels = labels.to(torch.int8)
    pc = sparse_cell_capacity(config)
    cell_any = pos.view(b, h * w, k).any(dim=-1)
    # Positive cells first, each group in index order: the tie order of
    # jax.lax.top_k on the 0/1 map. Integer keys keep the sort exact.
    cells = torch.sort((~cell_any).to(torch.int32), dim=1, stable=True).indices[:, :pc]
    lanes = (cells[..., None] * k + torch.arange(k, device=dev)).reshape(b, pc * k)
    sup = torch.gather(pos, 1, lanes)
    wts = sup.to(dtype)
    bg = torch.gather(best_gt, 1, lanes)
    matched = torch.gather(gt_boxes, 1, bg[..., None].expand(b, pc * k, 5))
    cell = lanes // k
    sax = x0 + ((cell // w).to(dtype) + 0.5) * vx
    say = y0 + ((cell % w).to(dtype) + 0.5) * vy
    sizes = torch.tensor(config.anchors.sizes, dtype=dtype, device=dev)[lanes % k]  # (B, P, 3)
    sal, saw = sizes[..., 0], sizes[..., 1]
    zeros = torch.zeros_like(sax)
    # Non-positive lanes encode against their own anchor (exact zeros for
    # the center and size fields), so padded GT never reaches the log.
    sgt = torch.stack(
        [torch.where(sup, matched[..., f], a) for f, a in enumerate((sax, say, sal, saw, zeros))],
        dim=-1,
    )
    reg = encode_boxes(sgt, torch.stack([sax, say, sal, saw, zeros], dim=-1)) * wts[..., None]
    overflow = (cell_any.sum(dim=-1) - pc).clamp(min=0).to(torch.int32)
    # A positive label must carry a regression target: positives in cells
    # beyond the capacity are demoted to ignore.
    supervised = torch.zeros((b, n), dtype=torch.bool, device=dev).scatter_(1, lanes, sup)
    labels = torch.where((labels == 1) & ~supervised, -1, labels)
    return SparseTargets(labels, cells, wts, reg, overflow, iou)


def assign_targets(
    gt_boxes: torch.Tensor, gt_mask: torch.Tensor, anchors: torch.Tensor, config: Config
) -> AnchorTargets:
    """One sample's (M, 5) GT -> dense (H, W, K) :class:`AnchorTargets`
    (:func:`assign_targets_batched` at B=1)."""
    out = assign_targets_batched(gt_boxes[None], gt_mask[None], anchors, config)
    return AnchorTargets(*(t[0] for t in out))


def labels_from_sparse_idx(pos_idx: torch.Tensor, ign_idx: torch.Tensor, n: int) -> torch.Tensor:
    """Padded flat indices -> dense (..., n) int8 labels {1, 0, -1}.

    Indices outside [0, n) (the pad value n) are dropped; positives are
    written after ignores, so an index in both lists is positive.
    """
    lead = tuple(pos_idx.shape[:-1])
    dest = lambda t: torch.where((t >= 0) & (t < n), t, n).reshape(-1, t.shape[-1]).to(torch.int64)
    p, i = dest(pos_idx), dest(ign_idx)
    lab = torch.zeros((p.shape[0], n + 1), dtype=torch.int8, device=pos_idx.device)
    lab.scatter_(1, i, -1)
    lab.scatter_(1, p, 1)
    return lab[:, :n].reshape(lead + (n,))


def _padded_flatnonzero(hit: torch.Tensor, cap: int) -> torch.Tensor:
    """(rows, n) bool -> (rows, cap) int32: each row's first ``cap`` set
    indices in order, padded with n (``jnp.flatnonzero(size=cap,
    fill_value=n)`` per row)."""
    rows, n = hit.shape
    rank = hit.to(torch.int64).cumsum(dim=1) - 1
    # Every index past the cap, and every unset one, lands in column `cap`.
    dest = torch.where(hit & (rank < cap), rank, cap)
    out = torch.full((rows, cap + 1), n, dtype=torch.int64, device=hit.device)
    src = torch.arange(n, device=hit.device).expand(rows, n)
    out.scatter_(1, dest, src)
    return out[:, :cap].to(torch.int32)


def sparse_label_idx(
    labels: torch.Tensor, cap_pos: int, cap_ign: int
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Compress dense (rows, n) labels to the padded index lists that
    :func:`labels_from_sparse_idx` expands: (rows, cap_pos) positive and
    (rows, cap_ign) ignore indices, int32, padded with n; plus the largest
    positive and ignore counts of a row, so the caller can check that the
    caps held (a longer row is truncated)."""
    pos = _padded_flatnonzero(labels == 1, cap_pos)
    ign = _padded_flatnonzero(labels == -1, cap_ign)
    max_pos, max_ign = label_counts(labels)
    return pos, ign, max_pos, max_ign


def label_counts(labels: torch.Tensor) -> Tuple[int, int]:
    """The largest positive and ignore counts of a row of (rows, n) labels."""
    return int((labels == 1).sum(dim=-1).max()), int((labels == -1).sum(dim=-1).max())
