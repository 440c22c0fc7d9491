"""Wrapper of the rotated-IoU CUDA kernel (``csrc/rotated_iou.cu``).

The kernel replaces the Pallas TPU kernels
``v2x_sim_tpu/ops/pallas/iou_pl.py::rotated_iou_pairs_soa`` and
``rotated_iou_pairs_soa_periodic``. Four entry points share its per-pair
code:

  * ``rotated_iou_pairs_soa``: aligned pairs from field-major (5, N)
    operands — the first Pallas function as it stands; nothing on the
    main path calls it;
  * ``forced_anchor``: the anchor assignment's forced-anchor test on its
    own operands — each GT against the K anchors of its own cell, and the
    first best of them, in one launch; where the JAX package's assignment
    reaches the first Pallas function;
  * ``rotated_iou_matrix``: batched (G, N, 5) x (G, M, 5) -> (G, N, M)
    without a broadcast copy — what NMS calls;
  * ``rotated_iou_pairs_soa_periodic``: a (5, n) anchor table against
    (5, B*n) boxes, pair p reading anchor p % n without a tiled copy — the
    second Pallas function; the anchor assignment calls it twice.

The periodic and matrix entry points cull the pairs whose circumscribed
circles lie apart (IoU exactly 0; ``iou_sh.culled`` is a plain copy of the
test) and clip the rest densely from a per-block queue, in one launch with
no host synchronisation; the aligned-pairs and forced-anchor entries
clip every pair.

A CPU tensor goes to the plain PyTorch version (``ops/iou_sh.py``). A CUDA
tensor launches the kernel or raises; there is no fallback. Each wrapper
counts its launches in its ``launches`` attribute.

The ``OPS_*`` constants and ``clip_ops`` count the kernel's scalar
operations as the source's header does; with the bytes a launch moves
they give the data-dependent bound on the H100 (``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from v2x_sim_tpu_torch.configs.config import GridConfig
from v2x_sim_tpu_torch.ops import iou_sh
from v2x_sim_tpu_torch.ops.cuda import build

#: Counted scalar operations (csrc/rotated_iou.cu's header): one box's
#: corners, one box's cull radius, the cull's test of one pair.
OPS_CORNERS = 36
OPS_RADIUS = 8
OPS_CULL = 10
#: A clip stage: fixed, per vertex it takes, per side change, per kept vertex.
OPS_STAGE, OPS_STAGE_VERTEX, OPS_CHANGE, OPS_KEPT = 2, 6, 22, 6
#: The area of the clipped polygon: fixed, and per final vertex.
OPS_AREA, OPS_AREA_VERTEX = 9, 4
#: The forced-anchor entry beyond the IoU: a GT's own cell, a pair's share
#: of the maximum (compare, select), a GT's force test (compare, and).
OPS_OWN_CELL, OPS_ARGMAX, OPS_FORCE = 12, 2, 2
#: The forced-anchor entry's lanes a GT (its largest K) and block size.
FORCED_GROUP, FORCED_THREADS = 8, 128


def clip_ops(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> int:
    """Counted operations of the kernel's clip (corners excluded) on these
    broadcastable (..., 5) pairs, at the vertex counts and side changes
    they produce (``iou_sh.clip_profile``)."""
    taken, changes, kept, final = iou_sh.clip_profile(boxes_a, boxes_b)
    pairs = final.numel()
    return int(
        (4 * OPS_STAGE + OPS_AREA) * pairs + OPS_STAGE_VERTEX * taken.sum()
        + OPS_CHANGE * changes.sum() + OPS_KEPT * kept.sum() + OPS_AREA_VERTEX * final.sum()
    )


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    return declare(build.load("rotated_iou"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' C signatures on a loaded build of
    csrc/rotated_iou.cu (pointers and the stream as void*, sizes as int64)."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.v2x_rotated_iou_pairs.argtypes = [ptr, ptr, ptr, i64, ptr]
    lib.v2x_rotated_iou_pairs.restype = ctypes.c_int
    lib.v2x_rotated_iou_matrix.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.v2x_rotated_iou_matrix.restype = ctypes.c_int
    lib.v2x_rotated_iou_pairs_periodic.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
    lib.v2x_rotated_iou_pairs_periodic.restype = ctypes.c_int
    f32 = ctypes.c_float
    lib.v2x_forced_anchor.argtypes = [ptr, ptr, ptr, f32, f32, f32, f32, i64, i64, ctypes.c_int,
                                      i64, ptr, ptr, ptr, ptr, ptr]
    lib.v2x_forced_anchor.restype = ctypes.c_int
    lib.v2x_empty_launch.argtypes = [i64, ptr]
    lib.v2x_empty_launch.restype = ctypes.c_int
    return lib


def _check_cuda_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rotated_iou_pairs_soa(a_soa: torch.Tensor, b_soa: torch.Tensor) -> torch.Tensor:
    """(5, N) x (5, N) field-major (x, y, l, w, yaw) float32 -> (N,) IoU."""
    if a_soa.dim() != 2 or a_soa.shape[0] != 5 or a_soa.shape != b_soa.shape:
        raise ValueError(f"expected two (5, N) operands, got {tuple(a_soa.shape)} and {tuple(b_soa.shape)}")
    if build.on_cpu(a_soa, b_soa):
        return iou_sh.rotated_iou(a_soa.T, b_soa.T)
    _check_cuda_operand(a_soa, "a_soa")
    _check_cuda_operand(b_soa, "b_soa")
    n = a_soa.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=a_soa.device)
    if n == 0:
        return out
    with torch.cuda.device(a_soa.device):
        rc = _lib().v2x_rotated_iou_pairs(
            a_soa.data_ptr(), b_soa.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream,
        )
    build.raise_on_error(rc, "rotated_iou_pairs")
    rotated_iou_pairs_soa.launches += 1
    return out


rotated_iou_pairs_soa.launches = 0


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(G, N, 5) x (G, M, 5) float32 -> (G, N, M) IoU of every (i, j) pair per g."""
    if (
        boxes_a.dim() != 3 or boxes_b.dim() != 3 or boxes_a.shape[-1] != 5
        or boxes_b.shape[-1] != 5 or boxes_a.shape[0] != boxes_b.shape[0]
    ):
        raise ValueError(
            f"expected (G, N, 5) and (G, M, 5), got {tuple(boxes_a.shape)} and {tuple(boxes_b.shape)}"
        )
    if build.on_cpu(boxes_a, boxes_b):
        return iou_sh.rotated_iou_matrix(boxes_a, boxes_b)
    _check_cuda_operand(boxes_a, "boxes_a")
    _check_cuda_operand(boxes_b, "boxes_b")
    g, n, m = boxes_a.shape[0], boxes_a.shape[1], boxes_b.shape[1]
    out = torch.empty((g, n, m), dtype=torch.float32, device=boxes_a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(boxes_a.device):
        rc = _lib().v2x_rotated_iou_matrix(
            boxes_a.data_ptr(), boxes_b.data_ptr(), out.data_ptr(), g, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    build.raise_on_error(rc, "rotated_iou_matrix")
    rotated_iou_matrix.launches += 1
    return out


rotated_iou_matrix.launches = 0


def rotated_iou_pairs_soa_periodic(a_soa: torch.Tensor, b_soa: torch.Tensor) -> torch.Tensor:
    """(5, n) x (5, nb) field-major float32 -> (nb,) IoU, where pair p
    takes box A from column p % n; nb must be a multiple of n."""
    if a_soa.dim() != 2 or b_soa.dim() != 2 or a_soa.shape[0] != 5 or b_soa.shape[0] != 5:
        raise ValueError(f"expected (5, n) and (5, nb) operands, got {tuple(a_soa.shape)} and {tuple(b_soa.shape)}")
    n, nb = a_soa.shape[1], b_soa.shape[1]
    if n == 0 or nb % n:
        raise ValueError(f"pair count {nb} is not a multiple of the period {n}")
    if build.on_cpu(a_soa, b_soa):
        return iou_sh.rotated_iou_pairs_soa_periodic(a_soa, b_soa)
    _check_cuda_operand(a_soa, "a_soa")
    _check_cuda_operand(b_soa, "b_soa")
    out = torch.empty(nb, dtype=torch.float32, device=a_soa.device)
    if nb == 0:
        return out
    with torch.cuda.device(a_soa.device):
        rc = _lib().v2x_rotated_iou_pairs_periodic(
            a_soa.data_ptr(), b_soa.data_ptr(), out.data_ptr(), n, nb,
            torch.cuda.current_stream().cuda_stream,
        )
    build.raise_on_error(rc, "rotated_iou_pairs_periodic")
    rotated_iou_pairs_soa_periodic.launches += 1
    return out


rotated_iou_pairs_soa_periodic.launches = 0


def forced_anchor(gt_boxes: torch.Tensor, gt_mask: torch.Tensor, anchors: torch.Tensor,
                  grid: GridConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forced-anchor test: each GT against the K anchors of its own
    BEV cell (``ops/assign.py::forced_anchor_plain``, its plain version).

    Args:
      gt_boxes: (B, M, 5) float32 padded GT (x, y, l, w, yaw).
      gt_mask: (B, M) bool validity.
      anchors: (H, W, K, 5) float32 anchor table, (H, W) = grid.bev_shape;
        the kernel takes K <= FORCED_GROUP.
      grid: the grid whose extents and voxel size place the cells.

    Returns own_iou (B, M, K) float32, own_k (B, M) int64 (the first index
    of the largest), force (B, M) bool (valid and an IoU above 0), and cell
    (B, M) int64, the own cell's row * W + column.
    """
    if (gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 5 or gt_mask.shape != gt_boxes.shape[:2]
            or anchors.dim() != 4 or anchors.shape[-1] != 5
            or tuple(anchors.shape[:2]) != tuple(grid.bev_shape)):
        raise ValueError(f"expected (B, M, 5) GT, a (B, M) mask and ({grid.bev_shape}, K, 5) "
                         f"anchors, got {tuple(gt_boxes.shape)}, {tuple(gt_mask.shape)} and "
                         f"{tuple(anchors.shape)}")
    if build.on_cpu(gt_boxes, gt_mask, anchors):
        from v2x_sim_tpu_torch.ops.assign import forced_anchor_plain  # assign imports this module

        return forced_anchor_plain(gt_boxes, gt_mask, anchors, grid)
    h, w, k = anchors.shape[:3]
    if not 1 <= k <= FORCED_GROUP:
        raise ValueError(f"the kernel takes 1 to {FORCED_GROUP} anchors a cell, not {k}")
    _check_cuda_operand(gt_boxes, "gt_boxes")
    _check_cuda_operand(anchors, "anchors")
    if gt_mask.dtype != torch.bool or not gt_mask.is_contiguous():
        raise TypeError(f"gt_mask must be contiguous bool, got {gt_mask.dtype}")
    b, m = gt_boxes.shape[:2]
    dev = gt_boxes.device
    own_iou = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    own_k, cell = (torch.empty((b, m), dtype=torch.int64, device=dev) for _ in range(2))
    force = torch.empty((b, m), dtype=torch.bool, device=dev)
    if b * m == 0:
        return own_iou, own_k, force, cell
    (x0, _), (y0, _) = grid.area_extents[0], grid.area_extents[1]
    with torch.cuda.device(dev):
        rc = _lib().v2x_forced_anchor(
            gt_boxes.data_ptr(), gt_mask.data_ptr(), anchors.data_ptr(), x0, y0,
            grid.voxel_size[0], grid.voxel_size[1], h, w, k, b * m, own_iou.data_ptr(),
            own_k.data_ptr(), force.data_ptr(), cell.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.raise_on_error(rc, "forced_anchor")
    forced_anchor.launches += 1
    return own_iou, own_k, force, cell


forced_anchor.launches = 0


def reset_launches() -> None:
    """Zero every entry point's launch count."""
    forced_anchor.launches = 0
    rotated_iou_pairs_soa.launches = 0
    rotated_iou_matrix.launches = 0
    rotated_iou_pairs_soa_periodic.launches = 0
