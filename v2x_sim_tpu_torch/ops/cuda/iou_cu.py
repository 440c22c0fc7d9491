"""Wrapper of the rotated-IoU CUDA kernel (``csrc/rotated_iou.cu``).

The kernel replaces the Pallas TPU kernels
``v2x_sim_tpu/ops/pallas/iou_pl.py::rotated_iou_pairs_soa`` and
``rotated_iou_pairs_soa_periodic``. Three entry points share its per-pair
code:

  * ``rotated_iou_pairs_soa``: aligned pairs from field-major (5, N)
    operands — the first Pallas function; the anchor assignment's
    forced-anchor test calls it;
  * ``rotated_iou_matrix``: batched (G, N, 5) x (G, M, 5) -> (G, N, M)
    without a broadcast copy — what NMS calls;
  * ``rotated_iou_pairs_soa_periodic``: a (5, n) anchor table against
    (5, B*n) boxes, pair p reading anchor p % n without a tiled copy — the
    second Pallas function; the anchor assignment calls it twice.

A CPU tensor goes to the plain PyTorch version (``ops/iou_sh.py``). A CUDA
tensor launches the kernel or raises; there is no fallback. Each wrapper
counts its launches in its ``launches`` attribute.

Bound on the H100: fp32 scalar operations, ``OPS_PER_PAIR`` a pair (the
count is derived in the source's header) against ``BYTES_PER_PAIR`` of
memory traffic for the aligned-pairs entry point (the periodic entry point
moves ``PERIODIC_BYTES_PER_PAIR``: its anchor table is read from L2).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from v2x_sim_tpu_torch.ops import iou_sh
from v2x_sim_tpu_torch.ops.cuda import build

#: Scalar operations one pair costs, counted from csrc/rotated_iou.cu.
OPS_PER_PAIR = 3149
#: Bytes one aligned pair moves: two 5-float boxes in, one float out.
BYTES_PER_PAIR = 44
#: Bytes one periodic pair moves: one 5-float box in, one float out.
PERIODIC_BYTES_PER_PAIR = 24

_MAX_THREADS = (2**31 - 1) * 256


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, sizes as int64)."""
    lib = build.load("rotated_iou")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.v2x_rotated_iou_pairs.argtypes = [ptr, ptr, ptr, i64, ptr]
    lib.v2x_rotated_iou_pairs.restype = ctypes.c_int
    lib.v2x_rotated_iou_matrix.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr]
    lib.v2x_rotated_iou_matrix.restype = ctypes.c_int
    lib.v2x_rotated_iou_pairs_periodic.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
    lib.v2x_rotated_iou_pairs_periodic.restype = ctypes.c_int
    return lib


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every operand lies on the CPU; raises on a mix of
    devices or on a device that is neither CPU nor CUDA."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check_cuda_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on_error(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def rotated_iou_pairs_soa(a_soa: torch.Tensor, b_soa: torch.Tensor) -> torch.Tensor:
    """(5, N) x (5, N) field-major (x, y, l, w, yaw) float32 -> (N,) IoU."""
    if a_soa.dim() != 2 or a_soa.shape[0] != 5 or a_soa.shape != b_soa.shape:
        raise ValueError(f"expected two (5, N) operands, got {tuple(a_soa.shape)} and {tuple(b_soa.shape)}")
    if _on_cpu(a_soa, b_soa):
        return iou_sh.rotated_iou(a_soa.T, b_soa.T)
    _check_cuda_operand(a_soa, "a_soa")
    _check_cuda_operand(b_soa, "b_soa")
    n = a_soa.shape[1]
    if n > _MAX_THREADS:
        raise ValueError(f"too many pairs for one launch: {n}")
    out = torch.empty(n, dtype=torch.float32, device=a_soa.device)
    if n == 0:
        return out
    with torch.cuda.device(a_soa.device):
        rc = _lib().v2x_rotated_iou_pairs(
            a_soa.data_ptr(), b_soa.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(rc, "rotated_iou_pairs")
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
    if _on_cpu(boxes_a, boxes_b):
        return iou_sh.rotated_iou_matrix(boxes_a, boxes_b)
    _check_cuda_operand(boxes_a, "boxes_a")
    _check_cuda_operand(boxes_b, "boxes_b")
    g, n, m = boxes_a.shape[0], boxes_a.shape[1], boxes_b.shape[1]
    if g * n * m > _MAX_THREADS:
        raise ValueError(f"too many pairs for one launch: {g * n * m}")
    out = torch.empty((g, n, m), dtype=torch.float32, device=boxes_a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(boxes_a.device):
        rc = _lib().v2x_rotated_iou_matrix(
            boxes_a.data_ptr(), boxes_b.data_ptr(), out.data_ptr(), g, n, m,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(rc, "rotated_iou_matrix")
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
    if _on_cpu(a_soa, b_soa):
        return iou_sh.rotated_iou_pairs_soa_periodic(a_soa, b_soa)
    _check_cuda_operand(a_soa, "a_soa")
    _check_cuda_operand(b_soa, "b_soa")
    if nb > _MAX_THREADS:
        raise ValueError(f"too many pairs for one launch: {nb}")
    out = torch.empty(nb, dtype=torch.float32, device=a_soa.device)
    if nb == 0:
        return out
    with torch.cuda.device(a_soa.device):
        rc = _lib().v2x_rotated_iou_pairs_periodic(
            a_soa.data_ptr(), b_soa.data_ptr(), out.data_ptr(), n, nb,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error(rc, "rotated_iou_pairs_periodic")
    rotated_iou_pairs_soa_periodic.launches += 1
    return out


rotated_iou_pairs_soa_periodic.launches = 0


def reset_launches() -> None:
    """Zero every entry point's launch count."""
    rotated_iou_pairs_soa.launches = 0
    rotated_iou_matrix.launches = 0
    rotated_iou_pairs_soa_periodic.launches = 0
