"""The yardstick's peaks and the byte counts of the IoU kernels' work.

Peaks are NVIDIA's data sheet's for the H100 SXM at its 700 W limit
(dense, without sparsity; the bf16 figure is
``v2x_sim_tpu_torch/bench.py::PEAK_BF16_FLOPS``, commit 73ef7cd), keyed
by ``torch.cuda.get_device_name()``: a card the table does not list has
no peak, and its shares are not read.

The byte counts are a frozen copy of the byte arithmetic of
``chip_smoke.py::IouWork`` (commit 73ef7cd): each input byte read once and
each output byte written once, from the operands' shapes. The periodic
entry's count leaves out the yaw it reads for the pairs that pass its
cull (4 bytes a passing pair, under 1% of its bytes at the cells' sizes),
so the shares read from them are bounded by bytes and never overstate.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12},
}


def periodic_bytes(n: int, pairs: int) -> int:
    """The periodic entry (K2): the (5, n) anchor table once; x, y, l, w
    of the GT in and the IoU out for every pair."""
    return 4 * 5 * n + 20 * pairs


def forced_bytes(gts: int, anchors: int) -> int:
    """The forced-anchor entry: each GT and its mask in, its K anchors
    gathered and its own_iou out a pair, own_k, force and the cell out."""
    pairs = gts * anchors
    return 21 * gts + 24 * pairs + 17 * gts


def matrix_bytes(g: int, n: int, m: int) -> int:
    """The matrix entry (K1, NMS): both box arrays in, the matrix out."""
    return 4 * (5 * g * (n + m) + g * n * m)
