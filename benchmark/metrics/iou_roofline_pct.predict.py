"""NMS's IoU matrix kernel (``csrc/rotated_iou.cu``'s matrix entry, K1,
once a predict: every agent's max_boxes x max_boxes candidates) in the
traced stretch: the bytes its work needs (``harness/roofline.py``) over
the card's HBM bandwidth, as a share of its device time. The kernel is
bounded by bytes."""

from benchmark.harness.roofline import matrix_bytes


def read(r):
    if r.trace is None or r.peaks is None:
        return None
    launches, seconds = r.trace.kernel_time("rotated_iou_matrix_kernel")
    if not launches:
        return None
    k = r.traffic["max_boxes"]
    need = launches * matrix_bytes(r.batch * r.config["num_agents"], k, k)
    return 100.0 * need / r.peaks["hbm_bytes_per_s"] / seconds
