"""The anchor assignment's IoU kernels (``csrc/rotated_iou.cu``: the
periodic entry, K2, twice a prepare, and the forced-anchor entry once) in
the traced stretch: the bytes their work needs (``harness/roofline.py``)
over the card's HBM bandwidth, as a share of their device time. The
kernels are bounded by bytes."""

from benchmark.harness.roofline import forced_bytes, periodic_bytes


def read(r):
    if r.trace is None or r.peaks is None:
        return None
    h, w, _ = r.config["grid"]["shape"]
    k = len(r.config["anchors"]["sizes"])
    maps = r.batch * r.config["num_agents"]
    n_per, t_per = r.trace.kernel_time("rotated_iou_pairs_periodic_kernel")
    n_for, t_for = r.trace.kernel_time("rotated_iou_forced_anchor_kernel")
    if not (n_per or n_for):
        return None
    need = (n_per * periodic_bytes(h * w * k, maps * h * w * k)
            + n_for * forced_bytes(maps * r.traffic["scene"]["max_gt"], k))
    return 100.0 * need / r.peaks["hbm_bytes_per_s"] / (t_per + t_for)
