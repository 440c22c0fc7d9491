"""Device milliseconds a step of the anchor assignment, the port's span
``det.prepare_batch/det.assign`` (nearest GT, the IoU kernels, forcing),
over the traced stretch's ``prepare_batch`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.prepare_batch/det.assign", "det.prepare_batch")
