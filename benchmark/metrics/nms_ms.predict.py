"""Device milliseconds a call of NMS, the port's span
``det.predict/det.nms`` (sort, the IoU matrix kernel, the greedy loop),
over the traced stretch's ``predict`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.predict/det.nms", "det.predict")
