"""Kernel launches a call inside the port's span ``det.predict/det.nms``
(the greedy loop launches a few a candidate), over the traced stretch's
``predict`` calls."""

from benchmark.harness.readers import span_per_call


def read(r):
    return span_per_call(r, ["det.predict/det.nms"], "launches", "det.predict")
