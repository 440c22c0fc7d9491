"""Device milliseconds a call of the decoder and the heads, the port's
span ``det.predict/det.model/det.heads``, over the traced stretch's
``predict`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.predict/det.model/det.heads", "det.predict")
