"""Device milliseconds a call of the fusion across agents, the port's
span ``det.predict/det.model/det.fuse`` (the warp and the configuration's
fusion module), over the traced stretch's ``predict`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.predict/det.model/det.fuse", "det.predict")
