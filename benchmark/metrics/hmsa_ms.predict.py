"""Device milliseconds a call of V2X-ViT's heterogeneous multi-agent attention
(HMSA): the port's span
``det.predict/det.model/det.fuse/det.fuse.hmsa``, one a layer, summed over
the layers, over the traced stretch's ``predict`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.predict/det.model/det.fuse/det.fuse.hmsa", "det.predict")
