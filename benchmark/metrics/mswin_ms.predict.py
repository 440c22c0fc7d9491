"""Device milliseconds a call of V2X-ViT's multi-scale window attention
(MSwin): the port's span
``det.predict/det.model/det.fuse/det.fuse.mswin``, one a layer, summed over
the layers, over the traced stretch's ``predict`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.predict/det.model/det.fuse/det.fuse.mswin", "det.predict")
