"""Device milliseconds a call of V2X-ViT's feed-forward
network (FFN): the port's span
``det.predict/det.model/det.fuse/det.fuse.ffn``, one a layer, summed over
the layers, over the traced stretch's ``predict`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.predict/det.model/det.fuse/det.fuse.ffn", "det.predict")
