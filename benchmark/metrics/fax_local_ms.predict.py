"""Device milliseconds a call of CoBEVT's local (window) attention block
(LayerNorm, attention over (slot, s, s) windows, residual): the port's
span ``det.predict/det.model/det.fuse/det.fuse.fax_local``, one a layer,
summed over the layers, over the traced stretch's ``predict`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.predict/det.model/det.fuse/det.fuse.fax_local", "det.predict")
