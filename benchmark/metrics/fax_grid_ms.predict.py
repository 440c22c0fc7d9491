"""Device milliseconds a call of CoBEVT's grid (dilated) attention block
(LayerNorm, attention over (slot, s, s) groups h/s pixels apart,
residual): the port's span
``det.predict/det.model/det.fuse/det.fuse.fax_grid``, one a layer, summed
over the layers, over the traced stretch's ``predict`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.predict/det.model/det.fuse/det.fuse.fax_grid", "det.predict")
