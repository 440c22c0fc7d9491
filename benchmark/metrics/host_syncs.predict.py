"""Blocking host syncs a call (``harness/spans.py``'s ``SYNCS`` begun
inside the port's span ``det.predict``), over the traced stretch's
``predict`` calls."""

from benchmark.harness.readers import span_per_call


def read(r):
    return span_per_call(r, ["det.predict"], "syncs", "det.predict")
