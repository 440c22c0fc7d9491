"""Blocking host syncs a step (``harness/spans.py``'s ``SYNCS`` begun
inside the port's spans): those of ``det.prepare_batch`` and of
``det.train_step`` over the traced stretch's ``train_step`` calls."""

from benchmark.harness.readers import span_per_call


def read(r):
    return span_per_call(r, ["det.prepare_batch", "det.train_step"], "syncs", "det.train_step")
