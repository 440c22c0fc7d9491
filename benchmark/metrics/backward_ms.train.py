"""Device milliseconds a step of the backward, the port's span
``det.train_step/det.backward`` (every kernel it launches, on the
autograd engine's thread too), over the traced stretch's ``train_step``
calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.train_step/det.backward", "det.train_step")
