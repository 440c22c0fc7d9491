"""Device milliseconds a step of the optimizer, the port's span
``det.train_step/det.optimizer`` (clipping, the scheduled learning rate,
Adam), over the traced stretch's ``train_step`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.train_step/det.optimizer", "det.train_step")
