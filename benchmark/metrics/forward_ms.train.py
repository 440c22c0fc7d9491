"""Device milliseconds a step of the model's forward in training, the
port's span ``det.train_step/det.model`` (encoder, fusion, decoder and
heads), over the traced stretch's ``train_step`` calls."""

from benchmark.harness.readers import span_ms


def read(r):
    return span_ms(r, "det.train_step/det.model", "det.train_step")
