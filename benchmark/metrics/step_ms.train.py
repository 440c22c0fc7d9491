"""Device milliseconds of one ``DetModule.train_step`` call (forward,
loss, backward, Adam) in the untraced stretch: CUDA events around every
call, their total over their count."""


def read(r):
    ms = r.spans_ms.get("train_step")
    return sum(ms) / len(ms) if ms else None
