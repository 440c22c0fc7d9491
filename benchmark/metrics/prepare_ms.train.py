"""Device milliseconds of one ``DetModule.prepare_batch`` call (voxelize
and the anchor assignment) in the untraced stretch: CUDA events around
every call, their total over their count."""


def read(r):
    ms = r.spans_ms.get("prepare_batch")
    return sum(ms) / len(ms) if ms else None
