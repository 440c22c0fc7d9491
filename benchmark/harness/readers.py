"""Per-layer reader bodies that more than one metric file uses: a metric
of the same arithmetic for train and predict cells is two files (its name
takes the suffix of the end-to-end metric it moves), each importing its
body from here, and each span metric reads its span through
``span_per_call`` or ``span_ms``. ``BENCHMARK.json``'s ``workloads``
decides the cells."""


def mfu_pct(r):
    """The whole model's share of the card's dense bf16 peak in the
    untraced stretch: the configuration's analytic FLOPs a call
    (``configs/<name>/flops.py``, never the program's own count) times
    the calls a second, over the peak."""
    if r.peaks is None or not r.calls:
        return None
    return 100.0 * r.flops_per_call * r.calls / r.window_s / r.peaks["bf16_flops"]


def idle_pct(r):
    """The share of the traced stretch in which no kernel, memcpy or
    memset ran on the card (``harness/trace.py``)."""
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def span_per_call(r, paths, field, entry):
    """The sum of ``field`` (``harness/spans.py``: device_s, launches or
    syncs) over the program's span ``paths`` in the traced stretch, a call
    of the span ``entry``; None where the trace, the entry or a path is
    absent."""
    spans = r.trace.spans if r.trace is not None else {}
    calls = spans.get(entry, {}).get("calls")
    if not calls or any(p not in spans for p in paths):
        return None
    return sum(spans[p][field] for p in paths) / calls


def span_ms(r, path, entry):
    """Device milliseconds of the span ``path`` a call of ``entry``."""
    s = span_per_call(r, [path], "device_s", entry)
    return None if s is None else 1e3 * s
