"""The program's ``det.`` spans in a trace: each span path's calls, and
the device seconds, kernel launches and blocking host syncs it caused.

Frozen copy of ``v2x_sim_tpu_torch/tools/xprof_det.py::span_totals`` and
the two helpers it uses (commit 788702d), so that the yardstick does not
move with the port's tools. A span is keyed by its path from its entry
(``det.train_step/det.backward``); the spans are those of the entry's
thread, the thread of the first ``det.`` span. A device event (kernel,
memcpy, memset) belongs to the innermost span open on that thread when
the runtime or driver call that launched it began, the two matched by
``args.correlation``: by time, not by thread, since the backward's
kernels are launched from the autograd engine's thread while the entry's
thread waits inside ``det.backward``. A blocking sync is a call of
``SYNCS`` that begins inside a span. Values include the spans below.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: Chrome-trace categories of device activity.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Categories of the host's calls into CUDA, which carry the correlation.
API_CATS = ("cuda_runtime", "cuda_driver")
#: Runtime calls that block the host until the device has drained.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def span_paths(spans: List[dict]) -> List[Tuple[float, float, str]]:
    """(start, end, path) of each of one thread's nested spans, in order of
    start; a path joins the names of the spans open around a span,
    outermost first, and its own, by "/"."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, float, str]] = []
    for e in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1][1] <= e["ts"]:
            stack.pop()
        item = (e["ts"], e["ts"] + e["dur"], (stack[-1][2] + "/" if stack else "") + e["name"])
        stack.append(item)
        out.append(item)
    return out


def innermost(paths: List[Tuple[float, float, str]], times: List[float]) -> List[Optional[str]]:
    """For each of the sorted ``times``, the path of the innermost span of
    ``paths`` (``span_paths``') open at it, or None."""
    out: List[Optional[str]] = []
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for t in times:
        while i < len(paths) and paths[i][0] <= t:
            while stack and stack[-1][1] <= paths[i][0]:
                stack.pop()
            stack.append(paths[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def span_totals(events: List[dict]) -> Dict[str, Dict[str, float]]:
    """Each ``det.`` span path's calls, host seconds, device seconds,
    kernel launches and blocking syncs (see the module docstring), from a
    trace's complete events; empty where the trace holds no ``det.`` span."""
    det = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("det.")]
    if not det:
        return {}
    first = min(det, key=lambda e: e["ts"])
    paths = span_paths([e for e in det if (e.get("pid"), e.get("tid"))
                        == (first.get("pid"), first.get("tid"))])
    totals: Dict[str, Dict[str, float]] = {}
    for s, e, p in paths:
        t = totals.setdefault(p, dict.fromkeys(("calls", "host_s", "device_s", "launches",
                                                "syncs"), 0))
        t["calls"] += 1
        t["host_s"] += (e - s) / 1e6
    api = [e for e in events if e.get("cat") in API_CATS]
    launched = {e["args"]["correlation"]: e["ts"] for e in api
                if "correlation" in e.get("args", {})}
    hits = [(launched[e["args"]["correlation"]], e) for e in events
            if e.get("cat") in DEVICE_CATS and e.get("args", {}).get("correlation") in launched]
    hits += [(e["ts"], e) for e in api if e["name"] in SYNCS]
    hits.sort(key=lambda h: h[0])
    for (_, e), path in zip(hits, innermost(paths, [t for t, _ in hits])):
        if path is None:
            continue
        parts = path.split("/")
        for n in range(1, len(parts) + 1):
            t = totals["/".join(parts[:n])]
            if e["cat"] in DEVICE_CATS:
                t["device_s"] += e["dur"] / 1e6
                t["launches"] += e["cat"] == "kernel"
            else:
                t["syncs"] += 1
    return totals
