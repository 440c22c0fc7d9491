"""Named spans of the port's work, recorded only while a profiler records.

``span(name)`` opens ``torch.profiler.record_function(name)`` while a
``torch.profiler`` session is recording, so the span lands in that
session's trace on the same clock as the kernels launched inside it.
Otherwise it returns one shared null context (``OFF``): no
``RecordFunction`` object is made and the dispatcher is not called, so
a span costs one flag read when nothing records. There is no switch of
its own: a session is whatever opens ``torch.profiler.profile`` (the
benchmark's traced stretch, ``tools/xprof_det.py``, a caller's own).
``spanned(name)`` is the same as a decorator: each call of the function
runs inside ``span(name)``.

Every span of the port is named ``det.<...>``. The entries of
``train/det_module.py::DetModule`` open ``det.predict``,
``det.prepare_batch`` and ``det.train_step``, and the modules that own
the work open the stages inside them (``models/det/net.py``,
``models/det/v2vnet.py``, ``models/det/v2xvit.py``,
``models/det/cobevt.py``, ``ops/assign.py``, ``ops/nms.py``). A span
never sits inside a per-element or per-iteration loop, such as NMS's
greedy loop. There are three exceptions, loops of a few heavy
iterations: V2VNet's round (``det.fuse.round``, 3 a call), V2X-ViT's
layer (``det.fuse.hmsa``, ``det.fuse.mswin`` and ``det.fuse.ffn``, one
each a layer, 3 a call; ``det.fuse.sttf`` once) and CoBEVT's layer
(``det.fuse.fax_local`` and ``det.fuse.fax_grid`` one each a layer,
``det.fuse.ffn`` two, 3 layers a call; ``det.fuse.warp`` and
``det.fuse.head`` once).
"""

from __future__ import annotations

import contextlib
import functools

from torch.autograd import profiler as _profiler

#: What ``span`` returns while nothing records.
OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    session records, else the shared ``OFF``. The flag read is the one
    ``torch.autograd.profiler`` keeps current while a session records
    (``torch._C._autograd._profiler_enabled()`` reads the same state in
    C++; ``tests/test_torch_spans.py`` holds the two equal)."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
