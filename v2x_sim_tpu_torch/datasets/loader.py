"""Background-thread batch prefetcher.

Port of ``v2x_sim_tpu/datasets/loader.py``: one background thread and a
bounded queue. The host side (the npz cache's threaded reads, the native
.pcd.bin reader, numpy scene generation) releases the GIL, and the heavy
per-batch work (voxelize, target assignment) runs on the device.

``device_prefetch`` on a CUDA device runs its stage on a CUDA stream of
the prefetch thread's own, so that batch N+1's upload and preparation
overlap batch N's training step on the consumer's stream:

  * the thread uploads each host batch's numpy arrays through pinned
    buffers with ``non_blocking=True``, then runs the stage, then records
    an event on its stream;
  * the consumer makes its current stream wait on that event (no host
    synchronization), and every tensor of the prepared batch
    ``record_stream``s the consumer's stream, so the caching allocator
    does not hand its block to a later batch while the step still reads it;
  * each batch's pinned buffers stay referenced until its event has
    completed.

PyTorch's current stream is per thread, so kernels that launch on
``torch.cuda.current_stream()`` (``ops/cuda/iou_cu.py``) launch on the
prefetch stream when the stage calls them.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Union

import numpy as np
import torch


class Prefetcher:
    """Wraps a batch iterable; keeps ``depth`` batches ready ahead of time.
    An exception in the source is raised on the consumer's side, after the
    items before it."""

    _DONE = object()

    def __init__(self, source: Iterable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, args=(source,), daemon=True)
        self._thread.start()

    def _fill(self, source):
        try:
            for item in source:
                self._q.put(item)
        except BaseException as e:  # raised again on the consumer's side
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item


def prefetch(source: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``source`` with background prefetching."""
    return iter(Prefetcher(source, depth))


def device_prefetch(
    source: Iterable,
    stage: Callable,
    depth: int = 2,
    device: Optional[Union[str, torch.device]] = None,
) -> Iterator:
    """Prefetch with a stage run inside the prefetch thread.

    Without a CUDA ``device``, ``stage(raw)`` runs on each item of
    ``source`` as it is. With one, each item is a dict of host arrays: its
    numpy arrays go up to the device through pinned buffers first, and
    ``stage`` (e.g. ``DetModule.prepare_batch``) gets the dict of device
    tensors, on the thread's own stream (see the module docstring).
    """
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return prefetch((stage(raw) for raw in source), depth)
    return _cuda_consumer(Prefetcher(_cuda_stages(source, stage, device), depth), device)


def _upload_pinned(batch: dict, device: torch.device, pinned: List[torch.Tensor]) -> dict:
    """The dict with each numpy array copied to ``device`` through a pinned
    host buffer, non-blocking on the current stream; the buffers are
    appended to ``pinned``, which must outlive the copies."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            host = torch.from_numpy(np.ascontiguousarray(value)).pin_memory()
            pinned.append(host)
            value = host.to(device, non_blocking=True)
        out[key] = value
    return out


def _cuda_stages(source: Iterable, stage: Callable, device: torch.device):
    """In the prefetch thread: upload and stage each batch on a side
    stream; yields (prepared, event after the stage, pinned buffers)."""
    stream = torch.cuda.Stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        for raw in source:
            pinned: List[torch.Tensor] = []
            prepared = stage(_upload_pinned(raw, device, pinned))
            done = torch.cuda.Event()
            done.record(stream)
            yield prepared, done, pinned


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _cuda_consumer(items: Prefetcher, device: torch.device) -> Iterator:
    pending = collections.deque()  # (event, pinned buffers) of batches in flight
    try:
        for prepared, done, pinned in items:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for t in _tensors(prepared):
                if t.device.type == "cuda":
                    t.record_stream(stream)
            pending.append((done, pinned))
            while pending and pending[0][0].query():
                pending.popleft()
            yield prepared
    finally:  # also when the consumer stops early: no buffer goes while its copy runs
        for done, _ in pending:
            done.synchronize()
