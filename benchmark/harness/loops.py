"""The two closed loops a traffic mix can ask for, and their windows.

``train_stream``: one trainer. Each step runs ``prepare_batch`` on the
next pool batch, then ``train_step`` on the batch prepared before it (the
streaming order of the port's bench); the pool batches are used in turn.
One step stays in flight: a step's launch waits for the step before it to
finish, as a trainer reading the previous step's loss does.

``predict_closed``: one caller. ``predict`` on the pool batches in turn,
each call's result synchronized before the next call.

A window runs calls until ``seconds`` have passed on the host clock, then
synchronizes: a rate is all the window's work over all its time (the
arithmetic of ``v2x_sim_tpu_torch/bench.py::_rate``, commit 73ef7cd, a
host clock between synchronizes). With ``spans`` on, CUDA events time
every call into the entry.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function


class Device:
    """Synchronize and time on the card; on the CPU (the harness's tests)
    the same calls run with host clocks."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self, timing: bool = False):
        return torch.cuda.Event(enable_timing=timing) if self.cuda else _HostEvent()


class _HostEvent:
    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """Start and end events of each call into the entry, by name."""

    def __init__(self, dev: Device, on: bool):
        self.dev, self.on = dev, on
        self.pairs: Dict[str, list] = {}

    def run(self, name: str, fn):
        with record_function(f"bench.{name}"):
            if not self.on:
                return fn()
            start, end = self.dev.event(True), self.dev.event(True)
            start.record()
            out = fn()
            end.record()
            self.pairs.setdefault(name, []).append((start, end))
            return out

    def ms(self) -> Dict[str, List[float]]:
        """Each call's device milliseconds (after a synchronize)."""
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.pairs.items()}


class TrainStream:
    """``train_stream``: see the module docstring."""

    def __init__(self, module, pool: List[dict], dev: Device):
        self.module, self.pool, self.dev = module, pool, dev
        self.next = 0
        self.cur = self._prepare(Spans(dev, False))
        self.done: Optional[object] = None
        self.losses: List[torch.Tensor] = []

    def _prepare(self, spans: Spans):
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        return spans.run("prepare_batch", lambda: self.module.prepare_batch(batch))

    def step(self, spans: Spans) -> dict:
        nxt = self._prepare(spans)
        metrics = spans.run("train_step", lambda: self.module.train_step(self.cur))
        self.cur = nxt
        done = self.dev.event()
        done.record()
        if self.done is not None:
            with record_function("bench.wait"):
                self.done.synchronize()
        self.done = done
        return metrics

    def prime(self, steps: int) -> dict:
        """The first ``steps`` steps (set-up), and what the check reads of
        them: each step's loss, the first gradient as Adam holds it, and the
        parameters after the last of them, on the host."""
        module = self.module
        beta1 = module.optimizer.param_groups[0]["betas"][0]
        named = list(module.model.named_parameters())
        losses, grads = [], {}
        for s in range(steps):
            losses.append(self.step(Spans(self.dev, False))["loss"].detach().clone())
            if s == 0:
                # Where the optimizer took no step it holds no moment: a zero gradient.
                grads = {k: (module.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                             / (1.0 - beta1)).cpu() for k, p in named}
        params = {k: p.detach().to("cpu", copy=True) for k, p in named}
        self.dev.sync()
        return {"losses": [float(x) for x in losses], "grads": grads, "params": params}

    def window(self, seconds: float, spans: Spans) -> dict:
        self.dev.sync()
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.losses.append(self.step(spans)["loss"])
            steps += 1
        self.dev.sync()
        elapsed = time.perf_counter() - t0
        batch = self.pool[0]["agent_mask"].shape[0]
        bad = int((~torch.isfinite(torch.stack(self.losses))).sum()) if self.losses else 0
        return {"seconds": elapsed, "calls": steps, "scenes": steps * batch, "failed": bad}


class PredictClosed:
    """``predict_closed``: see the module docstring. The check's sample is
    one call on each pool batch, drawn from the seed among the window's
    calls on it (a reservoir of one), copied on the device."""

    def __init__(self, module, pool: List[dict], dev: Device, traffic: dict, seed: int):
        self.module, self.pool, self.dev = module, pool, dev
        self.args = (traffic["max_boxes"], traffic["nms_iou"], traffic["score_threshold"])
        self.rng = random.Random(seed)
        self.slots: List[Optional[tuple]] = [None] * len(pool)
        self.seen = [0] * len(pool)
        self.next = 0

    def call(self, spans: Spans):
        i = self.next % len(self.pool)
        self.next += 1
        out = spans.run("predict", lambda: self.module.predict(self.pool[i], *self.args))
        with record_function("bench.sync"):
            self.dev.sync()
        return i, out

    def prime(self) -> None:
        for _ in self.pool:
            self.call(Spans(self.dev, False))
        self.next = 0

    def window(self, seconds: float, spans: Spans) -> dict:
        self.dev.sync()
        lat = []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
            i, out = self.call(spans)
            lat.append(time.perf_counter() - t)
            self.seen[i] += 1
            if self.rng.random() * self.seen[i] < 1.0:
                if self.slots[i] is None:
                    self.slots[i] = tuple(x.clone() for x in out)
                else:
                    for slot, x in zip(self.slots[i], out):
                        slot.copy_(x)
        elapsed = time.perf_counter() - t0
        batch = self.pool[0]["agent_mask"].shape[0]
        return {"seconds": elapsed, "calls": len(lat), "scenes": len(lat) * batch,
                "latencies": lat, "failed": 0}
