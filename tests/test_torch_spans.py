"""The port's ``det.`` spans (``v2x_sim_tpu_torch/utils/spans.py``) on the CPU.

  * With no profiler open, ``span`` returns the shared null context and
    makes no ``record_function``; the flag it reads is the one
    ``torch.profiler`` keeps current (equal to the C++ profiler state
    before, inside, in a schedule's wait step and after a session).
  * Under ``torch.profiler.profile(activities=[CPU])`` each entry of
    ``DetModule`` gives exactly its span tree, each path once a call:
    ``predict`` in DiscoNet and V2VNet (``det.fuse.round`` once a round),
    ``prepare_batch`` and ``train_step`` plain, with a KD teacher and with
    MGDA.
  * ``predict``'s boxes, scores and valid mask, and a ``train_step``'s
    metrics, parameters and Adam state, are bit-equal with and without a
    profiler open.
  * The trace keeps the nesting through autograd: every backward op lies
    in ``det.backward``, and no forward span holds one.

A 32x32x4 grid (2 m voxels), widths 8..128, two scenes of 512 points.
"""

import contextlib
from collections import Counter

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from v2x_sim_tpu_torch.configs.config import Config, GridConfig
from v2x_sim_tpu_torch.datasets.synthetic import SyntheticSpec, generate_batch
from v2x_sim_tpu_torch.models.det.net import DetModel
from v2x_sim_tpu_torch.train.det_module import DetModule
from v2x_sim_tpu_torch.utils import spans
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

CFG = Config(grid=GridConfig(voxel_size=(2.0, 2.0, 1.25)))
SPEC = SyntheticSpec(points_per_agent=512, num_vehicles=4, max_gt=8)
WIDTH = 0.25
KD_WEIGHT = 1e5
ROUNDS = 3


def _cpu_profile(**kw):
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw)


def _module(mode="disco", **kw):
    m = DetModule(CFG, mode, device="cpu", width_mult=WIDTH, **kw)
    m.init_weights(0)
    if kw.get("kd_weight"):
        m.init_teacher_weights(1)
    return m


def _batch(m, seed=0):
    return m.to_device(generate_batch(CFG, SPEC, 2, seed=seed))


def _paths(prof) -> Counter:
    """Each ``det.`` span's path (the ``det.`` spans around it, outermost
    first, and its own name, joined by "/"), counted."""
    out = Counter()
    for e in prof.events():
        if not e.name.startswith("det."):
            continue
        names, p = [], e
        while p is not None:
            if p.name.startswith("det."):
                names.append(p.name)
            p = p.cpu_parent
        out["/".join(reversed(names))] += 1
    return out


def _tree(entry, children):
    """``entry`` and each child path under it, once each."""
    return Counter([entry] + [f"{entry}/{c}" for c in children])


MODEL = ["det.model", "det.model/det.encode", "det.model/det.heads"]
FUSED = MODEL + ["det.model/det.fuse"]
PREDICT = ["det.voxelize", "det.decode", "det.nms", "det.nms/det.nms.iou",
           "det.nms/det.nms.greedy"]
ASSIGN = ["det.voxelize", "det.assign", "det.assign/det.assign.nearest",
          "det.assign/det.assign.iou", "det.assign/det.assign.forced"]
STEP = ["det.loss", "det.backward", "det.optimizer"]


def test_span_is_the_shared_null_context_when_nothing_records(monkeypatch):
    assert not autograd_profiler._is_profiler_enabled

    def no_record(*a, **kw):
        raise AssertionError("a record_function was made while nothing records")

    monkeypatch.setattr(autograd_profiler, "record_function", no_record)
    a, b = spans.span("det.a"), spans.span("det.b")
    assert a is b is spans.OFF and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass

    @spans.spanned("det.c")
    def f(x, y=1):
        """doc"""
        return x + y

    assert f(2, y=3) == 5 and f.__name__ == "f" and f.__doc__ == "doc"


def test_recording_flag_follows_the_profiler():
    state = torch._C._autograd._profiler_enabled
    flag = lambda: autograd_profiler._is_profiler_enabled
    assert flag() is state() is False
    with _cpu_profile() as prof:
        assert flag() is state() is True
        s = spans.span("det.x")
        assert isinstance(s, autograd_profiler.record_function) and s.name == "det.x"
        with s:
            torch.ones(2).sum()
    assert flag() is state() is False
    assert [e.name for e in prof.events() if e.name == "det.x"] == ["det.x"]
    # A schedule's wait and warm-up steps record nothing: no span opens.
    seen = []
    with _cpu_profile(schedule=torch.profiler.schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            seen.append((flag(), state(), spans.span("det.y") is spans.OFF))
            prof.step()
    assert seen == [(False, False, True), (False, False, True), (True, True, False)]


@pytest.mark.parametrize("mode", ["disco", "v2v"])
def test_predict_span_tree(mode):
    m = _module(mode, fusion={"rounds": ROUNDS} if mode == "v2v" else None)
    batch = _batch(m)
    with _cpu_profile() as prof:
        m.predict(batch, 16)
    want = _tree("det.predict", FUSED + PREDICT)
    if mode == "v2v":
        want["det.predict/det.model/det.fuse/det.fuse.round"] = ROUNDS
    assert _paths(prof) == want


@pytest.mark.parametrize("case", ["plain", "kd"])
def test_prepare_batch_span_tree(case):
    m = _module(kd_weight=KD_WEIGHT if case == "kd" else 0.0)
    batch = _batch(m)
    with _cpu_profile() as prof:
        m.prepare_batch(batch)
    assert _paths(prof) == _tree("det.prepare_batch",
                                 ASSIGN + (["det.teacher_input"] if case == "kd" else []))


@pytest.mark.parametrize("case", ["plain", "kd", "mgda"])
def test_train_step_span_tree(case):
    m = _module(kd_weight=KD_WEIGHT if case == "kd" else 0.0, mgda=case == "mgda")
    prepared = m.prepare_batch(_batch(m))
    with _cpu_profile() as prof:
        m.train_step(prepared)
    want = FUSED + STEP + (["det.teacher"] if case == "kd" else [])
    assert _paths(prof) == _tree("det.train_step", want)


@pytest.mark.parametrize("mode", ["disco", "v2v"])
def test_predict_is_bit_equal_under_the_profiler(mode):
    m = _module(mode)
    batch = _batch(m, seed=3)
    plain = m.predict(batch, 16)
    with _cpu_profile():
        traced = m.predict(batch, 16)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    assert bool(plain.valid.any())


def test_train_step_is_bit_equal_under_the_profiler():
    a, b = _module(), _module()
    prepared = a.prepare_batch(_batch(a, seed=4))
    with _cpu_profile():
        traced_prepared = b.prepare_batch(_batch(b, seed=4))
    for k, v in prepared.items():
        assert torch.equal(v, traced_prepared[k]), k
    plain = a.train_step(prepared)
    with _cpu_profile():
        traced = b.train_step(prepared)
    assert plain.keys() == traced.keys()
    assert all(torch.equal(plain[k], traced[k]) for k in plain)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq")), name
    for (name, x), y in zip(a.model.named_buffers(), b.model.buffers()):
        assert torch.equal(x, y), name


def test_backward_ops_nest_in_the_backward_span():
    m = _module()
    prepared = m.prepare_batch(_batch(m))
    with _cpu_profile() as prof:
        m.train_step(prepared)
    inner = Counter()
    for e in prof.events():
        if not e.name.startswith("autograd::engine::evaluate_function"):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("det."):
            p = p.cpu_parent
        inner[None if p is None else p.name] += 1
    assert set(inner) == {"det.backward"} and inner["det.backward"] > 50
    # The forward's ops sit in the model's spans, and none of the backward's.
    forward = [e for e in prof.events() if e.name == "det.encode"]
    assert len(forward) == 1
    kids = [c.name for c in forward[0].cpu_children]
    assert kids and not any(k.startswith("autograd::engine") for k in kids)


def test_teacher_model_opens_no_entry_span():
    """The KD teacher's own forward opens the stage spans it calls
    (``encode``, ``heads``) but no ``det.model``: it is not DetModel's
    forward."""
    m = _module(kd_weight=KD_WEIGHT)
    occ = m.merged_occupancy(_batch(m))
    assert isinstance(m.teacher, DetModel)
    with _cpu_profile() as prof:
        m.teacher(occ)
    assert _paths(prof) == Counter(["det.encode", "det.heads"])
