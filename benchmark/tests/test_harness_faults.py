"""A run of each cell on the CPU at 64x64x8 (the look for a card skipped)
reads ``correct`` true, and with the timed path broken underneath reads
it false: for the training cells a step that leaves the state unchanged,
half of the batch left out with the loss's mean taken over the rest, and
a step's new weights of one leaf altered where they are produced (their
change doubled); for the prediction cells half of the batch left out, a
box altered where it is produced (moved 1 m), and NMS broken three ways:
it keeps every valid candidate, or its IoU matrix reads all 0 or all 1.
The float8 control (the
reference in the program's place, one precision below bfloat16) reads
false too. At
this size the training cells' program runs its activations in float32:
the limits are set for bfloat16 at the cell's own size, where the tiny
model's bfloat16 noise would already fail them."""

import time

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import cell as C
from benchmark.harness import check, program
from small import SEED, shrink

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _tweak(cell):
    shrink(cell)
    if cell.kind == "train":
        cell.config["precision"]["activations"] = "float32"


def _run(name, break_module, monkeypatch):
    build = program.build

    def broken(*args, **kwargs):
        module = build(*args, **kwargs)
        break_module(module)
        return module

    monkeypatch.setattr(program, "build", broken)
    return C.run_cell(name, SEED, 0.5, False, CPU, time.time(), tweak=_tweak)


@pytest.mark.parametrize("name", ["disco_train", "v2v_train", "v2v_predict", "disco_predict"])
def test_a_sound_run_reads_correct(name, monkeypatch):
    r = _run(name, lambda module: None, monkeypatch)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and set(r["metrics"]) >= {"setup_s", "peak_mem_gib"}


def _unchanged(module):
    module.optimizer.step = lambda *a, **k: None


def _half_train(module):
    step = module.train_step
    half = lambda t: t[: t.shape[0] // 2] if torch.is_tensor(t) and t.dim() else t
    module.train_step = lambda prepared: step({k: half(v) for k, v in prepared.items()})


def _update_altered(module):
    step = module.train_step
    leaf = module.model.encoder.blocks[2].conv1.weight

    def altered(prepared):
        before = leaf.detach().clone()
        metrics = step(prepared)
        with torch.no_grad():
            leaf.add_(leaf - before)  # the step's new weights of one leaf: their change doubled
        return metrics

    module.train_step = altered


@pytest.mark.parametrize("name", ["disco_train", "v2v_train"])
@pytest.mark.parametrize("fault", [_unchanged, _half_train, _update_altered],
                         ids=["state_unchanged", "half_batch", "update_altered"])
def test_training_faults_read_not_correct(name, fault, monkeypatch):
    r = _run(name, fault, monkeypatch)
    assert r["correct"] is False and r["failed"] > 0
    assert list(r)[-1] == "checks"


def _half_predict(module):
    predict = module.predict

    def half(batch, *args):
        b = batch["points"].shape[0] // 2
        out = predict({k: v[:b] for k, v in batch.items()}, *args)
        pad = lambda t, fill: torch.cat([t, torch.full_like(t, fill)])
        return type(out)(pad(out.boxes, 0.0), pad(out.scores, -1e9), pad(out.valid, False))

    module.predict = half


def _box_altered(module):
    predict = module.predict

    def altered(batch, *args):
        out = predict(batch, *args)
        boxes = out.boxes.clone()
        boxes[..., 0, 0] += 1.0  # each agent's best candidate moved 1 m
        return type(out)(boxes, out.scores, out.valid)

    module.predict = altered


def _with_nms_part(name, replacement):
    """A fault that swaps one part of the port's NMS while ``predict`` runs."""

    def fault(module):
        from v2x_sim_tpu_torch.ops import nms
        from v2x_sim_tpu_torch.ops.cuda import iou_cu

        owner = {"greedy_keep": nms, "rotated_iou_matrix": iou_cu}[name]
        predict = module.predict

        def broken(batch, *args):
            saved = getattr(owner, name)
            setattr(owner, name, replacement)
            try:
                return predict(batch, *args)
            finally:
                setattr(owner, name, saved)

        module.predict = broken

    return fault


# NMS keeps every valid candidate; the IoU matrix reads 0 (NMS suppresses
# nothing); the IoU matrix reads 1 (NMS keeps one candidate an agent).
_nms_keeps_all = _with_nms_part("greedy_keep", lambda iou, valid, threshold: valid.clone())
_iou_zero = _with_nms_part("rotated_iou_matrix", lambda a, b: a.new_zeros(a.shape[:-1] + b.shape[-2:-1]))
_iou_one = _with_nms_part("rotated_iou_matrix", lambda a, b: a.new_ones(a.shape[:-1] + b.shape[-2:-1]))


@pytest.mark.parametrize("name", ["v2v_predict", "disco_predict"])
@pytest.mark.parametrize("fault", [_half_predict, _box_altered, _nms_keeps_all, _iou_zero, _iou_one],
                         ids=["half_batch", "box_altered", "nms_keeps_all", "iou_matrix_zero",
                              "iou_matrix_one"])
def test_prediction_faults_read_not_correct(name, fault, monkeypatch):
    r = _run(name, fault, monkeypatch)
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("name", ["disco_train", "v2v_train", "v2v_predict", "disco_predict"])
def test_the_float8_control_reads_not_correct(name):
    cell = C.load_cell(name)
    readings = calibrate.control_readings(name, SEED, CPU, tweak=shrink)
    assert not check.passed(check.judge(readings["control"], cell.limits))
