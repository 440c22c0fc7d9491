"""The plain reference against the port on the CPU at 64x64x8, in float32,
with one state dict drawn from a seed: both configurations' logits and
predictions, and the training reference's targets, loss and first step."""

import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness import check, loops, program
from benchmark.harness.weights import make_state_dict
from benchmark.reference import detect, train
from small import SEED, shrink

CPU = torch.device("cpu")


def _cell(name):
    c = C.load_cell(name)
    shrink(c)
    c.config["precision"]["activations"] = "float32"
    return c


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["disco_predict", "v2v_predict"])
def test_reference_logits_and_predictions_match_the_port(name):
    c = _cell(name)
    pool = C.make_pool(c, SEED, CPU)
    sd = make_state_dict(C.skeleton(c), SEED, CPU)
    module = program.build(c.config, sd, CPU)
    ref = C.reference_model(c, sd, CPU).eval()
    batch = pool[0]
    with torch.no_grad():
        occ = detect.voxelize(batch["points"], batch["point_mask"], c.config)
        want = ref(occ, batch["trans"], batch["agent_mask"].bool())
        got = module.model(module.model_input(module.to_device(batch)), batch["trans"],
                           batch["agent_mask"].bool())
    for a, b in zip(want, (got.cls_logits, got.reg)):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-4 * max(1.0, float(a.abs().max()))
    t = c.traffic
    out = module.predict(batch, t["max_boxes"], t["nms_iou"], t["score_threshold"])
    dets, dense = detect.predict(ref, batch, c.config, t["max_boxes"], t["nms_iou"],
                                 t["score_threshold"])
    assert torch.equal(out.valid, dets.valid)
    assert (out.boxes - dets.boxes).abs().max() < 1e-3
    numbers = check.predict_numbers([detect.Detections(*out)], [dets], [dense], c.config, t)
    assert numbers["box_gap"] < 1e-3 and numbers["select_gap"] < 1e-4
    assert numbers["count_gap"] == 0.0 and numbers["nms_errors"] == 0.0


# The worst leaf's first gradient in float32: V2VNet's three GRU rounds
# lengthen the backward's path, and its encoder's first BatchNorm leaves
# read up to 1.9e-3 from rounding alone (its loss agrees to 1e-5).
@pytest.mark.parametrize("name, grad_tol", [("disco_train", 1e-3), ("v2v_train", 4e-3)])
def test_reference_training_matches_the_port(name, grad_tol):
    c = _cell(name)
    pool = C.make_pool(c, SEED, CPU)
    sd = make_state_dict(C.skeleton(c), SEED, CPU)
    module = program.build(c.config, sd, CPU)
    # The targets: the port's sparse layout against the reference's labels.
    prepared = module.prepare_batch(pool[0])
    b, a = pool[0]["agent_mask"].shape
    targets = train.assign(pool[0]["gt_boxes"].reshape(b * a, -1, 5),
                           pool[0]["gt_mask"].reshape(b * a, -1), c.config)
    assert torch.equal(prepared["labels"].reshape(b * a, -1).long(), targets.labels)
    assert int(targets.pos.sum()) == int(prepared["reg_sp_w"].sum()) > 0
    loop = loops.TrainStream(module, pool, loops.Device(CPU))
    primed = loop.prime(c.traffic["check_steps"])
    ref = train.train_steps(C.reference_model(c, sd, CPU), pool[:3], c.config)
    deltas = {k: primed["params"][k] - sd[k] for k in ref.deltas}
    numbers = check.train_numbers(primed["losses"], primed["grads"], deltas, ref)
    assert numbers["loss_gap_first"] < 1e-5 and numbers["loss_gap"] < 1e-3
    assert numbers["grad_gap"] < grad_tol
