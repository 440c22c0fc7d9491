"""The configuration's ``fusion`` block reaches the port: every key is
handed to the mode's fusion constructor (a disconet file's
``edge_hidden`` sets the edge encoder's width), the existing
configurations build the modules they built before, and a key the port
does not take raises."""

import pytest
import torch

from benchmark.harness import cell as C
from benchmark.harness import program
from benchmark.harness.weights import make_state_dict
from small import SEED, shrink

CPU = torch.device("cpu")


def _build(name, fusion=None, mode=None):
    c = C.load_cell(name)
    shrink(c)
    if fusion is not None:
        c.config["fusion"] = fusion
    if mode is not None:
        c.config["mode"] = mode
    return c, program.build(c.config, make_state_dict(C.skeleton(c), SEED, CPU), CPU)


def test_edge_hidden_sets_the_edge_encoders_width():
    c, module = _build("disco_train", {"edge_hidden": 16})
    assert module.model.fusion.edge_hidden.out_channels == 16
    assert module.model.fusion.edge_score.in_channels == 16


def _port_model(c, fusion=None):
    from v2x_sim_tpu_torch.models.det.net import DetModel

    args = (program.port_config(c.config), c.config["mode"], c.config["stage_channels"][0] / 32)
    if fusion is None:
        return DetModel(*args)
    with program.fusion_keywords(fusion):
        return DetModel(*args)


@pytest.mark.parametrize("name", ["disco_train", "v2v_predict"])
def test_the_configurations_build_what_they_built_before(name):
    c = C.load_cell(name)
    shrink(c)
    given, before = _port_model(c, c.config["fusion"]), _port_model(c)
    shapes = lambda m: {k: v.shape for k, v in m.state_dict().items()}
    assert shapes(given) == shapes(before)
    assert vars(given.fusion).get("rounds") == vars(before.fusion).get("rounds")


@pytest.mark.parametrize("name, fusion, path, want", [
    ("disco_train", {"edge_hidden": 16}, "edge_hidden.out_channels", 16),
    ("v2v_predict", {"rounds": 2, "msg_norm": False}, "rounds", 2),
    ("v2v_predict", {"rounds": 3, "msg_norm": True}, "msg_norm.num_channels", 64),
])
def test_each_key_reaches_the_fusion_module(name, fusion, path, want):
    c = C.load_cell(name)
    shrink(c)
    got = _port_model(c, fusion).fusion
    for part in path.split("."):
        got = getattr(got, part)
    assert got == want


@pytest.mark.parametrize("name, fusion, mode", [
    ("disco_train", {"edge_hidden": 32, "heads": 8}, None),
    ("v2v_predict", {"rounds": 3, "window": 4}, None),
    ("disco_train", {"edge_hidden": 32}, "mean"),
])
def test_a_key_the_port_does_not_take_raises(name, fusion, mode):
    with pytest.raises(ValueError, match="heads|window|no fusion module"):
        _build(name, fusion, mode)
