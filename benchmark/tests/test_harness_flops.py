"""Each configuration's analytic FLOP count against FlopCounterMode over
the plain reference at a small shape (forward, and a training step's
forward and backward), and DiscoNet's totals at B=16 against the counts
the port's bench measured on the card."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import cell as C
from benchmark.harness.weights import make_state_dict
from small import shrink


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["disco_train", "v2v_predict"])
def test_analytic_count_equals_the_reference_count(name):
    c = C.load_cell(name)
    shrink(c)
    model = C.reference_model(c, make_state_dict(C.skeleton(c), 3, "cpu"), "cpu")
    flops = c.flops()
    b, a = 2, c.config["num_agents"]
    h, w, d = c.config["grid"]["shape"]
    occ = (torch.rand(b, a, d, h, w, generator=torch.Generator().manual_seed(0)) < 0.05).float()
    trans = torch.eye(4).expand(b, a, a, 4, 4).clone()
    trans[..., :2, 3] = 3.0 * torch.rand(b, a, a, 2, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(b, a, dtype=torch.bool)
    with torch.no_grad():
        assert _counted(lambda: model(occ, trans, mask)) == flops.predict(c.config, b)

    def step():
        cls, reg = model(occ, trans, mask)
        (cls.float().square().mean() + reg.float().square().mean()).backward()

    assert _counted(step) == flops.train_step(c.config, b)


def test_disconet_totals_at_b16():
    c = C.load_cell("disco_train")
    flops = c.flops()
    assert flops.predict(c.config, 16) == 2_976_852_738_048
    assert flops.train_step(c.config, 16) == 8_883_447_791_616


def test_v2vnet_counts_the_neighbour_messages():
    c = C.load_cell("v2v_predict")
    d = C.load_cell("disco_predict")
    extra = c.flops().predict(c.config, 16) - d.flops().predict(d.config, 16)
    # 30 neighbour pairs x 2 convs + 6 agents x (ego half + gates 4x + candidate 2x), x 3 rounds
    unit = 2 * 9 * 256 * 256 * 32 * 32 * 16
    edge = 2 * 16 * 6 * 1024 * 256 * 32 + 2 * 16 * 36 * 1024 * (256 * 32 + 32)
    assert extra == 3 * (60 + 6 * 7) * unit - edge
