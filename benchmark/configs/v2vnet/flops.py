"""V2VNet's FLOPs a call, from the shapes (``harness/flopcount.py``'s
rules): the backbone and heads, plus, each round, the A(A-1) neighbour
messages of a scene (the warped half of the hidden 3x3 conv and the
output 3x3 conv, once a pair; not the self and padded pairs the port
computes and masks), the ego half of the hidden conv once an agent, and
the ConvGRU's gates (2C -> 2C) and candidate (2C -> C) 3x3 convs once an
agent. A train step is the forward three times less the stem conv's input
gradient."""

from __future__ import annotations

from benchmark.harness.flopcount import backbone, conv, stage_sizes


def forward(config: dict, batch: int) -> int:
    total, _ = backbone(config, batch)
    a, layer = config["num_agents"], config["fusion_layer"]
    c = config["stage_channels"][layer]
    rows, cols = stage_sizes(config)[layer]
    pairs, agents = batch * a * (a - 1), batch * a
    per_round = (2 * conv(3, c, c, rows, cols, pairs) + conv(3, c, c, rows, cols, agents)
                 + conv(3, 2 * c, 2 * c, rows, cols, agents)
                 + conv(3, 2 * c, c, rows, cols, agents))
    return total + config["fusion"]["rounds"] * per_round


def predict(config: dict, batch: int) -> int:
    return forward(config, batch)


def train_step(config: dict, batch: int) -> int:
    return 3 * forward(config, batch) - backbone(config, batch)[1]
