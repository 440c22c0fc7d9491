"""DiscoNet's FLOPs a call, from the shapes (``harness/flopcount.py``'s
rules): the backbone and heads, plus the fusion's 1x1 edge encoder, its
ego half once an ego agent, its warped half and the edge score once a
(ego, source) pair, all A x A pairs of a scene. A train step is the
forward three times (forward, input and weight gradients) less the stem
conv's input gradient."""

from __future__ import annotations

from benchmark.harness.flopcount import backbone, stage_sizes


def forward(config: dict, batch: int) -> int:
    total, _ = backbone(config, batch)
    a, layer = config["num_agents"], config["fusion_layer"]
    c, hidden = config["stage_channels"][layer], config["fusion"]["edge_hidden"]
    rows, cols = stage_sizes(config)[layer]
    cells = rows * cols
    return (total + 2 * batch * a * cells * c * hidden
            + 2 * batch * a * a * cells * (c * hidden + hidden))


def predict(config: dict, batch: int) -> int:
    return forward(config, batch)


def train_step(config: dict, batch: int) -> int:
    return 3 * forward(config, batch) - backbone(config, batch)[1]
