"""CoBEVT's FLOPs a call, from the shapes (``harness/flopcount.py``'s rules
for the backbone and heads) plus the FAX encoder, counted from its
equations (``reference.py``). Every agent is ego, so a layer sees B x A
egos x L = A slots x h x w tokens. A token a layer (C channels, C /
dim_head heads; window s, so each attention is over N = L s^2 keys; FFN
hidden F):

  * each of the two attentions (local and grid): ``to_qkv`` 2 C 3C and
    ``to_out`` 2 C C, its logits and weighted values over N keys: 2 x 2
    N C;
  * each of the two FFNs: 2 C F x 2;

and each ego's output pixel, the head's Linear: 2 C C. LayerNorms,
softmaxes, the position bias, the key mask, the slot mean, the warp and
residuals are not counted.

At V2X-Sim's stage 3 (C 256, 32 x 32), B = 16, A = L = 6, window 8 (N
384), F 256, 3 layers, by hand: an attention 393,216 + 131,072 + 393,216
= 917,504; an FFN 262,144; 2 x 917,504 + 2 x 262,144 = 2,359,296 a token
a layer; 589,824 tokens a layer: 1,391,569,403,904; three layers:
4,174,708,211,712; the head, 98,304 ego pixels x 131,072 =
12,884,901,888; in all 4,187,593,113,600.

A train step is the forward three times less the stem conv's input
gradient.
"""

from __future__ import annotations

from benchmark.harness.flopcount import backbone, stage_sizes


def per_token(config: dict) -> int:
    """A token's FLOPs in one layer."""
    f, a = config["fusion"], config["num_agents"]
    c = config["stage_channels"][config["fusion_layer"]]
    keys = a * f["window_size"] ** 2
    attention = 2 * c * 3 * c + 2 * c * c + 4 * keys * c
    return 2 * attention + 2 * 4 * c * f["mlp_dim"]


def fusion(config: dict, batch: int) -> int:
    """The encoder's and the head's FLOPs a call (the module docstring's count)."""
    a = config["num_agents"]
    c = config["stage_channels"][config["fusion_layer"]]
    rows, cols = stage_sizes(config)[config["fusion_layer"]]
    pixels = batch * a * rows * cols
    return config["fusion"]["depth"] * pixels * a * per_token(config) + pixels * 2 * c * c


def forward(config: dict, batch: int) -> int:
    return backbone(config, batch)[0] + fusion(config, batch)


def predict(config: dict, batch: int) -> int:
    return forward(config, batch)


def train_step(config: dict, batch: int) -> int:
    return 3 * forward(config, batch) - backbone(config, batch)[1]
