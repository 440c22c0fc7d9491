"""V2X-ViT's FLOPs a call, from the shapes (``harness/flopcount.py``'s
rules for the backbone and heads) plus the transformer, counted from its
equations (``reference.py``). Every agent is ego, so a layer sees
B x A egos x A maps x h x w tokens. A token a layer (C channels; HMSA H
heads of d, inner = H d, T agent types; MSwin branches (m_s heads of
d_s, window s), inner_s = m_s d_s; FFN hidden F):

  * HMSA's q, k, v and output Linears: 2 C inner x 4;
  * its relation matrices, folded into the keys and the values once for
    each query type: 2 x 2 T H d^2; its logits and weighted values over
    the A keys: 2 x 2 A H d;
  * each MSwin branch's ``to_qkv`` and ``to_out``: 2 C inner_s x 4; its
    window attention, logits and weighted values over s^2 keys:
    2 x 2 s^2 inner_s;
  * the FFN: 2 C F x 2;

and a map a layer, split attention's fc1 and fc2: 2 C^2 (1 + branches).
The delay encoding (one C x C product a call), LayerNorms, softmaxes,
the warp, the ROI, residuals and the gate are not counted.

At V2X-Sim's stage 3 (C 256, 32 x 32), B = 16, A = 6, 3 layers, HMSA 8 x
32, branches (16 x 16, 4), (8 x 32, 8), (4 x 64, 16), F 256, T 2, by hand:
HMSA 524,288 + 65,536 + 3,072 + 3,072 = 595,968; MSwin 3 x 524,288 +
(16,384 + 65,536 + 262,144) = 1,916,928; FFN 262,144; 2,775,040 a token;
589,824 tokens a layer: 1,636,785,192,960; split attention 576 maps x
524,288 = 301,989,888 a layer; three layers: 4,911,261,548,544.

A train step is the forward three times less the stem conv's input
gradient.
"""

from __future__ import annotations

from benchmark.harness.flopcount import backbone, stage_sizes


def per_token(config: dict) -> int:
    """A token's FLOPs in one layer."""
    f, a = config["fusion"], config["num_agents"]
    c = config["stage_channels"][config["fusion_layer"]]
    heads, d, types = f["heads"], f["dim_head"], f["num_types"]
    inner = heads * d
    hmsa = 8 * c * inner + 4 * types * heads * d * d + 4 * a * heads * d
    mswin = sum(8 * c * m * ds + 4 * s * s * m * ds
                for m, ds, s in zip(f["window_heads"], f["window_dim_heads"], f["window_sizes"]))
    return hmsa + mswin + 4 * c * f["mlp_dim"]


def fusion(config: dict, batch: int) -> int:
    """The transformer's FLOPs a call (the module docstring's count)."""
    f, a = config["fusion"], config["num_agents"]
    c = config["stage_channels"][config["fusion_layer"]]
    rows, cols = stage_sizes(config)[config["fusion_layer"]]
    maps = batch * a * a
    split = 2 * c * c * (1 + len(f["window_sizes"])) if f["window_fusion"] == "split_attn" else 0
    return f["depth"] * (maps * rows * cols * per_token(config) + maps * split)


def forward(config: dict, batch: int) -> int:
    return backbone(config, batch)[0] + fusion(config, batch)


def predict(config: dict, batch: int) -> int:
    return forward(config, batch)


def train_step(config: dict, batch: int) -> int:
    return 3 * forward(config, batch) - backbone(config, batch)[1]
