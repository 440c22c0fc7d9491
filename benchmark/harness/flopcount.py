"""FLOPs of the STPN backbone and heads, counted from the shapes.

Convolutions only, forward: 2 k^2 C_in C_out H_out W_out a map (the 3x3
pad-1 convs halve a map's size at stride 2, rounding up). A configuration's
``flops.py`` adds its fusion's products. The count reads the same whatever
implements the layers; BatchNorm, the warp, elementwise work, the decode
and the IoU kernels are not counted.
"""

from __future__ import annotations

from typing import List, Tuple


def conv(k: int, cin: int, cout: int, rows: int, cols: int, maps: int) -> int:
    return 2 * k * k * cin * cout * rows * cols * maps


def stage_sizes(config: dict) -> List[Tuple[int, int]]:
    h, w, _ = config["grid"]["shape"]
    sizes = [(h, w)]
    for _ in config["stage_channels"][1:]:
        sizes.append((-(-sizes[-1][0] // 2), -(-sizes[-1][1] // 2)))
    return sizes


def backbone(config: dict, batch: int) -> Tuple[int, int]:
    """(forward FLOPs of the encoder, decoder and heads over batch x
    agents maps, the stem conv's share), the stem's input needing no
    gradient in training."""
    h, w, d = config["grid"]["shape"]
    n = batch * config["num_agents"]
    chans = config["stage_channels"]
    sizes = stage_sizes(config)
    total, cin = 0, d
    for c, (rows, cols) in zip(chans, sizes):
        total += conv(3, cin, c, rows, cols, n) + conv(3, c, c, rows, cols, n)
        cin = c
    for i in range(len(chans) - 1):
        cout, (rows, cols) = chans[-2 - i], sizes[-2 - i]
        total += (conv(3, chans[-1 - i] + cout, cout, rows, cols, n)
                  + conv(3, cout, cout, rows, cols, n))
    k = len(config["anchors"]["sizes"])
    for out in (k * config["num_classes"], k * config["anchors"]["box_code_size"]):
        total += conv(3, chans[0], 32, h, w, n) + conv(1, 32, out, h, w, n)
    return total, conv(3, d, chans[0], h, w, n)
