"""A cell's weights, drawn from the seed on the device in one call.

One state dict in the port's state-dict names (the reference's module
names), loaded into the program and the reference alike:

  * convolution kernels: He-normal, std sqrt(2 / fan_in), so that maps
    keep their scale through the ReLU stack at any depth;
  * convolution biases: normal, std 0.05;
  * BatchNorm: scale 1 + 0.1 n, shift 0.1 n, running mean 0.1 n and
    running variance exp(0.2 n), with n unit normal, so that the
    inference path's normalization is not the identity;
  * the counters BatchNorm keeps: 0.

Every float comes from one ``torch.randn`` of a ``torch.Generator`` on
the device, seeded with the run's seed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn


def make_state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model``'s names and shapes, drawn from ``seed``."""
    shapes = {k: v for k, v in model.state_dict().items()}
    floats = [k for k, v in shapes.items() if v.is_floating_point()]
    total = sum(shapes[k].numel() for k in floats)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, v in shapes.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        n = draw[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
        leaf = k.rsplit(".", 1)[-1]
        if v.dim() == 4:
            out[k] = n * math.sqrt(2.0 / v[0].numel())
        elif ".bn" not in k:
            out[k] = n * 0.05  # a convolution's bias
        elif leaf == "weight":
            out[k] = 1.0 + 0.1 * n
        elif leaf == "running_var":
            out[k] = torch.exp(0.2 * n)
        else:  # bias, running_mean
            out[k] = 0.1 * n
    return out
