"""A cell's weights, drawn from the seed on the device in one call.

One state dict in the port's state-dict names (the reference's module
names), loaded into the program and the reference alike. Each tensor is
drawn by the type of the module that holds it, n unit normal:

  * convolution kernels: He-normal, std sqrt(2 / fan_in), so that maps
    keep their scale through the ReLU stack at any depth; their biases:
    0.05 n;
  * BatchNorm: scale 1 + 0.1 n, shift 0.1 n, running mean 0.1 n and
    running variance exp(0.2 n), so that the inference path's
    normalization is not the identity; its counters: 0;
  * ``nn.Linear``: weight n / sqrt(in_features), so that a map keeps unit
    scale through it; bias 0.05 n;
  * ``nn.LayerNorm`` and ``nn.GroupNorm``: scale 1 + 0.1 n, shift 0.1 n,
    as BatchNorm's;
  * ``nn.Embedding``: n;
  * any other float parameter a module holds directly (an attention's
    relation matrices, a relative-position table): n / sqrt(shape[-1]).

The aim of the last four: behind a LayerNorm, a query and a key through
Linear maps and a relation table come out at unit scale, so attention
logits q W k / sqrt(d) have a std of about 1 and a configuration's
``correct`` sees its attention (at the conv rules' 0.05 they would sit
within a few per cent of uniform). A float buffer outside a norm layer
has no rule and raises: it is state the module computes, which belongs
outside the state dict (``persistent=False``).

Every float comes from one ``torch.randn`` of a ``torch.Generator`` on
the device, seeded with the run's seed, consumed in state-dict order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.nn.modules.conv import _ConvNd

Rule = Callable[[torch.Tensor], torch.Tensor]


def _norm_rule(leaf: str) -> Rule:
    if leaf == "weight":
        return lambda n: 1.0 + 0.1 * n
    if leaf == "running_var":
        return lambda n: torch.exp(0.2 * n)
    return lambda n: 0.1 * n  # bias, running_mean


def rule(module: nn.Module, leaf: str, shape: torch.Size, is_param: bool) -> Rule:
    """How the float tensor ``leaf`` of ``shape`` that ``module`` holds
    directly is drawn from unit normal n (see the module docstring)."""
    if isinstance(module, _ConvNd):
        if leaf == "weight":
            return lambda n: n * math.sqrt(2.0 / math.prod(shape[1:]))
        return lambda n: n * 0.05
    if isinstance(module, (_BatchNorm, nn.LayerNorm, nn.GroupNorm)):
        return _norm_rule(leaf)
    if not is_param:
        raise ValueError(f"no rule for the float buffer {leaf!r} of a {type(module).__name__}")
    if isinstance(module, nn.Linear):
        if leaf == "weight":
            return lambda n: n / math.sqrt(module.in_features)
        return lambda n: n * 0.05
    if isinstance(module, nn.Embedding):
        return lambda n: n
    return lambda n: n / math.sqrt(shape[-1])


def rules(model: nn.Module) -> Dict[str, Rule]:
    """Each float state-dict entry's rule, by its owning module's type."""
    out = {}
    for prefix, module in model.named_modules():
        held = [(k, v, True) for k, v in module.named_parameters(recurse=False)]
        held += [(k, v, False) for k, v in module.named_buffers(recurse=False)]
        for leaf, v, is_param in held:
            if v.is_floating_point():
                out[f"{prefix}.{leaf}" if prefix else leaf] = rule(module, leaf, v.shape, is_param)
    return out


def make_state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``model``'s names and shapes, drawn from ``seed``."""
    shapes = model.state_dict()
    drawn = rules(model)
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
        out[k] = drawn[k](n)
    return out
