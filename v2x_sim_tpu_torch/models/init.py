"""Fresh weights drawn as flax's default initializers draw them.

The JAX package's models set no ``kernel_init`` or ``bias_init``, so a
fresh flax model has LeCun-normal kernels (a normal truncated at two
standard deviations, rescaled to variance 1/fan_in, fan_in = kh*kw*in for
a conv and in for a Dense layer), zero biases, unit norm scales with zero
shifts, and BatchNorm running statistics at 0 and 1. PyTorch's defaults
differ (kaiming-uniform kernels of variance 1/(3 fan_in), nonzero
uniform biases), so a model trained from scratch would start elsewhere.

``init_flax_defaults_`` gives every parameter of a model flax's
distribution, drawn on the CPU from a seeded ``torch.Generator`` (the
same distribution, not the same draws as ``jax.random``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

#: Standard deviation of a unit normal truncated to [-2, 2]: dividing by it
#: restores unit variance (jax.nn.initializers.variance_scaling's constant).
TRUNC_STD = 0.87962566103423978


def truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """float32 samples of a normal truncated at +-2 sigma and rescaled so
    that their standard deviation is ``std``; by the inverse CDF, as
    ``jax.random.truncated_normal``."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(u)
    return (z.clamp(-2.0, 2.0) * (std / TRUNC_STD)).to(torch.float32)


@torch.no_grad()
def init_flax_defaults_(model: nn.Module, seed: int) -> nn.Module:
    """Re-draw every parameter and buffer of ``model`` (convs, Linear,
    BatchNorm, GroupNorm) in place as flax's defaults would. Returns it."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.modules.conv._ConvNd, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()  # in * kernel size, for (out, in, *kernel) and (out, in)
            w.copy_(truncated_normal(w.shape, 1.0 / math.sqrt(fan_in), gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.modules.batchnorm._BatchNorm, nn.GroupNorm)):
            if mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            if getattr(mod, "running_mean", None) is not None:
                mod.reset_running_stats()
    return model
