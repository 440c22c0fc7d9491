"""BatchNorm + ReLU of bf16 maps: the wrapper of ``csrc/batchnorm.cu``,
its plain PyTorch version, and the autograd Function
``models/backbone.py`` calls in training. Inference that records no graph
calls the ``normalize_relu`` pass alone (``models/backbone.py::bn_relu``),
with the running mean for ``mean`` and ``weight * rsqrt(running_var +
eps)`` for ``inv``: one read and one write of the map where ATen's
inference BatchNorm and the in-place ReLU after it made two of each.

No TPU kernel is replaced: the JAX package's BatchNorm is flax's
``nn.BatchNorm`` under XLA, which fuses it there. In the port a bf16 map's
train-mode BatchNorm and ReLU ran as PyTorch operators in float32
(``models/backbone.py::_bn``, then ``torch.relu``); the kernel is bound by
bytes, and its four passes move 20 bytes an element where those operators
moved ~150 (the source's header has the design). The function is the same:
batch moments E[x] and E[x^2] in float32, averaged over a process group
when one is given; the biased variance clipped at 0; the running stats
updated as ``momentum * old + (1 - momentum) * batch``; ``y = relu(bf16((x
- mean) * inv + bias))`` with ``inv = weight * rsqrt(var + eps)``; and the
gradient of that graph in closed form:

    g  = dy where y > 0, else 0
    s1 = sum(g),  s2 = sum(g * (x - mean))       (summed over the group)
    dx = inv * ((g - s1 / n) - c2 * (x - mean)),  c2 = rsqrt(var+eps)^2 * s2 / n
         where E[x^2] - E[x]^2 >= 0 (the clip passes the gradient), else c2 = 0
    dweight = s2 * rsqrt(var + eps),  dbias = s1  (this rank's own sums)

with n the elements a channel over the group.

Four passes, each a wrapper with a plain version and a ``launches``
counter: ``moments``, ``normalize_relu``, ``backward_reduce``,
``backward_dx``. A CPU tensor goes to the plain version. A CUDA tensor
launches the kernel or raises: it must be a bf16 map in channels-last
memory, C a multiple of 8 from 8 to 2048, 16-byte aligned. ``BatchNormReLU``
puts a CUDA map and its gradient into channels-last memory before the
passes (a no-op for the conv outputs and gradients it meets). Saved for
the backward: the bf16 input and output (the output is the next conv's
saved input anyway) and (C,) vectors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from v2x_sim_tpu_torch.ops.cuda import build
from v2x_sim_tpu_torch.parallel.mesh import group_size, psum

#: The channel dims a map's statistics are taken over (NCHW).
DIMS = (0, 2, 3)
#: C must be a multiple of VEC (one 16-byte load of bf16), at most MAX_CHANNELS.
VEC, MAX_CHANNELS = 8, 2048
#: Bytes an element each pass moves (bf16 reads and writes).
PASS_BYTES = {"moments": 2, "normalize_relu": 4, "backward_reduce": 6, "backward_dx": 8}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = build.load("batchnorm")
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.v2x_bn_max_partials.argtypes = []
    lib.v2x_bn_max_partials.restype = ctypes.c_int
    lib.v2x_bn_moments.argtypes = [ptr, ptr, ptr, i64, i64, f32, ptr]
    lib.v2x_bn_moments.restype = ctypes.c_int
    lib.v2x_bn_normalize_relu.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
    lib.v2x_bn_normalize_relu.restype = ctypes.c_int
    lib.v2x_bn_backward_reduce.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
    lib.v2x_bn_backward_reduce.restype = ctypes.c_int
    lib.v2x_bn_backward_dx.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
    lib.v2x_bn_backward_dx.restype = ctypes.c_int
    return lib


def _check_map(t: torch.Tensor, name: str, c: int) -> None:
    """A CUDA operand map: bf16, (N, c, H, W) in channels-last memory, aligned."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[1] != c:
        raise ValueError(f"{name} must be (N, {c}, H, W), got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be channels-last in memory")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_vector(t: torch.Tensor, name: str, c: int) -> None:
    if t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned ({c},) float32 vector, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check(maps, vectors) -> Tuple[int, int]:
    """Checks a CUDA pass's operands; returns (rows, C)."""
    c = maps[0][1].shape[1] if maps[0][1].dim() == 4 else -1
    for name, t in maps:
        _check_map(t, name, c)
    if c % VEC or not VEC <= c <= MAX_CHANNELS:
        raise ValueError(f"the kernel takes C a multiple of {VEC} from {VEC} to {MAX_CHANNELS}, "
                         f"not {c}")
    rows = maps[0][1].numel() // c
    if rows == 0:
        raise ValueError("the kernel takes a map with at least one element a channel")
    for name, t in vectors:
        _check_vector(t, name, c)
    return rows, c


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _partials(x: torch.Tensor, c: int) -> torch.Tensor:
    return torch.empty(_lib().v2x_bn_max_partials() * 2 * c, dtype=torch.float32, device=x.device)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


# --------------------------------------------------------------------------
# The plain versions (NCHW maps of any layout).


def moments_plain(x: torch.Tensor) -> torch.Tensor:
    """(2, C) float32: E[x] and E[x^2] per channel."""
    xf = x.float()
    return torch.stack([xf.mean(DIMS), (xf * xf).mean(DIMS)])


def normalize_relu_plain(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """relu(bf16((x - mean) * inv + bias)), in float32 before the rounding."""
    return torch.relu(((x.float() - _col(mean)) * _col(inv) + _col(bias)).to(torch.bfloat16))


def _relu_grad(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """dy where y > 0, else 0, in float32 (ReLU's threshold_backward)."""
    return dy.float().masked_fill_(y <= 0, 0.0)


def backward_reduce_plain(dy: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                          mean: torch.Tensor) -> torch.Tensor:
    """(2, C) float32: sum(g) and sum(g * (x - mean)) per channel."""
    g = _relu_grad(dy, y)
    return torch.stack([g.sum(DIMS), (g * (x.float() - _col(mean))).sum(DIMS)])


def backward_dx_plain(dy: torch.Tensor, y: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """bf16(inv * ((g - c1) - c2 * (x - mean)))."""
    g = _relu_grad(dy, y)
    xc = x.float() - _col(mean)
    return (((g - _col(c1)) - _col(c2) * xc) * _col(inv)).to(torch.bfloat16)


# --------------------------------------------------------------------------
# The wrappers.


def moments(x: torch.Tensor) -> torch.Tensor:
    """(2, C) float32: E[x] and E[x^2] of a bf16 map per channel."""
    if build.on_cpu(x):
        return moments_plain(x)
    rows, c = _check([("x", x)], [])
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().v2x_bn_moments(x.data_ptr(), _partials(x, c).data_ptr(), out.data_ptr(),
                                   rows, c, float(rows), _stream(x))
    build.raise_on_error(rc, "bn moments")
    moments.launches += 1
    return out


moments.launches = 0


def normalize_relu(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """relu(bf16((x - mean) * inv + bias)) of a bf16 map; (C,) float32 vectors."""
    if build.on_cpu(x, mean, inv, bias):
        return normalize_relu_plain(x, mean, inv, bias)
    rows, c = _check([("x", x)], [("mean", mean), ("inv", inv), ("bias", bias)])
    y = torch.empty_like(x, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        rc = _lib().v2x_bn_normalize_relu(x.data_ptr(), y.data_ptr(), mean.data_ptr(),
                                          inv.data_ptr(), bias.data_ptr(), rows, c, _stream(x))
    build.raise_on_error(rc, "bn normalize_relu")
    normalize_relu.launches += 1
    return y


normalize_relu.launches = 0


def backward_reduce(dy: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                    mean: torch.Tensor) -> torch.Tensor:
    """(2, C) float32: sum(g) and sum(g * (x - mean)), g = dy where y > 0."""
    if build.on_cpu(dy, y, x, mean):
        return backward_reduce_plain(dy, y, x, mean)
    rows, c = _check([("x", x), ("dy", dy), ("y", y)], [("mean", mean)])
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().v2x_bn_backward_reduce(dy.data_ptr(), y.data_ptr(), x.data_ptr(),
                                           mean.data_ptr(), _partials(x, c).data_ptr(),
                                           out.data_ptr(), rows, c, _stream(x))
    build.raise_on_error(rc, "bn backward_reduce")
    backward_reduce.launches += 1
    return out


backward_reduce.launches = 0


def backward_dx(dy: torch.Tensor, y: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """bf16(inv * ((g - c1) - c2 * (x - mean))), g = dy where y > 0."""
    if build.on_cpu(dy, y, x, mean, inv, c1, c2):
        return backward_dx_plain(dy, y, x, mean, inv, c1, c2)
    rows, c = _check([("x", x), ("dy", dy), ("y", y)],
                     [("mean", mean), ("inv", inv), ("c1", c1), ("c2", c2)])
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        rc = _lib().v2x_bn_backward_dx(dy.data_ptr(), y.data_ptr(), x.data_ptr(), mean.data_ptr(),
                                       inv.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                                       dx.data_ptr(), rows, c, _stream(x))
    build.raise_on_error(rc, "bn backward_dx")
    backward_dx.launches += 1
    return dx


backward_dx.launches = 0

WRAPPERS = (moments, normalize_relu, backward_reduce, backward_dx)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict:
    """Each wrapper's launch count, by name."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}


# --------------------------------------------------------------------------
# The Function.


def _layout(t: torch.Tensor) -> torch.Tensor:
    """A CUDA map in channels-last memory (a no-op where it is already)."""
    return t.contiguous(memory_format=torch.channels_last) if t.is_cuda else t


class BatchNormReLU(torch.autograd.Function):
    """relu(BatchNorm(x)) of a bf16 map in training, through the four passes."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps: float, momentum: float,
                group):
        x = _layout(x)
        stats = moments(x)
        if group is not None:
            stats = psum(stats, group) / group_size(group)
        mean, msq = stats.unbind()
        centred = msq - mean * mean
        var = centred.clamp(min=0.0)
        running_mean.mul_(momentum).add_((1 - momentum) * mean)
        running_var.mul_(momentum).add_((1 - momentum) * var)
        rstd = torch.rsqrt(var + eps)
        inv = weight * rstd
        y = normalize_relu(x, mean, inv, bias.detach())
        ctx.save_for_backward(x, y, mean, inv, rstd, centred >= 0)
        ctx.group = group
        ctx.count = (x.numel() // x.shape[1]) * group_size(group)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, y, mean, inv, rstd, passes = ctx.saved_tensors
        dy = _layout(dy)
        sums = backward_reduce(dy, y, x, mean)
        dweight, dbias = sums[1] * rstd, sums[0]
        if ctx.group is not None:
            sums = psum(sums, ctx.group)
        s1, s2 = sums.unbind()
        c1 = s1 / ctx.count
        c2 = torch.where(passes, rstd * rstd * s2 / ctx.count, 0.0)
        dx = backward_dx(dy, y, x, mean, inv, c1, c2)
        return dx, dweight, dbias, None, None, None, None, None


def batch_norm_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                    momentum: float, group=None) -> torch.Tensor:
    """relu of train-mode BatchNorm of a bf16 NCHW map, its moments averaged
    over ``group`` (a group or a sequence of groups, ``mesh.group_list``),
    updating the running stats in place."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused BatchNorm takes bfloat16 maps, got {x.dtype}")
    return BatchNormReLU.apply(x, weight, bias, running_mean, running_var, eps, momentum, group)
