"""The STPN decoder's stage input of bf16 maps, ``cat([upsample(x), skip])``
with a 2x bilinear upsample: the wrapper of ``csrc/upsample.cu``, its plain
PyTorch version, and the autograd Function ``models/backbone.py`` calls.

No TPU kernel is replaced: the JAX package resizes with
``jax.image.resize`` and concatenates under XLA, which fuses them there. In
the port a bf16 stage input ran as PyTorch operators
(``models/backbone.py::upsample_bilinear``'s two interpolate passes, then
``torch.cat``); the kernel is bound by bytes and moves each once (the
source's header has the design). The function is the same: at scale 2,
``align_corners=False`` reads output row 2k from rows k - 1 and k with the
weights 0.25 and 0.75 and row 2k + 1 from rows k and k + 1 with 0.75 and
0.25, the neighbour clamped to the map; rows are resized and rounded to
bf16, then columns, each pass a float32 sum rounded once, which gives
interpolate's bits. The gradient is that map's transpose, columns first,
each pass a float32 sum of four products in a fixed order rounded once to
bf16; the skip's gradient is the slice of the concatenation's gradient
after the first C channels, as ``cat``'s backward gives it.

Two entries, each a wrapper with a plain version and a ``launches``
counter: ``forward`` and ``backward``. The forward takes bf16 maps only.
A CPU tensor goes to the plain version. A CUDA tensor launches the kernel or raises: bf16 maps in
channels-last memory, 16-byte aligned, C and Cs multiples of 8, the skip
exactly twice x's size. ``UpsampleCat`` puts a CUDA map and its gradient
into channels-last memory before the entries (a no-op for the conv
outputs and gradients it meets) and saves nothing but C.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from v2x_sim_tpu_torch.ops.cuda import build

#: C and Cs must be multiples of VEC (one 16-byte load of bf16).
VEC = 8
#: bf16 elements each entry moves an element of x, its byte bound: the
#: forward reads x (1), writes the upsampled channels (4), reads and writes
#: the skip (2 + 2, for Cs = C / 2 as in the decoder); the backward reads
#: the 4 output gradients and writes dx.
PASS_ELEMENTS = {"forward": 9, "backward": 5}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = build.load("upsample")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.v2x_upsample_cat_forward.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.v2x_upsample_cat_forward.restype = ctypes.c_int
    lib.v2x_upsample_cat_backward.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr]
    lib.v2x_upsample_cat_backward.restype = ctypes.c_int
    return lib


def _check_map(t: torch.Tensor, name: str) -> None:
    """A CUDA operand map: bf16, 4-d in channels-last memory, aligned, C a
    multiple of VEC."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[1] % VEC or t.shape[1] == 0 or t.numel() == 0:
        raise ValueError(f"{name} must be (N, C, H, W) with C a multiple of {VEC}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be channels-last in memory")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_doubles(x: torch.Tensor, skip: torch.Tensor) -> None:
    n, _, h, w = x.shape
    if skip.dim() != 4 or (skip.shape[0], *skip.shape[2:]) != (n, 2 * h, 2 * w):
        raise ValueError(f"the skip must be (N, Cs, 2H, 2W) of x {tuple(x.shape)}, got "
                         f"{tuple(skip.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------
# The plain versions (NCHW maps of any layout).


def _along(t: torch.Tensor, dim: int, index) -> torch.Tensor:
    return t.index_select(dim, torch.as_tensor(index, device=t.device))


def _up2(t: torch.Tensor, dim: int) -> torch.Tensor:
    """bf16 of ``t`` (float32 holding bf16 values) upsampled 2x along
    ``dim``: row 2k = 0.25 t[k - 1] + 0.75 t[k], row 2k + 1 = 0.75 t[k] +
    0.25 t[k + 1], the neighbour clamped; one float32 rounding, then bf16."""
    n = t.shape[dim]
    k = torch.arange(n)
    even = 0.25 * _along(t, dim, (k - 1).clamp(min=0)) + 0.75 * t
    odd = 0.75 * t + 0.25 * _along(t, dim, (k + 1).clamp(max=n - 1))
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1).to(torch.bfloat16)


def _up2_transpose(t: torch.Tensor, dim: int) -> torch.Tensor:
    """bf16 of :func:`_up2`'s transpose along ``dim`` (2n rows of float32
    in, n out): row k = ((0.25 t[2k - 1] + 0.75 t[2k]) + 0.75 t[2k + 1]) +
    0.25 t[2k + 2], the outer rows clamped, summed in float32 in that order."""
    m = t.shape[dim]
    k = torch.arange(m // 2)
    s = 0.25 * _along(t, dim, (2 * k - 1).clamp(min=0)) + 0.75 * _along(t, dim, 2 * k)
    s = s + 0.75 * _along(t, dim, 2 * k + 1)
    s = s + 0.25 * _along(t, dim, (2 * k + 2).clamp(max=m - 1))
    return s.to(torch.bfloat16)


def forward_plain(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """cat([the 2x bilinear upsample of x, rows then columns, each rounded
    to bf16], skip) along channels, in channels-last memory."""
    n, c, h, w = x.shape
    out = torch.empty((n, c + skip.shape[1], 2 * h, 2 * w), dtype=torch.bfloat16,
                      device=x.device, memory_format=torch.channels_last)
    out[:, :c] = _up2(_up2(x.float(), 2).float(), 3)
    out[:, c:] = skip
    return out


def backward_plain(dy: torch.Tensor, c: int) -> torch.Tensor:
    """The gradient of x from the concatenation's gradient ``dy``: the
    upsample's transpose of its first ``c`` channels, columns then rows,
    each pass rounded to bf16, in channels-last memory."""
    d = _up2_transpose(_up2_transpose(dy[:, :c].float(), 3).float(), 2)
    return d.contiguous(memory_format=torch.channels_last)


# --------------------------------------------------------------------------
# The wrappers.


def forward(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """cat([upsample(x), skip]) of bf16 maps, x (N, C, H, W), skip (N, Cs,
    2H, 2W): (N, C + Cs, 2H, 2W) in channels-last memory."""
    if x.dtype != torch.bfloat16 or skip.dtype != torch.bfloat16:
        raise TypeError(f"the fused upsample takes bfloat16 maps, got {x.dtype} and {skip.dtype}")
    _check_doubles(x, skip)
    if build.on_cpu(x, skip):
        return forward_plain(x, skip)
    _check_map(x, "x")
    _check_map(skip, "skip")
    n, c, h, w = x.shape
    out = torch.empty((n, c + skip.shape[1], 2 * h, 2 * w), dtype=torch.bfloat16,
                      device=x.device, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        rc = _lib().v2x_upsample_cat_forward(x.data_ptr(), skip.data_ptr(), out.data_ptr(), n, h,
                                             w, c, skip.shape[1], _stream(x))
    build.raise_on_error(rc, "upsample_cat forward")
    forward.launches += 1
    return out


forward.launches = 0


def backward(dy: torch.Tensor, c: int) -> torch.Tensor:
    """dx (N, c, H, W) of the concatenation's bf16 gradient dy (N, c + Cs,
    2H, 2W), read from its first ``c`` channels where they lie."""
    if build.on_cpu(dy):
        return backward_plain(dy, c)
    _check_map(dy, "dy")
    n, cy, h2, w2 = dy.shape
    if c % VEC or not 0 < c < cy or h2 % 2 or w2 % 2:
        raise ValueError(f"the kernel takes c a multiple of {VEC} below dy's {cy} channels and "
                         f"an even size, not c {c} of {tuple(dy.shape)}")
    dx = torch.empty((n, c, h2 // 2, w2 // 2), dtype=torch.bfloat16, device=dy.device,
                     memory_format=torch.channels_last)
    with torch.cuda.device(dy.device):
        rc = _lib().v2x_upsample_cat_backward(dy.data_ptr(), dx.data_ptr(), n, h2 // 2, w2 // 2,
                                              c, cy, _stream(dy))
    build.raise_on_error(rc, "upsample_cat backward")
    backward.launches += 1
    return dx


backward.launches = 0

WRAPPERS = (forward, backward)


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


class UpsampleCat(torch.autograd.Function):
    """cat([upsample(x), skip]) of bf16 maps through the two entries."""

    @staticmethod
    def forward(ctx, x, skip):
        ctx.c = x.shape[1]
        return forward(_layout(x), _layout(skip))  # the module's wrappers, by name

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        dy = _layout(dy)
        dx = backward(dy, ctx.c) if ctx.needs_input_grad[0] else None
        return dx, dy[:, ctx.c:]
