"""Convolutional RNN cells and a sequence wrapper (1d/2d/3d, RNN/GRU/LSTM).

Port of ``v2x_sim_tpu/models/convrnn.py``. Tensors are channel-last,
(B, *spatial, C), as in the JAX package, and any extra leading dims are
batch dims, as in flax; each conv runs on a channels-first view. Every
gate group is one conv with bias, flax's ``SAME`` padding and stride 1;
flax names the convs ``gate``, ``gates`` and ``candidate``, and the
wrapper's cells ``l{layer}_d{direction}``, and so does the port.

PyTorch needs each conv's input width when it is built, so every cell
takes ``input_features`` beside ``features``. The JAX GRU cell's
``sow("diagnostics")`` tap is :func:`gru_diagnostics`: inside it, each
GRU step of a model records its gate statistics (``GRU_STATS``); outside
it, the cell computes none.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

_CONV = {1: (nn.Conv1d, F.conv1d), 2: (nn.Conv2d, F.conv2d), 3: (nn.Conv3d, F.conv3d)}


def _kernel(ndim: int, kernel: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    k = (kernel,) * ndim if isinstance(kernel, int) else tuple(kernel)
    if len(k) != ndim:
        raise ValueError(f"kernel {k} does not match ndim={ndim}")
    return k


def same_conv(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """A stride-1 conv of a channel-last (..., *spatial, C) map with flax's
    ``SAME`` padding (for an even kernel, the extra pad goes after), params
    cast to the activation dtype; channel-last out. Leading dims are batch
    dims, as in flax. In bf16 the bias is added to the rounded conv output,
    as flax adds it (in place: no second output map)."""
    k = conv.weight.shape[2:]
    ndim = len(k)
    lead = x.shape[: x.dim() - ndim - 1]
    xc = x.reshape((-1,) + tuple(x.shape[len(lead):])).movedim(-1, 1)
    if all(s % 2 for s in k):
        pad = tuple(s // 2 for s in k)
    else:
        xc = F.pad(xc, [p for s in reversed(k) for p in ((s - 1) // 2, s // 2)])
        pad = 0
    bias = conv.bias.to(x.dtype)
    if x.dtype == torch.bfloat16:
        y = _CONV[ndim][1](xc, conv.weight.to(x.dtype), None, 1, pad)
        y.add_(bias.reshape((-1,) + (1,) * ndim))
    else:
        y = _CONV[ndim][1](xc, conv.weight.to(x.dtype), bias, 1, pad)
    return y.movedim(1, -1).reshape(lead + tuple(y.shape[2:]) + (y.shape[1],))


class ConvRNNCellBase(nn.Module):
    """Shared config: ``features`` hidden channels, ``input_features`` input
    channels, spatial rank ``ndim`` (1, 2 or 3), ``kernel`` size."""

    def __init__(self, features: int, input_features: int, ndim: int = 2,
                 kernel: Union[int, Sequence[int]] = 3):
        super().__init__()
        if ndim not in _CONV:
            raise ValueError(f"ndim must be 1, 2 or 3, got {ndim}")
        self.features = features
        self.ndim = ndim
        self.kernel = _kernel(ndim, kernel)
        self._in = features + input_features

    def _conv(self, out: int) -> nn.Module:
        """A conv from [h, x] to ``out`` channels."""
        return _CONV[self.ndim][0](self._in, out, self.kernel)

    def init_state(self, batch_spatial: Sequence[int], dtype=torch.float32, device=None) -> Any:
        """Zero hidden state for an input of shape (B, *spatial, C)."""
        return torch.zeros(tuple(batch_spatial) + (self.features,), dtype=dtype, device=device)


class ConvRNNCell(ConvRNNCellBase):
    """Vanilla step: h' = act(conv([h, x])), act ``tanh`` or ``relu``."""

    def __init__(self, features: int, input_features: int, ndim: int = 2,
                 kernel: Union[int, Sequence[int]] = 3, nonlinearity: str = "tanh"):
        super().__init__(features, input_features, ndim, kernel)
        if nonlinearity not in ("tanh", "relu"):
            raise ValueError(f"nonlinearity must be tanh or relu, got {nonlinearity!r}")
        self.nonlinearity = nonlinearity
        self.gate = self._conv(features)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        act = torch.tanh if self.nonlinearity == "tanh" else torch.relu
        return act(same_conv(torch.cat([h, x], dim=-1), self.gate))


#: The gate statistics a GRU step records under :func:`gru_diagnostics`,
#: in order: the update gate's mean and its shares above 0.99 and below
#: 0.01, the reset gate's mean, the mean |tanh(candidate)|, |h| and |x|.
GRU_STATS = ("z_mean", "z_sat_hi", "z_sat_lo", "r_mean", "|tanh(cand)|", "|h|", "|x|")


class ConvGRUCell(ConvRNNCellBase):
    """GRU step (the cell of V2VNet's rounds): ``gates`` gives (z, r), z
    first; ``candidate`` reads ``[r * h, x]``; h' = (1 - z) h + z tanh(cand)."""

    def __init__(self, features: int, input_features: int, ndim: int = 2,
                 kernel: Union[int, Sequence[int]] = 3):
        super().__init__(features, input_features, ndim, kernel)
        self.gates = self._conv(2 * features)
        self.candidate = self._conv(features)
        #: Where :func:`gru_diagnostics` collects this cell's statistics.
        self.diagnostics: Optional[List[torch.Tensor]] = None

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        zr = torch.sigmoid(same_conv(torch.cat([h, x], dim=-1), self.gates))
        z, r = zr.split(self.features, dim=-1)
        cand = same_conv(torch.cat([r * h, x], dim=-1), self.candidate)
        if self.diagnostics is not None:
            self.diagnostics.append(_gru_stats(z, r, cand, h, x))
        return (1.0 - z) * h + z * torch.tanh(cand)


@torch.no_grad()
def _gru_stats(z, r, cand, h, x) -> torch.Tensor:
    """The (7,) float32 ``GRU_STATS`` of one GRU step."""
    z = z.float()
    return torch.stack([
        z.mean(), (z > 0.99).float().mean(), (z < 0.01).float().mean(), r.float().mean(),
        torch.tanh(cand).float().abs().mean(), h.float().abs().mean(), x.float().abs().mean(),
    ])


@contextlib.contextmanager
def gru_diagnostics(model: nn.Module) -> Iterator[List[torch.Tensor]]:
    """Record the gate statistics of every ConvGRUCell step ``model`` runs
    inside the block: yields a list that gains one (7,) float32 row of
    ``GRU_STATS`` a step, in call order (one a round for V2VNet)."""
    rows: List[torch.Tensor] = []
    cells = [m for m in model.modules() if isinstance(m, ConvGRUCell)]
    for cell in cells:
        cell.diagnostics = rows
    try:
        yield rows
    finally:
        for cell in cells:
            cell.diagnostics = None


class ConvLSTMCell(ConvRNNCellBase):
    """LSTM step; state (h, c); the gates (i, f, g, o) from one conv."""

    def __init__(self, features: int, input_features: int, ndim: int = 2,
                 kernel: Union[int, Sequence[int]] = 3):
        super().__init__(features, input_features, ndim, kernel)
        self.gates = self._conv(4 * features)

    def forward(self, state: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor):
        h, c = state
        i, f, g, o = same_conv(torch.cat([h, x], dim=-1), self.gates).chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c2), c2

    def init_state(self, batch_spatial, dtype=torch.float32, device=None):
        z = super().init_state(batch_spatial, dtype, device)
        return z, z


_CELLS = {"rnn": ConvRNNCell, "gru": ConvGRUCell, "lstm": ConvLSTMCell}


class ConvRNN(nn.Module):
    """Multi-layer, optionally bidirectional convolutional RNN over a
    sequence: (B, T, *spatial, C_in) -> ((B, T, *spatial, H), final states),
    H = features * (2 if bidirectional else 1), one final state per layer
    and direction (an (h, c) pair for the LSTM). The time loop is a plain
    Python loop; the reverse direction runs over the flipped sequence and
    its outputs are flipped back."""

    def __init__(self, features: int, input_features: int, cell: str = "gru", ndim: int = 2,
                 kernel: Union[int, Sequence[int]] = 3, num_layers: int = 1,
                 bidirectional: bool = False, nonlinearity: str = "tanh"):
        super().__init__()
        if cell not in _CELLS:
            raise ValueError(f"cell must be one of {sorted(_CELLS)}, got {cell!r}")
        self.ndim = ndim
        self.num_layers = num_layers
        self.dirs = 2 if bidirectional else 1
        kw = {"nonlinearity": nonlinearity} if cell == "rnn" else {}
        cells = {}
        cin = input_features
        for layer in range(num_layers):
            for d in range(self.dirs):
                cells[f"l{layer}_d{d}"] = _CELLS[cell](features, cin, ndim, kernel, **kw)
            cin = features * self.dirs
        self.cells = nn.ModuleDict(cells)

    def forward(self, x: torch.Tensor, initial_state: Optional[Sequence[Any]] = None):
        if x.dim() != self.ndim + 3:
            raise ValueError(f"expected (B, T, *{self.ndim} spatial, C), got {tuple(x.shape)}")
        batch_spatial = (x.shape[0],) + tuple(x.shape[2:-1])
        states_out = []
        seq = x
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.dirs):
                idx = layer * self.dirs + d
                cell = self.cells[f"l{layer}_d{d}"]
                state = (initial_state[idx] if initial_state is not None
                         else cell.init_state(batch_spatial, x.dtype, x.device))
                inp = seq.flip(1) if d == 1 else seq
                ys = []
                for t in range(inp.shape[1]):
                    state = cell(state, inp[:, t])
                    ys.append(state[0] if isinstance(state, tuple) else state)
                ys = torch.stack(ys, dim=1)
                outs.append(ys.flip(1) if d == 1 else ys)
                states_out.append(state)
            seq = torch.cat(outs, dim=-1) if self.dirs == 2 else outs[0]
        return seq, tuple(states_out)
