"""Recurrent cells and the dense head as ``nn.Module``s.

Counterpart of ``rnnwavefunctions_tpu/models/cells.py`` (the GRU and the 2D
MDRNN cell for now).  The stored tensors keep the JAX package's layout,
contraction dimension first: ``wx (in, 3U)``, ``wh (U, 3U)``, gates packed
``[r | z | c]``; the MDRNN's ``uh, uv (in, U)``, ``wh, wv (U, U)``; head
``w (U, out)``, so parameters pass between the two packages unchanged
(``interop.py``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn


@torch.no_grad()
def glorot_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Xavier/Glorot uniform in place, drawn on the CPU from ``generator``
    (TF's default dense initializer, as in the JAX package)."""
    fan_in, fan_out = w.shape[0], w.shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    draw = torch.empty(w.shape, dtype=w.dtype).uniform_(
        -limit, limit, generator=generator
    )
    return w.copy_(draw)


class GRUCell(nn.Module):
    """cuDNN-compatible ("reset-after") GRU layer:

        r = sigmoid(x Wr + br_x + h Ur + br_h)
        z = sigmoid(x Wz + bz_x + h Uz + bz_h)
        c = tanh  (x Wc + bc_x + r * (h Uc + bc_h))
        h' = z * h + (1 - z) * c
    """

    def __init__(self, input_dim: int, units: int):
        super().__init__()
        self.units = units
        self.wx = nn.Parameter(torch.zeros(input_dim, 3 * units))
        self.wh = nn.Parameter(torch.zeros(units, 3 * units))
        self.bx = nn.Parameter(torch.zeros(3 * units))
        self.bh = nn.Parameter(torch.zeros(3 * units))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        glorot_(self.wx, generator)
        glorot_(self.wh, generator)
        self.bx.zero_()
        self.bh.zero_()

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        u = self.units
        gx = x @ self.wx + self.bx
        gh = h @ self.wh + self.bh
        r = torch.sigmoid(gx[..., :u] + gh[..., :u])
        z = torch.sigmoid(gx[..., u : 2 * u] + gh[..., u : 2 * u])
        c = torch.tanh(gx[..., 2 * u :] + r * gh[..., 2 * u :])
        return z * h + (1.0 - z) * c


class MDRNNCell(nn.Module):
    """The 2D cell (two-neighbour vanilla RNN) of the MDRNN:

        h = elu(x_h Uh + x_v Uv + h_h Wh + h_v Wv + b)

    with the one-hot spins ``x_h``/``x_v`` and cell outputs ``h_h``/``h_v``
    of the horizontal and vertical neighbours (output == state)."""

    def __init__(self, input_dim: int, units: int):
        super().__init__()
        self.units = units
        self.uh = nn.Parameter(torch.zeros(input_dim, units))  # horizontal input
        self.uv = nn.Parameter(torch.zeros(input_dim, units))  # vertical input
        self.wh = nn.Parameter(torch.zeros(units, units))      # horizontal state
        self.wv = nn.Parameter(torch.zeros(units, units))      # vertical state
        self.b = nn.Parameter(torch.zeros(units))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot on the four matrices, zero bias (``mdrnn_init``)."""
        for w in (self.uh, self.uv, self.wh, self.wv):
            glorot_(w, generator)
        self.b.zero_()

    def forward(self, xh: torch.Tensor, xv: torch.Tensor, hh: torch.Tensor,
                hv: torch.Tensor) -> torch.Tensor:
        pre = xh @ self.uh + xv @ self.uv + hh @ self.wh + hv @ self.wv + self.b
        return nn.functional.elu(pre)


class Dense(nn.Module):
    """Affine output head ``x @ w + b``."""

    def __init__(self, input_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(input_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        glorot_(self.w, generator)
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def stacked_rnn_apply(layers: Sequence[GRUCell], x: torch.Tensor,
                      states: Tuple[torch.Tensor, ...]):
    """Apply the stack; returns (top output, new per-layer states)."""
    new_states = []
    inp = x
    for layer, h in zip(layers, states):
        inp = layer(inp, h)
        new_states.append(inp)
    return inp, tuple(new_states)


def stacked_rnn_zero_state(batch: int, units: Sequence[int], device,
                           dtype=torch.float32) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.zeros(batch, u, dtype=dtype, device=device) for u in units)
