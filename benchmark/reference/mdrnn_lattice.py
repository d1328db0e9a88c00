"""The positive 2D RNN wavefunction on an Nx x Ny lattice (Hibat-Allah et
al., PRR 2, 023358 (2020), Sec. II.C): sites visited row by row, left to
right on even rows y and right to left on odd rows; each site's state

    h = elu(x_h Uh + x_v Uv + h_h Wh + h_v Wv + b)

takes the one-hot spin and state of its horizontal predecessor in visit
order and of its neighbour in the row above (zero inputs and states off
the lattice), and p(sigma_site | earlier) = softmax(h W + b).

Parameters are a dict of float32 tensors (float64 for the round-off
witness): ``cell.uh``, ``cell.uv`` (2, U), ``cell.wh``, ``cell.wv`` (U, U),
``cell.b`` (U), ``head.w`` (U, 2), ``head.b`` (2).  Samples are (S, Nx, Ny)
integer spins indexed [s, x, y].
"""

from __future__ import annotations

from typing import Dict

import torch

from . import FP32, Precision


def log_prob(params: Dict[str, torch.Tensor], samples: torch.Tensor,
             precision: Precision = FP32) -> torch.Tensor:
    """(S, Nx, Ny) samples -> (S,) float64 log p, the site terms in the
    parameters' dtype."""
    mm = precision.mm
    uh, uv, wh, wv, b = (params[f"cell.{k}"] for k in ("uh", "uv", "wh", "wv", "b"))
    hw, hb = params["head.w"], params["head.b"]
    s, nx, ny = samples.shape
    u = wh.shape[0]
    dev = samples.device
    spins = samples.long()
    zero_h = torch.zeros(s, u, dtype=wh.dtype, device=dev)
    zero_x = torch.zeros(s, 2, dtype=wh.dtype, device=dev)
    above_h, above_x = [zero_h] * nx, [zero_x] * nx
    total = torch.zeros(s, dtype=torch.float64, device=dev)
    for y in range(ny):
        h_h, x_h = zero_h, zero_x
        for x in (range(nx) if y % 2 == 0 else range(nx - 1, -1, -1)):
            pre = mm(x_h, uh) + mm(above_x[x], uv) + mm(h_h, wh) + mm(above_h[x], wv) + b
            h = torch.nn.functional.elu(pre)
            logp = torch.log_softmax(mm(h, hw) + hb, dim=-1)
            spin = spins[:, x, y]
            total = total + logp.gather(1, spin[:, None])[:, 0].double()
            h_h, x_h = h, torch.nn.functional.one_hot(spin, 2).to(wh.dtype)
            above_h[x], above_x[x] = h_h, x_h
    return total
