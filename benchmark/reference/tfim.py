"""The transverse-field Ising model with open boundaries on a chain or a
rectangular lattice,

    H = -Jz sum_<ij> sigma^z_i sigma^z_j  -  Bx sum_i sigma^x_i,

and its local energies by explicit flips: E_loc(s) = diag(s) - Bx sum_i
psi(s with site i flipped) / psi(s), with psi = sqrt(p) for a positive
wavefunction, each flipped configuration's log p evaluated in full.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

import torch

from . import FP32, Precision

# flipped configurations evaluated in one batch: bounds the memory
ROWS_PER_BLOCK = 1 << 18


def diagonal(samples: torch.Tensor, jz: float) -> torch.Tensor:
    """(S, *lattice) spins -> (S,) float64: -Jz times the sum of z_i z_j
    over nearest neighbours along every lattice axis."""
    z = (2 * samples.long() - 1).to(torch.float64)
    total = torch.zeros(samples.shape[0], dtype=torch.float64, device=samples.device)
    for axis in range(1, samples.dim()):
        n = samples.shape[axis]
        total = total + (z.narrow(axis, 0, n - 1) * z.narrow(axis, 1, n - 1)).flatten(1).sum(1)
    return -jz * total


def local_energy(model: ModuleType, params: Dict[str, torch.Tensor], samples: torch.Tensor,
                 terms: Dict, precision: Precision = FP32):
    """(E_loc (S,) float64, log p (S,) float64) of positive-wavefunction
    samples; ``model.log_prob(params, samples, precision)`` is the model's,
    ``terms["bx"]`` and ``terms["jz"]`` the couplings."""
    bx, jz = terms["bx"], terms["jz"]
    lp = model.log_prob(params, samples, precision)
    s = samples.shape[0]
    flat = samples.reshape(s, -1)
    sites = flat.shape[1]
    eye = torch.eye(sites, dtype=torch.bool, device=samples.device)
    ratio = torch.zeros(s, dtype=torch.float64, device=samples.device)
    step = max(1, ROWS_PER_BLOCK // sites)
    for lo in range(0, s, step):
        block = flat[lo:lo + step]
        flips = torch.where(eye, 1 - block[:, None, :], block[:, None, :])
        lpf = model.log_prob(params, flips.reshape((-1,) + tuple(samples.shape[1:])), precision)
        lpf = lpf.reshape(block.shape[0], sites)
        ratio[lo:lo + step] = torch.exp(0.5 * (lpf - lp[lo:lo + step, None])).sum(1)
    return diagonal(samples, jz) - bx * ratio, lp
