"""The J1-J2 Heisenberg chain with open boundaries (the paper's
``J1J2/TrainingRNN_J1J2.py``, ``J1J2MatrixElements`` at lines 12-93),

    H = J1 sum_i S_i . S_{i+1}  +  J2 sum_i S_i . S_{i+2}  +  Bz sum_i S^z_i,

S = sigma / 2, and its complex local energies by explicit exchanges:
E_loc(s) = diag(s) + sum over the anti-aligned pairs k of
el_k psi(s with pair k exchanged) / psi(s), with

* diag(s): +J1/4 for each aligned and -J1/4 for each anti-aligned
  nearest-neighbour (NN) pair, the same with J2/4 for next-nearest (NNN)
  pairs, and Bz (s_i - 1/2) for each site;
* el_k: -J1/2 for an NN pair under the Marshall sign rotation, else +J1/2;
  +J2/2 for an NNN pair.

Each exchanged configuration's log psi is evaluated in full by the model
(``log_psi``), in blocks of rows.  The paper's code passes its Marshall
flag into the ``periodic`` slot of ``J1J2Slices``; here each keyword keeps
its own meaning, and the chain is open (``terms["periodic"]`` must be
false).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

import torch

from . import FP32, Precision

# exchanged configurations evaluated in one batch: bounds the memory
ROWS_PER_BLOCK = 1 << 17


def _pairs(n: int):
    """(first, second, is NNN) site index tensors of the open chain's bonds:
    NN (i, i+1), then NNN (i, i+2)."""
    first = list(range(n - 1)) + list(range(n - 2))
    second = [i + 1 for i in range(n - 1)] + [i + 2 for i in range(n - 2)]
    nnn = [False] * (n - 1) + [True] * max(0, n - 2)
    return torch.tensor(first), torch.tensor(second), torch.tensor(nnn, dtype=torch.bool)


def diagonal(samples: torch.Tensor, terms: Dict) -> torch.Tensor:
    """(S, N) spins -> (S,) float64 diagonal energies."""
    j1, j2, bz = terms["j1"], terms["j2"], terms["bz"]
    z = (2 * samples.long() - 1).to(torch.float64)
    nn = (z[:, :-1] * z[:, 1:]).sum(1)
    nnn = (z[:, :-2] * z[:, 2:]).sum(1)
    return 0.25 * j1 * nn + 0.25 * j2 * nnn + 0.5 * bz * z.sum(1)


def local_energy(model: ModuleType, params: Dict[str, torch.Tensor], samples: torch.Tensor,
                 terms: Dict, precision: Precision = FP32):
    """(E_loc (S,) complex128, log p (S,) float64) of the samples;
    ``model.log_psi(params, samples, precision)`` is the model's (Re, Im)
    log psi, ``terms`` the couplings ``j1``, ``j2``, ``bz``,
    ``marshall_sign``."""
    if terms["periodic"]:
        raise ValueError("the reference J1-J2 chain is open")
    s, n = samples.shape
    dev = samples.device
    re, im = model.log_psi(params, samples, precision)
    base = torch.complex(re, im)
    first, second, nnn = (t.to(dev) for t in _pairs(n))
    el_nn = -0.5 * terms["j1"] if terms["marshall_sign"] else 0.5 * terms["j1"]
    el = torch.full(nnn.shape, el_nn, dtype=torch.float64, device=dev)
    el[nnn] = 0.5 * terms["j2"]
    # every anti-aligned (sample, pair), each an exchanged configuration
    anti = (samples[:, first] != samples[:, second]) & (el != 0)
    rows, pair = anti.nonzero(as_tuple=True)
    offdiag = torch.zeros(s, dtype=torch.complex128, device=dev)
    for lo in range(0, rows.numel(), ROWS_PER_BLOCK):
        r, k = rows[lo:lo + ROWS_PER_BLOCK], pair[lo:lo + ROWS_PER_BLOCK]
        exchanged = samples[r].clone()
        exchanged[torch.arange(r.numel(), device=dev), first[k]] = samples[r, second[k]]
        exchanged[torch.arange(r.numel(), device=dev), second[k]] = samples[r, first[k]]
        ex_re, ex_im = model.log_psi(params, exchanged, precision)
        ratio = torch.exp(torch.complex(ex_re, ex_im) - base[r])
        offdiag.index_add_(0, r, el[k] * ratio)
    return diagonal(samples, terms) + offdiag, 2.0 * re
