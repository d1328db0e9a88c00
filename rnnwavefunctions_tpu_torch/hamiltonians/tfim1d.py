"""1D transverse-field Ising model, open boundary conditions.

    H = -sum_i Jz_i sigma^z_i sigma^z_{i+1}  -  Bx sum_i sigma^x_i

Counterpart of ``rnnwavefunctions_tpu/hamiltonians/tfim1d.py``, on (S, N)
batches of integer spins (0 = down, 1 = up).  Each of the N single-spin
flips contributes the matrix element -Bx.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TFIM1D:
    num_sites: int
    bx: float = 1.0
    jz: Optional[Tuple[float, ...]] = None  # per-bond couplings; default all 1

    @property
    def n_offdiag(self) -> int:
        return self.num_sites

    def _jz(self, device) -> torch.Tensor:
        if self.jz is None:
            return torch.ones(self.num_sites - 1, device=device)
        return torch.as_tensor(self.jz, dtype=torch.float32, device=device)[
            : self.num_sites - 1
        ]

    @property
    def uniform_flip_element(self) -> float:
        """Marker for the fused single-flip kernel path: every off-diagonal
        connected config is a single-site flip with this constant element."""
        return -self.bx

    def diagonal(self, sigma: torch.Tensor) -> torch.Tensor:
        """(S, N) int -> (S,) diagonal energies."""
        z = (2 * sigma - 1).to(torch.float32)  # +-1
        return -torch.sum(self._jz(sigma.device) * z[:, :-1] * z[:, 1:], dim=1)

    def connected(self, sigma: torch.Tensor):
        """(S, N) int -> (diag (S,), flips (S, N, N), elements (S, N), mask (S, N))."""
        s, n = sigma.shape
        eye = torch.eye(n, dtype=torch.bool, device=sigma.device)
        rows = sigma[:, None, :].expand(s, n, n)
        flips = torch.where(eye, 1 - rows, rows)
        elements = torch.full((s, n), -self.bx, dtype=torch.float32, device=sigma.device)
        mask = torch.full((s, n), self.bx != 0.0, device=sigma.device)
        return self.diagonal(sigma), flips, elements, mask
