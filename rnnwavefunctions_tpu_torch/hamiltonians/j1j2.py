"""J1-J2 Heisenberg chain with optional Marshall sign rotation.

    H = sum_i J1 S_i.S_{i+1} + J2 S_i.S_{i+2} + Bz S^z_i,   S = sigma / 2

Counterpart of ``rnnwavefunctions_tpu/hamiltonians/j1j2.py``, on (S, N)
batches of integer spins (0 = down, 1 = up):

* diagonal: ``Bz (sigma - 1/2)`` plus ``+-J/4`` per aligned / anti-aligned
  NN and NNN pair;
* off-diagonal: the spin exchange of each anti-aligned NN pair, element
  ``-J1/2`` under the Marshall sign rotation else ``+J1/2``, and of each
  anti-aligned NNN pair, ``+J2/2``.

The connectivity is a static 2N slots with a validity mask: slot ``i`` is
the NN exchange at bond (i, i+1), slot ``N+i`` the NNN exchange at
(i, i+2), wrapping around when ``periodic``.  ``periodic`` and
``marshall_sign`` are separate keywords, each wired to its own meaning (the
original reference passed its Marshall flag into the periodic slot).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class J1J2:
    num_sites: int
    j1: float = 1.0
    j2: float = 0.0
    bz: float = 0.0
    periodic: bool = False
    marshall_sign: bool = False

    @property
    def n_offdiag(self) -> int:
        return 2 * self.num_sites

    @property
    def exchange_kernel_info(self) -> Optional[dict]:
        """Marker for the exchange kernels B10/B11 (None when there is no NN
        exchange): the matrix elements and bond families they compute."""
        if self.j1 == 0.0:
            return None
        return {
            "el_nn": (-self.j1 / 2) if self.marshall_sign else (self.j1 / 2),
            "el_nnn": self.j2 / 2,
            "has_nnn": self.j2 != 0.0,
            "periodic": self.periodic,
        }

    def _pair_masks(self, device):
        """Per-bond validity: (valid_nn, valid_nnn), boolean (N,)."""
        n = self.num_sites
        idx = torch.arange(n, device=device)
        return idx < (n if self.periodic else n - 1), idx < (n if self.periodic else n - 2)

    def diagonal(self, sigma: torch.Tensor) -> torch.Tensor:
        """(S, N) int -> (S,) diagonal energies."""
        valid_nn, valid_nnn = self._pair_masks(sigma.device)
        sgn1 = torch.where(sigma != torch.roll(sigma, -1, dims=1), -1.0, 1.0)
        sgn2 = torch.where(sigma != torch.roll(sigma, -2, dims=1), -1.0, 1.0)
        return (
            torch.sum(self.bz * (sigma.to(torch.float32) - 0.5), dim=1)
            + 0.25 * self.j1 * torch.sum(torch.where(valid_nn, sgn1, 0.0), dim=1)
            + 0.25 * self.j2 * torch.sum(torch.where(valid_nnn, sgn2, 0.0), dim=1)
        )

    def connected(self, sigma: torch.Tensor):
        """(S, N) int -> (diag (S,), flips (S, 2N, N), elements (S, 2N),
        mask (S, 2N)).  Each exchange flips both members of its pair, which
        swaps them when they are anti-aligned, the only case the mask
        keeps."""
        s, n = sigma.shape
        dev = sigma.device
        valid_nn, valid_nnn = self._pair_masks(dev)
        eye = torch.eye(n, dtype=torch.int32, device=dev)
        rows = sigma[:, None, :]
        flips = torch.cat([
            torch.where(eye + torch.roll(eye, gap, dims=1) == 1, 1 - rows, rows)
            for gap in (1, 2)
        ], dim=1)
        el_nn = (-self.j1 / 2) if self.marshall_sign else (self.j1 / 2)
        elements = torch.cat([
            torch.full((s, n), el_nn, dtype=torch.float32, device=dev),
            torch.full((s, n), self.j2 / 2, dtype=torch.float32, device=dev),
        ], dim=1)
        mask = torch.cat([
            valid_nn & (sigma != torch.roll(sigma, -1, dims=1)) & (self.j1 != 0.0),
            valid_nnn & (sigma != torch.roll(sigma, -2, dims=1)) & (self.j2 != 0.0),
        ], dim=1)
        return self.diagonal(sigma), flips, elements, mask
