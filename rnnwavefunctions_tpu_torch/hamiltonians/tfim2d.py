"""2D transverse-field Ising model, open boundaries, on an Nx x Ny lattice.

    H = -sum_<ij> Jz_ij sigma^z_i sigma^z_j  -  Bx sum_i sigma^x_i

Counterpart of ``rnnwavefunctions_tpu/hamiltonians/tfim2d.py``, on batches of
integer spins (0 = down, 1 = up) in one of two encodings:

* ``encoding="flat"``: (S, Nx*Ny) vectors in y-major order, flat index
  ``y*Nx + x`` (the snake-ordered 1D ansatz's layout);
* ``encoding="grid"``: (S, Nx, Ny) grids indexed [s, x, y] (the 2D MDRNN's).

``jz`` is a scalar (uniform couplings) or an (Nx, Ny) array whose entry
``Jz[x, y]`` weights both bonds (x, y)-(x+1, y) and (x, y)-(x, y+1).  The
off-diagonal part is the Nx*Ny single-spin flips with element ``-Bx``, in
the order of the sample's own flattening.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TFIM2D:
    nx: int
    ny: int
    bx: float = 2.0
    jz: Union[float, tuple] = 1.0
    encoding: str = "flat"  # "flat" (y-major vector) or "grid" ((nx, ny) array)

    def __post_init__(self):
        if self.encoding not in ("flat", "grid"):
            raise ValueError(f"unknown encoding {self.encoding!r}")
        if not np.isscalar(self.jz):
            arr = np.asarray(self.jz, np.float32)
            if arr.shape != (self.nx, self.ny):
                raise ValueError(f"per-bond jz must be ({self.nx}, {self.ny}); got {arr.shape}")
            # stored hashable, as the frozen dataclass's fields
            object.__setattr__(self, "jz", tuple(tuple(float(v) for v in row) for row in arr))

    @property
    def n_sites(self) -> int:
        return self.nx * self.ny

    @property
    def n_offdiag(self) -> int:
        return self.n_sites

    @property
    def uniform_flip_element(self) -> float:
        """Marker for the fused single-flip kernel paths: every off-diagonal
        connected config is a single-site flip with this constant element."""
        return -self.bx

    def _grid(self, sigma: torch.Tensor) -> torch.Tensor:
        """The batch as (S, Ny, Nx) grids indexed [s, y, x]."""
        if self.encoding == "flat":
            return sigma.reshape(-1, self.ny, self.nx)
        return sigma.transpose(1, 2)

    def diagonal(self, sigma: torch.Tensor) -> torch.Tensor:
        """(S, ...) int -> (S,) diagonal energies."""
        z = (2 * self._grid(sigma) - 1).to(torch.float32)
        row, col = z[:, :, :-1] * z[:, :, 1:], z[:, :-1, :] * z[:, 1:, :]
        if np.isscalar(self.jz):
            return -self.jz * (row.sum(dim=(1, 2)) + col.sum(dim=(1, 2)))
        jzt = torch.tensor(self.jz, dtype=torch.float32, device=sigma.device).T  # [y, x]
        return -((jzt[:, :-1] * row).sum(dim=(1, 2)) + (jzt[:-1, :] * col).sum(dim=(1, 2)))

    def connected(self, sigma: torch.Tensor):
        """(S, ...) int -> (diag (S,), flips (S, NS, ...), elements (S, NS),
        mask (S, NS)); flip k flips entry k of the flattened sample."""
        s, n = sigma.shape[0], self.n_sites
        flat = sigma.reshape(s, n)
        eye = torch.eye(n, dtype=torch.bool, device=sigma.device)
        rows = flat[:, None, :].expand(s, n, n)
        flips = torch.where(eye, 1 - rows, rows).reshape((s, n) + tuple(sigma.shape[1:]))
        elements = torch.full((s, n), -self.bx, dtype=torch.float32, device=sigma.device)
        mask = torch.full((s, n), self.bx != 0.0, device=sigma.device)
        return self.diagonal(sigma), flips, elements, mask
