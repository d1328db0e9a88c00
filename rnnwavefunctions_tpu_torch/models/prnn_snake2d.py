"""Snake-ordered 1D pRNN over a 2D lattice.

Counterpart of ``rnnwavefunctions_tpu/models/prnn_snake2d.py``: the same 1D
GRU ansatz iterated over the Nx x Ny lattice in row-major (y-major) order,
which is exactly a 1D chain over the flat index ``y*Nx + x``.  So this
module *is* a ``PRNN1D`` over ``Nx*Ny`` sites with the lattice attached.
Samples are flat ``(S, Nx*Ny)`` vectors in scan order, consumed by
``TFIM2D(encoding="flat")``; on the card the model trains through the
``"plain_flip"`` kernels K1-K4 and samples with B5.
"""

from __future__ import annotations

from typing import Sequence

from .prnn1d import PRNN1D


def PRNNSnake2D(nx: int, ny: int, units: Sequence[int] = (50,), local_dim: int = 2,
                cell: str = "gru", impl: str = "auto", device=None) -> PRNN1D:
    """A ``PRNN1D`` over the flattened (y-major) Nx x Ny lattice, with
    ``lattice = (nx, ny)``.  ``device=None`` means the card, as for
    ``PRNN1D``."""
    ansatz = PRNN1D(nx * ny, units, local_dim=local_dim, cell=cell, impl=impl, device=device)
    ansatz.lattice = (nx, ny)
    return ansatz
