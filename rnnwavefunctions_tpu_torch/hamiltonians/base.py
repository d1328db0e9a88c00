"""Hamiltonian protocol: static-shape connected-configuration expansion.

Counterpart of ``rnnwavefunctions_tpu/hamiltonians/base.py``, on batches:
for (S, N) configurations ``sigma``,

    connected(sigma) -> (diag (S,), flips (S, K, N), elements (S, K), mask (S, K))

lists every configuration sigma' connected to each row by the Hamiltonian,
with a static bound K (``n_offdiag``); rows where ``mask`` is False are
padding.  The local energy is
``E_loc = diag + sum_k mask_k * elements_k * psi(sigma'_k) / psi(sigma)``.
"""

from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import torch


@runtime_checkable
class Hamiltonian(Protocol):
    #: static off-diagonal connectivity bound K
    n_offdiag: int

    def connected(
        self, sigma: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]: ...
