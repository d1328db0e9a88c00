"""Exact-diagonalization oracle for the 1D TFIM (NumPy only).

A copy of ``tfim1d_dense`` and ``ground_state_energy`` from
``rnnwavefunctions_tpu/ed/exact.py``, so that code without JAX (the
PyTorch package and ``chip_smoke.py``) has an ED oracle.

Basis convention: state ``s`` in [0, 2^N); bit i of s = spin at site i
(0=down, 1=up), matching the integer sample encoding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _bits(s: int, n: int) -> np.ndarray:
    return (s >> np.arange(n)) & 1


def tfim1d_dense(n: int, bx: float, jz: Optional[np.ndarray] = None) -> np.ndarray:
    """Dense H for the 1D TFIM, OBC:  H = -sum Jz_i z_i z_{i+1} - Bx sum x_i."""
    if jz is None:
        jz = np.ones(n - 1)
    dim = 1 << n
    h = np.zeros((dim, dim))
    for s in range(dim):
        b = _bits(s, n)
        z = 2 * b - 1
        h[s, s] = -np.sum(jz * z[:-1] * z[1:])
        for i in range(n):
            h[s ^ (1 << i), s] += -bx
    return h


def ground_state_energy(h: np.ndarray) -> float:
    return float(np.linalg.eigvalsh(h)[0])
