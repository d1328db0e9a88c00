"""Exact-diagonalization oracle for the 1D and 2D TFIM and the J1-J2 chain
(NumPy only).

A copy of ``tfim1d_dense``, ``tfim2d_dense``, ``j1j2_dense`` and
``ground_state_energy`` from
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


def tfim2d_dense(nx: int, ny: int, bx: float, jz: float = 1.0) -> np.ndarray:
    """Dense H for the 2D TFIM on an nx x ny OBC lattice (site index
    y-major: idx = y*nx + x, matching the snake/2DRNN sample layouts)."""
    n = nx * ny
    dim = 1 << n
    h = np.zeros((dim, dim))
    for s in range(dim):
        b = _bits(s, n).reshape(ny, nx)  # [y, x]
        z = 2 * b - 1
        diag = -jz * (np.sum(z[:, :-1] * z[:, 1:]) + np.sum(z[:-1, :] * z[1:, :]))
        h[s, s] = diag
        for i in range(n):
            h[s ^ (1 << i), s] += -bx
    return h


# Ground-state energy of the 4x4 open-boundary TFIM at Bx=3, Jz=1 (the
# reference's default 2D configuration), from the JAX package's native
# Lanczos oracle (BENCHMARKS.md, "2D TFIM at the reference's default 4x4,
# Bx=3"): 2^16 states are too many for dense ED.
E_TFIM2D_4X4_BX3 = -50.1866238828


def j1j2_dense(n: int, j1: float = 1.0, j2: float = 0.0, bz: float = 0.0,
               periodic: bool = False, marshall_sign: bool = False) -> np.ndarray:
    """Dense H for the J1-J2 chain, S = sigma/2: diagonal +-J/4 per
    (anti)aligned pair plus Bz (sigma - 1/2); spin-exchange off-diagonals
    -J1/2 (Marshall-rotated) or +J1/2, and +J2/2."""
    dim = 1 << n
    h = np.zeros((dim, dim))
    lim1 = n if periodic else n - 1
    lim2 = n if periodic else n - 2
    for s in range(dim):
        b = _bits(s, n)
        diag = np.sum(bz * (b - 0.5))
        for i in range(lim1):
            j = (i + 1) % n
            diag += 0.25 * j1 if b[i] == b[j] else -0.25 * j1
            if b[i] != b[j]:
                sp = s ^ (1 << i) ^ (1 << j)  # exchange the two spins
                h[sp, s] += (-j1 / 2) if marshall_sign else (+j1 / 2)
        for i in range(lim2):
            j = (i + 2) % n
            if j2 != 0.0:
                diag += 0.25 * j2 if b[i] == b[j] else -0.25 * j2
                if b[i] != b[j]:
                    sp = s ^ (1 << i) ^ (1 << j)
                    h[sp, s] += +j2 / 2
        h[s, s] += diag
    return h


def ground_state_energy(h: np.ndarray) -> float:
    return float(np.linalg.eigvalsh(h)[0])
