"""B21: the minSR sample-space solve ``t @ x = c`` by a fixed number of
conjugate-gradient steps in one kernel launch.

Counterpart of ``rnnwavefunctions_tpu/ops/sr_cg.py::sr_cg_solve``.  The CUDA
kernels are ``csrc/sr_cg.cu``, one of three paths chosen by S at launch:
one block holding T in registers (S <= 64), a thread-block cluster of 4
or 8 blocks holding its rows in registers and exchanging T p over
distributed shared memory (S <= 512), or a cooperative grid with one
grid-wide barrier per step.  The path taken is in
``sr_cg_solve.last_path``.  The dot products are summed in a fixed
order, so that one input always gives the same x.  The plain version
``cg_solve_plain`` is the JAX package's
``cg_solve_jnp``: the same steps, the same guards ``max(., 1e-30)`` that
freeze an exactly converged iterate, and no early exit.
"""

from __future__ import annotations

import ctypes

import torch

from .launch import counts_launches, is_cpu_call, launch

# the kernel's paths, in the order of csrc/sr_cg.cu's CgPath
_PATHS = ("block", "cluster", "grid")


def cg_solve_plain(t: torch.Tensor, c: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` CG steps on the symmetric positive definite ``t`` (S, S)
    from x = 0; returns x (S,)."""
    x = torch.zeros_like(c)
    r = c.clone()
    p = c.clone()
    rs = torch.dot(c, c)
    for _ in range(iters):
        tp = t @ p
        alpha = rs / torch.clamp_min(torch.dot(p, tp), 1e-30)
        x = x + alpha * p
        r = r - alpha * tp
        rs_new = torch.dot(r, r)
        p = r + rs_new / torch.clamp_min(rs, 1e-30) * p
        rs = rs_new
    return x


@counts_launches()
def sr_cg_solve(t: torch.Tensor, c: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Solves ``t @ x = c`` by ``iters`` CG steps: ``t`` (S, S) float32,
    symmetric positive definite (the damped SR Gram), ``c`` (S,) float32.
    On the card the kernel's path is chosen by S; the path taken is in
    ``sr_cg_solve.last_path``."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1; got {iters}")
    if is_cpu_call(t, c):
        return cg_solve_plain(t, c, iters)
    s = c.shape[0] if c.dim() == 1 else -1
    if (t.dtype != torch.float32 or c.dtype != torch.float32 or tuple(t.shape) != (s, s)
            or s < 1 or not t.is_contiguous() or not c.is_contiguous()):
        raise ValueError(
            f"the CG kernel takes a contiguous float32 (S, S) matrix and (S,) vector; got "
            f"{tuple(t.shape)} {t.dtype} and {tuple(c.shape)} {c.dtype}"
        )
    x = torch.empty_like(c)
    scratch = torch.empty(2 * s, dtype=torch.float32, device=c.device)
    taken = ctypes.c_int(-1)
    launch("rnnwf_sr_cg_solve", c.device, t, c, x, scratch, s, iters, ctypes.byref(taken))
    sr_cg_solve.last_path = _PATHS[taken.value]
    return x


sr_cg_solve.last_path = None
