"""minSR: stochastic reconfiguration (natural-gradient VMC) solved in
sample space.

Counterpart of ``rnnwavefunctions_tpu/vmc/minsr.py`` on one device.  The SR
direction ``(S + lam I)^{-1} F`` with S_kl = Re<conj(Obar_k) Obar_l> and
F_k = 2 Re<conj(Obar_k) (E_loc - <E>)> never forms the P x P matrix: with
A = [Re Obar; Im Obar] / sqrt(S) (one row per sample) and c = [Re eps;
Im eps] / sqrt(S), the push-through identity

    (A^T A + lam I_P)^{-1} A^T c  ==  A^T (A A^T + lam I_{2S})^{-1} c

moves the solve into the (S, S) or (2S, 2S) sample space [Chen & Heyl,
arXiv:2302.01941; Rende et al., arXiv:2310.05715].  The Gram ``A A^T`` and
the back-contraction ``A^T x`` are float32 ``torch.matmul`` (TF32 is off,
``__init__.py``); the solve is a Cholesky (``solver="chol"``) or the
fixed-step CG kernel B21 (``solver="cg"``, ``ops/sr_cg.py``).

The rows come from ``vmc/jacobian.py`` for the built-in ansatze (on the card
through the jacobian kernels B17, B19, B20); any other ansatz takes the
generic rows, ``torch.func.jacrev`` over ``functional_call`` on its plain
path.  The data-parallel ``pmean``/``all_gather`` branches of
the JAX package wait for the parallelism port.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from ..interop import param_tree, tree_leaves, tree_map, tree_unflatten
from ..utils.trace import span
from . import jacobian

SOLVERS = ("chol", "cg")


class _LogAmp(nn.Module):
    """log psi of one ansatz as a module call: the real log psi, or the
    stacked (Re, Im) of a complex ansatz."""

    def __init__(self, ansatz: Any):
        super().__init__()
        self.ansatz = ansatz

    def forward(self, samples: torch.Tensor) -> torch.Tensor:
        if getattr(self.ansatz, "is_complex", False):
            return torch.stack(self.ansatz.log_amp_parts(samples), dim=-1)
        return self.ansatz.log_amp(samples)


def _generic_rows(ansatz: Any, samples: torch.Tensor):
    """Per-sample rows by ``torch.func.jacrev`` over ``functional_call`` on
    the ansatz's plain path (``impl="plain"`` on a shallow copy that shares
    the parameters): one batched forward, and the backward vmapped over the
    S output rows, each of which depends on its own sample only.  (A vmap
    over the samples would batch the plain samplers' one-hot draws, which
    vmap refuses as data-dependent.)"""
    twin = copy.copy(ansatz)
    twin.impl = "plain"
    module = _LogAmp(twin)
    params = {f"ansatz.{k}": v.detach() for k, v in ansatz.named_parameters()}
    rows = torch.func.jacrev(
        lambda p: torch.func.functional_call(module, p, (samples,)))(params)
    name_of = {id(v): f"ansatz.{k}" for k, v in ansatz.named_parameters()}
    tree = tree_map(lambda p: rows[name_of[id(p)]], param_tree(ansatz))
    if not getattr(ansatz, "is_complex", False):
        return tree, None
    return tree_map(lambda r: r[:, 0], tree), tree_map(lambda r: r[:, 1], tree)


def per_sample_log_amp_grad_trees(ansatz: Any, samples: torch.Tensor):
    """Per-sample log-derivative rows as parameter-shaped trees (the JAX
    package's layout, leaves (S, *param-shape)): ``(rows_re, rows_im)``,
    ``rows_im`` None for a real log psi."""
    with span("rnnwf.minsr.rows"):
        if jacobian.supports(ansatz):
            if getattr(ansatz, "is_complex", False):
                return jacobian.crnn_log_amp_rows(ansatz, samples)
            return jacobian.log_amp_rows(ansatz, samples), None
        return _generic_rows(ansatz, samples)


def _flatten_rows(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in leaves], dim=-1)


def per_sample_log_amp_grads(ansatz: Any, samples: torch.Tensor
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Callable]:
    """The log-derivative matrix O, one row per sample and one column per
    parameter in ``ravel_pytree`` order: ``(o_re, o_im, unravel)``, ``o_im``
    None for a real log psi, ``unravel`` mapping a flat (P,) vector to a
    parameter tree.  A flattening of ``per_sample_log_amp_grad_trees``, so
    both forms share one row source."""
    rows_re, rows_im = per_sample_log_amp_grad_trees(ansatz, samples)
    shapes = [p.shape for p in tree_leaves(param_tree(ansatz))]

    def unravel(flat: torch.Tensor):
        parts = torch.split(flat, [math.prod(s) for s in shapes])
        return tree_unflatten(param_tree(ansatz), [p.reshape(s) for p, s in zip(parts, shapes)])

    o_im = None if rows_im is None else _flatten_rows(rows_im)
    return _flatten_rows(rows_re), o_im, unravel


def _solve(t: torch.Tensor, c: torch.Tensor, solver: str, cg_iters: int) -> torch.Tensor:
    with span("rnnwf.minsr.solve"):
        if solver == "cg":
            from ..ops import sr_cg

            return sr_cg.sr_cg_solve(t.contiguous(), c.contiguous(), cg_iters)
        return torch.cholesky_solve(c[:, None], torch.linalg.cholesky(t))[:, 0]


def sample_space_system(rows_re, rows_im, e_re: torch.Tensor, e_im: Optional[torch.Tensor],
                        e_mean_re: torch.Tensor, e_mean_im: Optional[torch.Tensor],
                        damping: float):
    """The damped sample-space system of the row trees: ``(t, c, a_parts)``
    with t = A A^T + damping I, (S, S) or (2S, 2S), the right-hand side c,
    and per part (Re, then Im) the centred, 1/sqrt(S)-scaled (S, P_l) leaf
    matrices A_l.  The Gram is a sum of per-leaf blocks ``sum_l A_l
    A_l^T``, so the (S, P) matrix is never assembled; a complex ansatz's
    Gram is built from its three (S, S) blocks."""
    s = tree_leaves(rows_re)[0].shape[0]
    inv_sqrt = 1.0 / math.sqrt(s)

    def prep(tree):
        mats = (leaf.reshape(s, -1) for leaf in tree_leaves(tree))
        return [(m - m.mean(dim=0)) * inv_sqrt for m in mats]

    a_re = prep(rows_re)
    t = sum(m @ m.T for m in a_re)
    c = (e_re - e_mean_re) * inv_sqrt
    a_parts = [a_re]
    if rows_im is not None:
        a_im = prep(rows_im)
        t_ri = sum(mr @ mi.T for mr, mi in zip(a_re, a_im))
        t_ii = sum(m @ m.T for m in a_im)
        t = torch.cat([torch.cat([t, t_ri], dim=1), torch.cat([t_ri.T, t_ii], dim=1)])
        c = torch.cat([c, (e_im - e_mean_im) * inv_sqrt])
        a_parts.append(a_im)
    return t + damping * torch.eye(t.shape[0], dtype=t.dtype, device=t.device), c, a_parts


def minsr_direction_tree(rows_re, rows_im, e_re: torch.Tensor, e_im: Optional[torch.Tensor],
                         e_mean_re: torch.Tensor, e_mean_im: Optional[torch.Tensor],
                         damping: float, solver: str = "chol", cg_iters: int = 64):
    """The SR direction, leaf by leaf on the row trees of
    ``per_sample_log_amp_grad_trees``, as a parameter tree (the values of
    ``minsr_direction``): the solve of ``sample_space_system``, then the
    back-contraction ``2 A^T x`` split per leaf."""
    with span("rnnwf.minsr.gram"):
        t, c, a_parts = sample_space_system(rows_re, rows_im, e_re, e_im, e_mean_re, e_mean_im,
                                            damping)
    x_parts = torch.split(_solve(t, c, solver, cg_iters), a_parts[0][0].shape[0])

    def back(i, leaf):
        out = sum(part[i].T @ xp for part, xp in zip(a_parts, x_parts))
        return (2.0 * out).reshape(leaf.shape[1:])

    leaves = tree_leaves(rows_re)
    return tree_unflatten(rows_re, [back(i, leaf) for i, leaf in enumerate(leaves)])


def minsr_direction(o_re: torch.Tensor, o_im: Optional[torch.Tensor], e_re: torch.Tensor,
                    e_im: Optional[torch.Tensor], e_mean_re: torch.Tensor,
                    e_mean_im: Optional[torch.Tensor], damping: float) -> torch.Tensor:
    """The SR direction ``(S + damping I)^{-1} F`` as a flat (P,) vector from
    the flat O matrices, by Cholesky in sample space; its large-damping
    limit is F / damping, the surrogate-loss gradient scaled."""
    inv_sqrt = 1.0 / math.sqrt(o_re.shape[0])
    a_blocks = [(o_re - o_re.mean(dim=0)) * inv_sqrt]
    c_blocks = [(e_re - e_mean_re) * inv_sqrt]
    if o_im is not None:
        a_blocks.append((o_im - o_im.mean(dim=0)) * inv_sqrt)
        c_blocks.append((e_im - e_mean_im) * inv_sqrt)
    a, c = torch.cat(a_blocks), torch.cat(c_blocks)
    t = a @ a.T + damping * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return 2.0 * (a.T @ _solve(t, c, "chol", 0))
