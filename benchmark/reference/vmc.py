"""The VMC update of a positive wavefunction, written from its formulas.

* The energy gradient is the surrogate loss mean(log p (E_loc - <E>)) by
  autograd (= 2 mean(log psi (E_loc - <E>)), psi = sqrt(p)).
* minSR (Chen & Heyl, arXiv:2302.01941): with the per-sample rows
  O = d log psi / d theta, A = (O - mean O) / sqrt(S) and
  c = (E_loc - <E>) / sqrt(S), the direction is 2 A^T (A A^T + lam I)^-1 c,
  the (S, S) system solved densely in float64.
* Adam and SGD as ``torch.optim`` defines them, on float32 parameters.

Parameters are dicts of float32 tensors (float64 for the round-off
witness); a model is a module of this package with a
``log_prob(params, samples, precision)``.  A configuration names this
module as its update (``reference.vmc``); a model whose amplitude is
complex names a module of its own with the same five names.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict

import torch

from . import FP32, Precision, round_tf32

Params = Dict[str, torch.Tensor]


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, its two backward products
    rounded alike."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _TF32MatMul.apply(g, b.mT), _TF32MatMul.apply(a.mT, g)


def differentiable(precision: Precision) -> Precision:
    """The precision whose products autograd can follow."""
    if precision is FP32:
        return precision
    return Precision(precision.name, _TF32MatMul.apply)


def loss_gradient(model: ModuleType, params: Params, samples: torch.Tensor,
                  e_loc: torch.Tensor, precision: Precision = FP32) -> Params:
    """The energy gradient of the batch: d/d theta of mean(log p (E - <E>))."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        lp = model.log_prob(leaves, samples, differentiable(precision))
        loss = (lp * (e_loc - e_loc.mean())).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))


def log_psi_rows(model: ModuleType, params: Params, samples: torch.Tensor,
                 precision: Precision = FP32) -> Params:
    """Per-sample d log psi / d theta: leaves (S, *shape)."""
    prec = differentiable(precision)
    frozen = {k: v.detach() for k, v in params.items()}
    with torch.enable_grad():
        return torch.func.jacrev(lambda p: 0.5 * model.log_prob(p, samples, prec))(frozen)


def minsr_direction(rows: Params, e_loc: torch.Tensor, damping: float,
                    precision: Precision = FP32) -> Params:
    """2 A^T (A A^T + damping I)^-1 c, leaf by leaf."""
    s = e_loc.shape[0]
    a = {k: (r.reshape(s, -1) - r.reshape(s, -1).mean(0)) / math.sqrt(s)
         for k, r in rows.items()}
    gram = sum(precision.mm(m, m.T) for m in a.values()).double()
    gram = gram + damping * torch.eye(s, dtype=torch.float64, device=gram.device)
    c = (e_loc - e_loc.mean()) / math.sqrt(s)
    x = torch.linalg.solve(gram, c.double())
    return {k: (2.0 * (m.double().T @ x)).to(m.dtype).reshape(rows[k].shape[1:])
            for k, m in a.items()}


class Adam:
    """``torch.optim.Adam`` with its defaults' arithmetic:
    p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, params: Params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Params, grads: Params) -> Params:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            out[k] = p - (self.lr / bc1) * self.m[k] / denom
        return out


class SGD:
    """p -= lr * direction."""

    def __init__(self, params: Params, lr: float):
        self.lr = lr

    def step(self, params: Params, grads: Params) -> Params:
        return {k: p - self.lr * grads[k] for k, p in params.items()}
