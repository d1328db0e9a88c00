"""The VMC update of a complex wavefunction, written from its formulas.

* The energy gradient is the autograd gradient of the paper's surrogate
  cost (``J1J2/TrainingRNN_J1J2.py:197``),

      2 Re( mean(conj(log psi) E) - conj(mean(log psi)) mean(E) ),

  with the local energies E held fixed, on log psi = Re + i Im from the
  model's ``log_psi``.
* Adam and SGD are ``vmc.py``'s.

A configuration names this module as its update (``reference.vmc``) where
its model's amplitude is complex.  It has what an Adam cell's check calls;
a minSR cell of a complex model would add ``log_psi_rows`` and
``minsr_direction`` here.
"""

from __future__ import annotations

from types import ModuleType

import torch

from . import FP32, Precision
from .vmc import SGD, Adam, Params, differentiable

__all__ = ["Adam", "SGD", "loss_gradient"]


def loss_gradient(model: ModuleType, params: Params, samples: torch.Tensor,
                  e_loc: torch.Tensor, precision: Precision = FP32) -> Params:
    """The energy gradient of the batch, leaf by leaf; ``e_loc`` (S,)
    complex."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    e = e_loc.detach().to(torch.complex128)
    with torch.enable_grad():
        re, im = model.log_psi(leaves, samples, differentiable(precision))
        log_psi = torch.complex(re, im)
        cost = 2.0 * (torch.mean(log_psi.conj() * e) - log_psi.mean().conj() * e.mean()).real
        grads = torch.autograd.grad(cost, list(leaves.values()))
    return dict(zip(leaves, grads))
