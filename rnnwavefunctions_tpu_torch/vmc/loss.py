"""VMC surrogate ("fake cost") loss, complex-free.

Counterpart of ``rnnwavefunctions_tpu/vmc/loss.py``.  With
Ec = detach(E_loc - <E>) and log psi = a + i b,

    cost = 2 * mean(a * Ec_re + b * Ec_im),

whose gradient is the VMC energy gradient.  For a positive ansatz (b = 0)
this is mean(log p * Ec).  The caller supplies the mean of E_loc.
"""

from __future__ import annotations

from typing import Optional

import torch


def surrogate_loss(
    la_re: torch.Tensor,
    la_im: Optional[torch.Tensor],
    e_re: torch.Tensor,
    e_im: Optional[torch.Tensor],
    e_mean_re: torch.Tensor,
    e_mean_im: Optional[torch.Tensor],
) -> torch.Tensor:
    """Scalar surrogate; ``la_*`` are (S,) parts of log psi (im None when
    real), ``e_*`` the (S,) local energies, ``e_mean_*`` their mean."""
    ec_re = (e_re - e_mean_re).detach()
    cost = torch.mean(la_re * ec_re)
    if la_im is not None and e_im is not None:
        ec_im = (e_im - e_mean_im).detach()
        cost = cost + torch.mean(la_im * ec_im)
    return 2.0 * cost
