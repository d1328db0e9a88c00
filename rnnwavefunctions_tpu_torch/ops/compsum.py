"""Compensated (Kahan) accumulation of per-site log-probabilities.

Counterpart of ``rnnwavefunctions_tpu/ops/compsum.py``: an f32 pair
(sum, compensation) carries the running error of each add, so the site sum
keeps the float64-sum accuracy of the original reference at f32 cost.  The
CUDA kernels carry the same pair in registers (``csrc/gru_common.cuh``).
Gradients pass straight through: the compensated sum is linear with
coefficient 1 per term.
"""

from __future__ import annotations

import torch


def kadd(s: torch.Tensor, c: torch.Tensor, x: torch.Tensor):
    """One compensated add: returns the updated (sum, compensation) pair.
    Eager PyTorch keeps float add order, so the pair is not reassociated."""
    y = x - c
    t = s + y
    c = (t - s) - y
    return t, c


def kfinal(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Final corrected value of a compensated pair."""
    return s - c


def compensated_sum(xs: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Kahan sum of ``xs`` along ``dim``, in sequential order.

    Infinity-safe: the compensation is zeroed whenever the running sum is not
    finite, so a -inf term propagates as -inf instead of turning into NaN.
    """
    xs = torch.movedim(xs, dim, 0)
    s = torch.zeros_like(xs[0])
    c = torch.zeros_like(xs[0])
    for x in xs:
        s, c = kadd(s, c, x)
        c = torch.where(torch.isfinite(s), c, torch.zeros_like(c))
    return kfinal(s, c)
