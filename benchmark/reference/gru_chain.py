"""The positive GRU RNN wavefunction on a chain (Hibat-Allah et al.,
PRR 2, 023358 (2020), Sec. II): p(sigma) = prod_n p(sigma_n | sigma_<n),
each conditional the softmax head on the state of a reset-after GRU fed the
one-hot previous spin (the zero vector at site 0):

    r = sigmoid(x Wr + br_x + h Ur + br_h)
    z = sigmoid(x Wz + bz_x + h Uz + bz_h)
    c = tanh  (x Wc + bc_x + r * (h Uc + bc_h))
    h' = z * h + (1 - z) * c,      p(. | sigma_<n) = softmax(h' W + b)

Parameters are a dict of float32 tensors (float64 for the round-off
witness) under the names the benchmark hands to both sides: ``rnn.0.wx``
(2, 3U), ``rnn.0.wh`` (U, 3U), ``rnn.0.bx``, ``rnn.0.bh`` (3U), ``head.w``
(U, 2), ``head.b`` (2), gates packed [r | z | c].  Samples are (S, N) integer spins in {0, 1}.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import FP32, Precision


def log_prob(params: Dict[str, torch.Tensor], samples: torch.Tensor,
             precision: Precision = FP32) -> torch.Tensor:
    """(S, N) samples -> (S,) float64 log p, the site terms in the
    parameters' dtype."""
    mm = precision.mm
    wx, wh = params["rnn.0.wx"], params["rnn.0.wh"]
    bx, bh = params["rnn.0.bx"], params["rnn.0.bh"]
    hw, hb = params["head.w"], params["head.b"]
    s, n = samples.shape
    u = wh.shape[0]
    spins = samples.long()
    h = torch.zeros(s, u, dtype=wh.dtype, device=samples.device)
    x = torch.zeros(s, 2, dtype=wh.dtype, device=samples.device)
    total = torch.zeros(s, dtype=torch.float64, device=samples.device)
    for i in range(n):
        gx = mm(x, wx) + bx
        gh = mm(h, wh) + bh
        r = torch.sigmoid(gx[:, :u] + gh[:, :u])
        z = torch.sigmoid(gx[:, u:2 * u] + gh[:, u:2 * u])
        c = torch.tanh(gx[:, 2 * u:] + r * gh[:, 2 * u:])
        h = z * h + (1.0 - z) * c
        logp = torch.log_softmax(mm(h, hw) + hb, dim=-1)
        total = total + logp.gather(1, spins[:, i:i + 1])[:, 0].double()
        x = torch.nn.functional.one_hot(spins[:, i], 2).to(wh.dtype)
    return total
