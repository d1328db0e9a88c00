"""The complex U(1) RNN wavefunction on a chain (Hibat-Allah et al., PRR 2,
023358 (2020), Sec. IV; the paper's code ``J1J2/ComplexRNNwavefunction.py``,
``log_amplitude`` at lines 105-169): one reset-after GRU trunk fed the
one-hot previous spin (the zero vector at site 0),

    r = sigmoid(x Wr + br_x + h Ur + br_h)
    z = sigmoid(x Wz + bz_x + h Uz + bz_h)
    c = tanh  (x Wc + bc_x + r * (h Uc + bc_h))
    h' = z * h + (1 - z) * c,

and two heads on h': the amplitude ``sqrt(softmax(h' Wa + ba))`` and the
phase ``pi * softsign(h' Wp + bp)``.  From site n >= N/2 on, the U(1) mask
keeps a class only while its spin count stays within N/2 (heavyside, with
H(0) = 1, of N/2 - 1 less the count of that spin before n), and the kept
amplitudes are renormalised to unit L2 norm.  log psi = sum over sites of
log(amplitude of the target) + i (phase of the target).

Departures from the published code, none of which changes the function on
the chains the benchmark draws:

* the amplitude is taken in log space, log sqrt(softmax) = log_softmax / 2,
  and the L2 renormalisation as a log-sum-exp over the kept classes, where
  the code takes the square root, multiplies by the mask and divides by the
  norm;
* a forbidden target's log probability is the finite ``LOG_ZERO`` where the
  code's is log 0 = -inf, so that a chain outside the sector (a fault the
  check has to catch) reads a finite gap; no zero-magnetisation chain (every
  chain the program draws, and every exchange of one) meets one;
* class 1 is the spin the samples write as 1, and its count is the count of
  ones, the port's convention for "up";
* the real and imaginary parts are summed over sites in float64 and
  returned apart, where the code sums a complex64 log amplitude.

Parameters are a dict of float32 tensors (float64 for the round-off
witness) under the port's names: ``rnn.0.wx`` (2, 3U), ``rnn.0.wh`` (U, 3U),
``rnn.0.bx``, ``rnn.0.bh`` (3U), gates packed [r | z | c]; ``head_ampl.w``,
``head_phase.w`` (U, 2), ``head_ampl.b``, ``head_phase.b`` (2).  Samples are
(S, N) integer spins in {0, 1}.  Every matrix product goes through the
``Precision``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from . import FP32, Precision

LOG_ZERO = -1e9  # log probability of a class the U(1) mask forbids
HIDDEN = -1e30   # a forbidden class's logit inside the renormalisation: exp of it is 0


def log_psi(params: Dict[str, torch.Tensor], samples: torch.Tensor,
            precision: Precision = FP32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, N) samples -> (Re log psi, Im log psi), each (S,) float64, the
    site terms in the parameters' dtype."""
    mm = precision.mm
    wx, wh = params["rnn.0.wx"], params["rnn.0.wh"]
    bx, bh = params["rnn.0.bx"], params["rnn.0.bh"]
    aw, ab = params["head_ampl.w"], params["head_ampl.b"]
    pw, pb = params["head_phase.w"], params["head_phase.b"]
    s, n = samples.shape
    u = wh.shape[0]
    dev, dtype = samples.device, wh.dtype
    spins = samples.long()
    h = torch.zeros(s, u, dtype=dtype, device=dev)
    x = torch.zeros(s, 2, dtype=dtype, device=dev)
    counts = torch.zeros(s, 2, dtype=torch.long, device=dev)  # spins 0 and 1 so far
    re = torch.zeros(s, dtype=torch.float64, device=dev)
    im = torch.zeros(s, dtype=torch.float64, device=dev)
    for i in range(n):
        gx = mm(x, wx) + bx
        gh = mm(h, wh) + bh
        r = torch.sigmoid(gx[:, :u] + gh[:, :u])
        z = torch.sigmoid(gx[:, u:2 * u] + gh[:, u:2 * u])
        c = torch.tanh(gx[:, 2 * u:] + r * gh[:, 2 * u:])
        h = z * h + (1.0 - z) * c
        logp = torch.log_softmax(mm(h, aw) + ab, dim=-1)
        if 2 * i >= n:
            kept = n // 2 - 1 - counts >= 0
            norm = torch.logsumexp(torch.where(kept, logp, HIDDEN), dim=-1, keepdim=True)
            logp = torch.where(kept, logp - norm, LOG_ZERO)
        q = mm(h, pw) + pb
        phase = math.pi * q / (1.0 + q.abs())
        target = spins[:, i:i + 1]
        re = re + 0.5 * logp.gather(1, target)[:, 0].double()
        im = im + phase.gather(1, target)[:, 0].double()
        x = torch.nn.functional.one_hot(spins[:, i], 2).to(dtype)
        counts = counts + x.long()
    return re, im


def log_prob(params: Dict[str, torch.Tensor], samples: torch.Tensor,
             precision: Precision = FP32) -> torch.Tensor:
    """log |psi|^2 = 2 Re log psi, (S,) float64: what the check compares."""
    return 2.0 * log_psi(params, samples, precision)[0]
