"""1D positive RNN wavefunction (pRNN): psi(sigma) = sqrt(p(sigma)) with p
autoregressive over the chain, optionally parity-symmetrized.

Counterpart of ``rnnwavefunctions_tpu/models/prnn1d.py`` for uniform GRU
stacks.  With ``parity=True`` the density is symmetrized under spatial
reflection, ``p(s) = (p_ar(s) + p_ar(reversed s)) / 2``, computed as a
``logaddexp``; as in the reference and the JAX package only the density is
symmetrized, and the sampler stays the plain autoregressive one.  The module
owns its parameters; sampling draws its randomness from an explicit
``torch.Generator``.  When ``resolve_impl`` selects the kernels, a single
GRU layer's teacher-forced log p runs K1 forward and K2 backward
(``ops/fused_gru.py``; twice for parity, on the samples and on their
reversal) and its sampler runs B5 (``fused_gru.gru_sample``).  Off the
kernels, a single layer runs the same plain loops as those kernels' CPU
versions; the stacked loops below serve deeper stacks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from . import cells
from .base import resolve_device, resolve_impl
from ..ops import fused_gru
from ..ops.compsum import compensated_sum
from ..ops.launch import draw_key

_REQUIREMENT = "one GRU layer with local_dim=2 whose weights fit shared memory"


class PRNN1D(nn.Module):
    """Args:
      num_sites: chain length N.
      units: hidden widths per stacked GRU layer (uniform widths).
      local_dim: on-site Hilbert dimension.
      parity: symmetrize the density (not the sampler) under reflection.
      cell: "gru" (LSTM and custom cells are not ported yet).
      impl: "auto", "kernel" or "plain" (``models/base.py``).
      device: where the parameters live; None means the card (raises
        without one: pass device="cpu" to run on the CPU).
    """

    is_complex = False
    head_names = ("head",)  # the parameter pytree's head entries (interop.py)

    def __init__(self, num_sites: int, units: Sequence[int] = (50,),
                 local_dim: int = 2, parity: bool = False, cell: str = "gru",
                 impl: str = "auto", device=None):
        super().__init__()
        units = tuple(units)
        if cell != "gru" or len(set(units)) != 1:
            raise NotImplementedError(
                "not ported yet: PRNN1D supports cell='gru' and uniform widths; "
                f"got cell={cell!r}, units={units}"
            )
        self.num_sites = num_sites
        self.units = units
        self.local_dim = local_dim
        self.parity = parity
        self.cell = cell
        self.impl = impl
        dims = (local_dim,) + units
        self.rnn = nn.ModuleList(
            cells.GRUCell(dims[i], dims[i + 1]) for i in range(len(units))
        )
        self.head = cells.Dense(units[-1], local_dim)
        self.to(resolve_device(device))

    def extra_repr(self) -> str:
        return (f"num_sites={self.num_sites}, units={self.units}, "
                f"local_dim={self.local_dim}, parity={self.parity}, impl={self.impl!r}")

    @property
    def device(self) -> torch.device:
        return self.head.w.device

    @property
    def plain_positive(self) -> bool:
        """True when the sampling density equals the wavefunction density,
        so log psi = 0.5 * (sampling log-prob) without a second pass."""
        return not self.parity

    # -- kernel dispatch ----------------------------------------------------

    def _single_gru(self) -> bool:
        """One GRU layer over two local states: the shape of the kernels and
        of their plain versions."""
        return len(self.units) == 1 and self.local_dim == 2

    def _kernelizable(self) -> bool:
        return self._single_gru() and fused_gru.supports(
            self.num_sites, self.units, self.device)

    def _use_kernels(self) -> bool:
        return resolve_impl(self, self._kernelizable, _REQUIREMENT)

    def weights(self) -> Tuple[torch.Tensor, ...]:
        """The single-layer kernel weight tuple (wx, wh, bx, bh, head w,
        head b) in the JAX package's layout."""
        layer = self.rnn[0]
        return (layer.wx, layer.wh, layer.bx, layer.bh, self.head.w, self.head.b)

    # -- parameters ---------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None) -> "PRNN1D":
        """Glorot-uniform weights and zero biases drawn from ``generator``
        (layers first, then the head); returns self."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in self.rnn:
            layer.reset_parameters(generator)
        self.head.reset_parameters(generator)
        return self

    # -- internals ----------------------------------------------------------

    def _step_logits(self, x: torch.Tensor, hs):
        out, hs = cells.stacked_rnn_apply(self.rnn, x, hs)
        return self.head(out), hs

    # -- sampling -----------------------------------------------------------

    @torch.no_grad()
    def sample_with_log_prob(self, num_samples: int, generator: torch.Generator):
        """Draw ``(num_samples, N)`` int32 spins by inverse-CDF sampling of
        each site's conditional (s = 1 iff u >= p0 for two local states), and
        return their plain (non-symmetrized) autoregressive log-density.  The
        randomness comes from ``generator`` (a CPU generator): the kernel gets
        a (seed, offset) pair drawn from it, the plain loops its uniforms."""
        if self._use_kernels():
            seed, offset = draw_key(generator)
            return fused_gru.gru_sample(self.weights(), num_samples, self.num_sites,
                                        seed, offset)
        d, dev = self.local_dim, self.device
        uniforms = torch.rand(num_samples, self.num_sites, generator=generator).to(dev)
        if self._single_gru():
            return fused_gru.sample_plain(self.weights(), uniforms)
        x = torch.zeros(num_samples, d, device=dev)  # the zero "sigma_0" input
        hs = cells.stacked_rnn_zero_state(num_samples, self.units, dev)
        draws, site_logps = [], []
        for n in range(self.num_sites):
            logits, hs = self._step_logits(x, hs)
            logp = torch.log_softmax(logits, dim=-1)
            cdf = torch.cumsum(torch.exp(logp), dim=-1)
            draw = torch.clamp((uniforms[:, n, None] >= cdf).sum(-1), max=d - 1)
            draws.append(draw)
            site_logps.append(torch.gather(logp, 1, draw[:, None])[:, 0])
            x = nn.functional.one_hot(draw, d).to(torch.float32)
        samples = torch.stack(draws, dim=1).to(torch.int32)
        return samples, compensated_sum(torch.stack(site_logps))

    def sample(self, num_samples: int, generator: torch.Generator) -> torch.Tensor:
        return self.sample_with_log_prob(num_samples, generator)[0]

    # -- densities ----------------------------------------------------------

    def _log_prob_plain(self, samples: torch.Tensor) -> torch.Tensor:
        """Teacher-forced log p(sigma) for (S, N) int samples; the input at
        site 0 is the zero vector, then the one-hot previous spin."""
        if self._single_gru():
            return fused_gru.log_prob_plain(self.weights(), samples)
        d = self.local_dim
        s, n = samples.shape
        onehot = nn.functional.one_hot(samples.T.long(), d).to(torch.float32)
        inputs = torch.cat([torch.zeros(1, s, d, device=samples.device), onehot[:-1]])
        targets = samples.T.long()
        hs = cells.stacked_rnn_zero_state(s, self.units, samples.device)
        site_logps = []
        for i in range(n):
            logits, hs = self._step_logits(inputs[i], hs)
            logp = torch.log_softmax(logits, dim=-1)
            site_logps.append(torch.gather(logp, 1, targets[i][:, None])[:, 0])
        return compensated_sum(torch.stack(site_logps))

    def _log_prob_ar(self, samples: torch.Tensor) -> torch.Tensor:
        """The autoregressive log p(sigma), through the kernels when
        ``resolve_impl`` picks them."""
        if self._use_kernels():
            return fused_gru.log_prob(self.weights(), samples)
        return self._log_prob_plain(samples)

    def log_prob(self, samples: torch.Tensor) -> torch.Tensor:
        """log p(sigma); parity-symmetrized when ``parity=True``."""
        lp = self._log_prob_ar(samples)
        if not self.parity:
            return lp
        lp_rev = self._log_prob_ar(samples.flip(1).contiguous())
        return torch.logaddexp(lp, lp_rev) - math.log(2.0)

    def log_amp(self, samples: torch.Tensor) -> torch.Tensor:
        """log psi = 0.5 log p (positive wavefunction)."""
        return 0.5 * self.log_prob(samples)
