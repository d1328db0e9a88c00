"""Complex RNN wavefunction with the U(1) zero-magnetisation constraint.

psi(sigma) = prod_n ampl_n(sigma_n) exp(i phase_n(sigma_n)) with a shared
GRU trunk and two heads: the amplitude head ``sqrt(softmax)`` and the phase
head ``pi * softsign``.  For sites ``2n >= N`` the U(1) mask drops a class
that would push either spin count past N/2 and renormalises (``ops/
fused_crnn.py`` has the exact semantics), so every sample of an even chain
has zero magnetisation.

Counterpart of ``rnnwavefunctions_tpu/models/crnn_u1.py`` for uniform GRU
stacks.  log psi travels as the real pair (Re, Im).  When ``resolve_impl``
selects the kernels, a single GRU layer's teacher-forced (Re, Im) runs B7
forward and B9 backward and its sampler runs B8 (``ops/fused_crnn.py``).
Off the kernels every stack runs the ops-level plain loop.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from . import cells
from .base import resolve_device, resolve_impl
from ..ops import fused_crnn
from ..ops.launch import draw_key

_REQUIREMENT = "one GRU layer with local_dim=2 whose weights fit shared memory"


class CRNNU1(nn.Module):
    """Args:
      num_sites: chain length N.
      units: hidden widths per stacked GRU layer (uniform widths).
      local_dim: on-site Hilbert dimension (2).
      u1: enforce zero magnetisation.
      cell: "gru" (LSTM and custom cells are not ported yet).
      impl: "auto", "kernel" or "plain" (``models/base.py``).
      device: where the parameters live; None means the card (raises
        without one: pass device="cpu" to run on the CPU).
    """

    is_complex = True
    plain_positive = False
    head_names = ("head_ampl", "head_phase")  # the parameter pytree's head entries

    def __init__(self, num_sites: int, units: Sequence[int] = (10,), local_dim: int = 2,
                 u1: bool = True, cell: str = "gru", impl: str = "auto", device=None):
        super().__init__()
        units = tuple(units)
        if cell != "gru" or local_dim != 2 or len(set(units)) != 1:
            raise NotImplementedError(
                "not ported yet: CRNNU1 supports cell='gru', local_dim=2 and uniform "
                f"widths; got cell={cell!r}, local_dim={local_dim}, units={units}"
            )
        self.num_sites = num_sites
        self.units = units
        self.local_dim = local_dim
        self.u1 = u1
        self.cell = cell
        self.impl = impl
        dims = (local_dim,) + units
        self.rnn = nn.ModuleList(
            cells.GRUCell(dims[i], dims[i + 1]) for i in range(len(units))
        )
        self.head_ampl = cells.Dense(units[-1], local_dim)
        self.head_phase = cells.Dense(units[-1], local_dim)
        self.to(resolve_device(device))

    def extra_repr(self) -> str:
        return (f"num_sites={self.num_sites}, units={self.units}, u1={self.u1}, "
                f"impl={self.impl!r}")

    @property
    def device(self) -> torch.device:
        return self.head_ampl.w.device

    # -- kernel dispatch ----------------------------------------------------

    def _kernelizable(self) -> bool:
        return fused_crnn.supports(self.num_sites, self.units, self.device)

    def _use_kernels(self) -> bool:
        return resolve_impl(self, self._kernelizable, _REQUIREMENT)

    def weights(self) -> Tuple[torch.Tensor, ...]:
        """(wx, wh, bx, bh) of every layer, then the amplitude head's (w, b)
        and the phase head's (w, b), in the JAX package's layout; for one
        layer, the kernels' 8-tuple."""
        trunk = tuple(getattr(layer, k) for layer in self.rnn for k in ("wx", "wh", "bx", "bh"))
        return trunk + (self.head_ampl.w, self.head_ampl.b, self.head_phase.w,
                        self.head_phase.b)

    # -- parameters ---------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None) -> "CRNNU1":
        """Glorot-uniform weights and zero biases drawn from ``generator``
        (trunk, then the amplitude head, then the phase head); returns
        self."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in self.rnn:
            layer.reset_parameters(generator)
        self.head_ampl.reset_parameters(generator)
        self.head_phase.reset_parameters(generator)
        return self

    # -- sampling -----------------------------------------------------------

    @torch.no_grad()
    def sample_with_log_prob(self, num_samples: int, generator: torch.Generator):
        """Draw ``(num_samples, N)`` int32 spins from |psi|^2 (s = 1 iff
        u >= p0, a masked class never drawn) and return their log |psi|^2.
        The randomness comes from ``generator`` (a CPU generator): the
        kernel gets a (seed, offset) pair drawn from it, the plain loop its
        uniforms."""
        if self._use_kernels():
            seed, offset = draw_key(generator)
            return fused_crnn.crnn_sample(self.weights(), num_samples, self.num_sites,
                                          seed, offset, self.u1)
        uniforms = torch.rand(num_samples, self.num_sites, generator=generator).to(self.device)
        return fused_crnn.sample_plain(self.weights(), uniforms, self.u1)

    def sample(self, num_samples: int, generator: torch.Generator) -> torch.Tensor:
        return self.sample_with_log_prob(num_samples, generator)[0]

    # -- densities ----------------------------------------------------------

    def log_amp_parts(self, samples: torch.Tensor):
        """Teacher-forced (Re, Im) log psi, differentiable; through the
        kernels when ``resolve_impl`` picks them."""
        if self._use_kernels():
            return fused_crnn.log_amp_parts(self.weights(), samples, self.u1)
        return fused_crnn.log_amp_parts_plain(self.weights(), samples, self.u1)

    def log_amp(self, samples: torch.Tensor) -> torch.Tensor:
        """Complex log psi, (S,) complex64: a view over ``log_amp_parts`` for
        analysis; the training path stays real."""
        return torch.complex(*self.log_amp_parts(samples))

    def log_prob(self, samples: torch.Tensor) -> torch.Tensor:
        """log |psi|^2 = 2 Re log psi (the sampling density)."""
        return 2.0 * self.log_amp_parts(samples)[0]
