"""True 2D RNN wavefunction: the MDRNN cell over a boustrophedon sweep,
psi(sigma) = sqrt(p(sigma)).

Counterpart of ``rnnwavefunctions_tpu/models/mdrnn2d.py`` in float32.  Sites
are visited left to right on even rows and right to left on odd rows; each
site's cell consumes the (spin, cell output) pair of its horizontal
predecessor in visit order and of its neighbour in the row above, with zero
inputs and states on the lattice boundary; one shared cell, a softmax dense
head and exact categorical site draws.  Samples are (S, Nx, Ny) int32 grids
indexed [s, x, y], consumed by ``TFIM2D(encoding="grid")``.

When ``resolve_impl`` selects the kernels, the teacher-forced log p runs B12
forward and B14 backward (``ops/fused_mdrnn.py``) and the sampler runs B13.
Off the kernels, ``local_dim=2`` runs the kernels' plain versions and any
other ``local_dim`` the plain sweep below.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from . import cells
from .base import resolve_device, resolve_impl
from ..ops import fused_mdrnn
from ..ops.compsum import compensated_sum
from ..ops.launch import draw_key

_REQUIREMENT = "local_dim=2 on a lattice whose row buffers and weights fit shared memory"


class MDRNN2D(nn.Module):
    """Args:
      nx, ny: lattice size.
      units: hidden width U of the cell.
      local_dim: on-site Hilbert dimension.
      impl: "auto", "kernel" or "plain" (``models/base.py``).
      device: where the parameters live; None means the card (raises
        without one: pass device="cpu" to run on the CPU).
    """

    is_complex = False
    plain_positive = True
    # the parameter pytree's entries (interop.py): the cell's tensors and the head
    cell_trees = {"cell": ("uh", "uv", "wh", "wv", "b")}
    head_names = ("head",)

    def __init__(self, nx: int, ny: int, units: int = 50, local_dim: int = 2,
                 impl: str = "auto", device=None):
        super().__init__()
        self.nx, self.ny = nx, ny
        self.units = units
        self.local_dim = local_dim
        self.impl = impl
        self.cell = cells.MDRNNCell(local_dim, units)
        self.head = cells.Dense(units, local_dim)
        self.to(resolve_device(device))

    def extra_repr(self) -> str:
        return (f"nx={self.nx}, ny={self.ny}, units={self.units}, "
                f"local_dim={self.local_dim}, impl={self.impl!r}")

    @property
    def device(self) -> torch.device:
        return self.head.w.device

    # -- kernel dispatch ----------------------------------------------------

    def _kernelizable(self) -> bool:
        return self.local_dim == 2 and fused_mdrnn.supports(
            self.nx, self.ny, self.units, self.device)

    def _use_kernels(self) -> bool:
        return resolve_impl(self, self._kernelizable, _REQUIREMENT)

    def weights(self) -> Tuple[torch.Tensor, ...]:
        """The kernel weight tuple (uh, uv, wh, wv, b, head w, head b) in
        the JAX package's layout."""
        c = self.cell
        return (c.uh, c.uv, c.wh, c.wv, c.b, self.head.w, self.head.b)

    # -- parameters ---------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None) -> "MDRNN2D":
        """Glorot-uniform weights and zero biases drawn from ``generator``
        (the cell's uh, uv, wh, wv, then the head); returns self."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cell.reset_parameters(generator)
        self.head.reset_parameters(generator)
        return self

    # -- the plain sweep for any local_dim ------------------------------------

    def _sweep(self, batch: int, pick: Callable[[int, torch.Tensor], torch.Tensor]):
        """Boustrophedon sweep; ``pick(m, logp)`` gives the (B,) spins at
        visit position m from its (B, d) log-probs.  Returns (samples
        (B, Nx, Ny) int32, log p (B,) Kahan-summed in lattice order)."""
        nx, ny, d, dev = self.nx, self.ny, self.local_dim, self.device
        xx, _ = fused_mdrnn.visit_order(nx, ny)
        zero_h = torch.zeros(batch, self.units, device=dev)
        zero_x = torch.zeros(batch, d, device=dev)
        row_h, row_x = [zero_h] * nx, [zero_x] * nx
        h, x = zero_h, zero_x
        draws, logps = [None] * (nx * ny), [None] * (nx * ny)
        for m in range(nx * ny):
            y, k, col = m // nx, m % nx, int(xx[m])
            hh, xh = (h, x) if k > 0 else (zero_h, zero_x)
            hv, xv = (row_h[col], row_x[col]) if y > 0 else (zero_h, zero_x)
            h = self.cell(xh, xv, hh, hv)
            logp = torch.log_softmax(self.head(h), dim=-1)
            draw = pick(m, logp)
            x = nn.functional.one_hot(draw, d).to(torch.float32)
            row_h[col], row_x[col] = h, x
            draws[y * nx + col] = draw
            logps[y * nx + col] = torch.gather(logp, 1, draw[:, None])[:, 0]
        samples = torch.stack(draws, dim=1).reshape(batch, ny, nx).transpose(1, 2)
        return samples.to(torch.int32).contiguous(), compensated_sum(torch.stack(logps))

    # -- sampling -----------------------------------------------------------

    @torch.no_grad()
    def sample_with_log_prob(self, num_samples: int, generator: torch.Generator):
        """Draw ``(num_samples, Nx, Ny)`` int32 spins by inverse-CDF sampling
        of each site's conditional (s = 1 iff u >= p0 for two local states)
        and return their log-density.  The randomness comes from
        ``generator`` (a CPU generator): the kernel gets a (seed, offset)
        pair drawn from it, the plain sweeps its uniforms (visit order)."""
        nx, ny = self.nx, self.ny
        if self._use_kernels():
            seed, offset = draw_key(generator)
            return fused_mdrnn.mdrnn_sample(self.weights(), num_samples, nx, ny, seed, offset)
        uniforms = torch.rand(num_samples, nx * ny, generator=generator).to(self.device)
        if self.local_dim == 2:
            return fused_mdrnn.sample_plain(self.weights(), uniforms, nx, ny)
        d = self.local_dim

        def pick(m, logp):
            cdf = torch.cumsum(torch.exp(logp), dim=-1)
            return torch.clamp((uniforms[:, m, None] >= cdf).sum(-1), max=d - 1)

        return self._sweep(num_samples, pick)

    def sample(self, num_samples: int, generator: torch.Generator) -> torch.Tensor:
        return self.sample_with_log_prob(num_samples, generator)[0]

    # -- densities ----------------------------------------------------------

    def _log_prob_plain(self, samples: torch.Tensor) -> torch.Tensor:
        """Teacher-forced log p(sigma) for (S, Nx, Ny) int samples."""
        if self.local_dim == 2:
            return fused_mdrnn.log_prob_plain(self.weights(), samples)
        xx, yy = fused_mdrnn.visit_order(self.nx, self.ny)
        targets = samples.long()
        return self._sweep(samples.shape[0],
                           lambda m, logp: targets[:, xx[m], yy[m]])[1]

    def log_prob(self, samples: torch.Tensor) -> torch.Tensor:
        """log p(sigma), through the kernels when ``resolve_impl`` picks them."""
        if self._use_kernels():
            return fused_mdrnn.log_prob(self.weights(), samples)
        return self._log_prob_plain(samples)

    def log_amp(self, samples: torch.Tensor) -> torch.Tensor:
        """log psi = 0.5 log p (positive wavefunction)."""
        return 0.5 * self.log_prob(samples)
