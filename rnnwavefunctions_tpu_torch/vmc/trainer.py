"""The VMC trainer: sampling, local energies, gradient and Adam update.

Counterpart of ``rnnwavefunctions_tpu/vmc/trainer.py`` for one device, the
Adam optimizer and a constant learning rate.  One step:

1. sample + local energies: the fused kernels (K3 for the pRNN on the
   TFIM, B6 in both modes for the parity pRNN, B16 for the 2D MDRNN on the
   grid TFIM, B11 for the cRNN on J1-J2) when ``_select_family`` picks
   them, else the ansatz's sampler and the generic estimator;
2. the surrogate loss on ``ansatz.log_amp`` (kernels K1 forward and K2
   backward for the pRNN, twice for parity, B12 and B14 for the MDRNN), or
   for a complex ansatz on ``ansatz.log_amp_parts`` (B7 forward and B9
   backward), when the ansatz runs its kernels;
3. ``torch.optim.Adam``, whose update ``lr * m_hat / (sqrt(v_hat) + eps)``
   is optax's ``adam`` with ``eps_root=0``.

The parameters live in the ansatz module and are updated in place.  Per-step
randomness comes from a CPU ``torch.Generator`` seeded with ``config.seed``:
the kernel gets a (seed, offset) pair drawn from it, so no device sync is
needed to seed a step.  Samples keep the ansatz's own shape ((S, N) chains,
(S, Nx, Ny) lattices): the step only averages over their leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .local_energy import make_fused_sample_energy_fn, make_local_energy_fn
from .loss import surrogate_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters; defaults mirror the reference trainer signature
    (500 samples, lr 5e-3, Adam).  The optimizer is Adam; minSR and the
    other schedules are not ported yet."""

    num_samples: int = 500
    learning_rate: float = 5e-3
    schedule: str = "constant"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # cap on rows per log-amplitude evaluation batch of the generic estimator
    chunk_size: Optional[int] = None
    seed: int = 111


@dataclasses.dataclass
class TrainState:
    """Optimizer state, step count and the per-step generator; the
    parameters themselves are the trainer's ansatz module."""

    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0


class VMCTrainer:
    """Drives VMC steps for (ansatz, hamiltonian) on the ansatz's device."""

    def __init__(self, ansatz: Any, hamiltonian: Any,
                 config: TrainConfig = TrainConfig()):
        if config.schedule != "constant":
            raise ValueError(
                f"schedule {config.schedule!r} is not ported yet (only 'constant')"
            )
        self.ansatz = ansatz
        self.hamiltonian = hamiltonian
        self.config = config
        self.local_energy = make_local_energy_fn(ansatz, hamiltonian, config.chunk_size)
        # the same _select_family predicate backs both the standalone
        # estimator above and this fused sample+energy step
        self._fused_sample_energy = make_fused_sample_energy_fn(ansatz, hamiltonian)

    # -- state --------------------------------------------------------------

    def init(self) -> TrainState:
        """Initialises the ansatz's parameters from ``config.seed`` and
        returns a fresh optimizer state."""
        self.ansatz.init(torch.Generator().manual_seed(self.config.seed))
        c = self.config
        optimizer = torch.optim.Adam(
            self.ansatz.parameters(), lr=c.learning_rate, betas=(c.b1, c.b2), eps=c.eps
        )
        return TrainState(optimizer, torch.Generator().manual_seed(c.seed))

    # -- one step -----------------------------------------------------------

    def _log_amp_of_batch(self, samples: torch.Tensor, logp_sampling: torch.Tensor):
        """log psi of a drawn batch, the generic estimator's ratio
        denominators.  Only for a plain positive ansatz is the sampling
        density the wavefunction density, so 0.5 * the sampling log p is
        free; any other real ansatz (parity: a plain sampler under a
        symmetrized density) pays a teacher-forced ``log_amp``, and a
        complex one a teacher-forced (Re, Im) pass."""
        ansatz = self.ansatz
        if getattr(ansatz, "plain_positive", False):
            return 0.5 * logp_sampling
        with torch.no_grad():
            if getattr(ansatz, "is_complex", False):
                return ansatz.log_amp_parts(samples)
            return ansatz.log_amp(samples)

    def _sample_and_energy(self, state: TrainState):
        """Returns (samples, e_re, e_im); e_im is None for a real ansatz."""
        n = self.config.num_samples
        if self._fused_sample_energy is not None:
            seed, offset = torch.randint(
                0, 2**32, (2,), generator=state.generator, dtype=torch.int64
            ).tolist()
            samples, _, e_re, e_im = self._fused_sample_energy(n, seed, offset)
            return samples, e_re, e_im
        samples, logp = self.ansatz.sample_with_log_prob(n, state.generator)
        la = self._log_amp_of_batch(samples, logp) if self.local_energy.needs_log_amp else None
        e_re, e_im, _ = self.local_energy(samples, la)
        return samples, e_re, e_im

    def _update(self, state: TrainState, samples: torch.Tensor, e_loc: torch.Tensor,
                e_im: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Surrogate-loss gradient and one Adam step on given samples and
        local energies (``e_im`` for a complex ansatz); returns the step's
        metrics (0-dim tensors).  A complex ansatz's loss runs on its own
        teacher-forced ``log_amp_parts`` of the samples."""
        e_loc = e_loc.detach()
        e_mean = e_loc.mean()
        var_e = ((e_loc - e_mean) ** 2).mean()
        metrics = {"mean_energy": e_mean, "var_energy": var_e}
        state.optimizer.zero_grad(set_to_none=True)
        if getattr(self.ansatz, "is_complex", False):
            e_im = e_im.detach()
            e_im_mean = e_im.mean()
            la_re, la_im = self.ansatz.log_amp_parts(samples)
            loss = surrogate_loss(la_re, la_im, e_loc, e_im, e_mean, e_im_mean)
            metrics["mean_energy_im"] = e_im_mean
        else:
            loss = surrogate_loss(self.ansatz.log_amp(samples), None, e_loc, None, e_mean, None)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return metrics

    def step(self, state: TrainState):
        """One VMC update.  Returns (state, metrics dict of 0-dim tensors)."""
        samples, e_re, e_im = self._sample_and_energy(state)
        return state, self._update(state, samples, e_re, e_im)

    def run_steps(self, state: TrainState, num_steps: int):
        """``num_steps`` updates; returns (state, metrics with a leading
        ``num_steps`` axis).  Metrics stay on the device until read."""
        ms = [self.step(state)[1] for _ in range(num_steps)]
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
