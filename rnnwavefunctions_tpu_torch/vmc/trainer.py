"""The VMC trainer: sampling, local energies, and an Adam or minSR update.

Counterpart of ``rnnwavefunctions_tpu/vmc/trainer.py`` for one device and a
constant learning rate.  One step:

1. sample + local energies: the fused kernels (K3 for the pRNN on the
   TFIM, B6 in both modes for the parity pRNN, B16 for the 2D MDRNN on the
   grid TFIM, B11 for the cRNN on J1-J2) when ``_select_family`` picks
   them, else the ansatz's sampler and the generic estimator;
2. the surrogate loss on ``ansatz.log_amp`` (kernels K1 forward and K2
   backward for the pRNN, twice for parity, B12 and B14 for the MDRNN), or
   for a complex ansatz on ``ansatz.log_amp_parts`` (B9's replay forward
   and B9 backward), when the ansatz runs its kernels;
3. ``torch.optim.Adam``, whose update ``lr * m_hat / (sqrt(v_hat) + eps)``
   is optax's ``adam`` with ``eps_root=0``.

With ``optimizer="minsr"`` steps 2 and 3 become: the per-sample rows of
d log psi (``vmc/jacobian.py``; on the card the kernels B17, or B19 and B20
for the cRNN), the sample-space SR direction (``vmc/minsr.py``: Gram and
back-contraction by ``torch.matmul``, the solve by the CG kernel B21 or a
Cholesky), written into the parameters' ``.grad`` and applied by
``torch.optim.SGD`` (optax's ``sgd``: ``p -= lr * direction``).

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

from ..interop import param_tree, tree_leaves
from . import minsr
from .local_energy import make_fused_sample_energy_fn, make_local_energy_fn
from .loss import surrogate_loss


def _check_optimizer(config: "TrainConfig") -> None:
    """The JAX package's checks of the optimizer settings."""
    if config.optimizer not in ("adam", "minsr"):
        raise ValueError(
            f"unknown optimizer {config.optimizer!r} (expected 'adam' or 'minsr')"
        )
    if config.optimizer != "minsr":
        return
    if not config.sr_damping > 0.0:
        raise ValueError(
            "sr_damping must be > 0 (the push-through identity needs a positive "
            f"diagonal shift); got {config.sr_damping}"
        )
    if config.sr_solver not in minsr.SOLVERS:
        raise ValueError(f"unknown sr_solver {config.sr_solver!r} (expected 'chol' or 'cg')")
    if config.sr_solver == "cg" and config.sr_cg_iters < 1:
        raise ValueError(f"sr_cg_iters must be >= 1; got {config.sr_cg_iters}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters; defaults mirror the reference trainer signature
    (500 samples, lr 5e-3, Adam) and the JAX package's minSR settings.  The
    schedules other than "constant" are not ported yet."""

    num_samples: int = 500
    learning_rate: float = 5e-3
    schedule: str = "constant"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # "adam" or "minsr" (stochastic reconfiguration in sample space)
    optimizer: str = "adam"
    # minSR's diagonal shift lam in (S + lam I)^{-1} F (absolute)
    sr_damping: float = 1e-2
    # the JAX package's MXU precision of the Gram and back-contraction; on
    # the card both are float32 matmuls with TF32 off, whatever it says
    sr_precision: str = "high"
    # "chol" (Cholesky) or "cg" (sr_cg_iters steps of the CG kernel B21)
    sr_solver: str = "cg"
    sr_cg_iters: int = 64
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
        _check_optimizer(config)
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
        if c.optimizer == "minsr":
            optimizer = torch.optim.SGD(self.ansatz.parameters(), lr=c.learning_rate)
        else:
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
        """One optimizer step on given samples and local energies (``e_im``
        for a complex ansatz): the surrogate-loss gradient and Adam, or the
        minSR direction and SGD; returns the step's metrics (0-dim tensors).
        A complex ansatz's loss runs on its own teacher-forced
        ``log_amp_parts`` of the samples."""
        e_loc = e_loc.detach()
        e_mean = e_loc.mean()
        var_e = ((e_loc - e_mean) ** 2).mean()
        metrics = {"mean_energy": e_mean, "var_energy": var_e}
        state.optimizer.zero_grad(set_to_none=True)
        is_complex = getattr(self.ansatz, "is_complex", False)
        e_im_mean = None
        if is_complex:
            e_im = e_im.detach()
            e_im_mean = e_im.mean()
            metrics["mean_energy_im"] = e_im_mean
        if self.config.optimizer == "minsr":
            self._set_minsr_direction(samples, e_loc, e_im, e_mean, e_im_mean)
        else:
            la_re, la_im = (self.ansatz.log_amp_parts(samples) if is_complex
                            else (self.ansatz.log_amp(samples), None))
            surrogate_loss(la_re, la_im, e_loc, e_im, e_mean, e_im_mean).backward()
        state.optimizer.step()
        state.step += 1
        return metrics

    @torch.no_grad()
    def _set_minsr_direction(self, samples, e_loc, e_im, e_mean, e_im_mean) -> None:
        """The minSR direction of these samples into every parameter's
        ``.grad``."""
        c = self.config
        rows_re, rows_im = minsr.per_sample_log_amp_grad_trees(self.ansatz, samples)
        direction = minsr.minsr_direction_tree(
            rows_re, rows_im, e_loc, e_im, e_mean, e_im_mean, c.sr_damping,
            solver=c.sr_solver, cg_iters=c.sr_cg_iters,
        )
        for p, d in zip(tree_leaves(param_tree(self.ansatz)), tree_leaves(direction)):
            p.grad = d

    def step(self, state: TrainState):
        """One VMC update.  Returns (state, metrics dict of 0-dim tensors)."""
        samples, e_re, e_im = self._sample_and_energy(state)
        return state, self._update(state, samples, e_re, e_im)

    def run_steps(self, state: TrainState, num_steps: int):
        """``num_steps`` updates; returns (state, metrics with a leading
        ``num_steps`` axis).  Metrics stay on the device until read."""
        ms = [self.step(state)[1] for _ in range(num_steps)]
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
