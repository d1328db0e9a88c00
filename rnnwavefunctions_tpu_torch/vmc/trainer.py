"""The VMC trainer: sampling, local energies, and an Adam or minSR update.

Counterpart of ``rnnwavefunctions_tpu/vmc/trainer.py`` for one device.  One
step:

1. sample + local energies: the fused kernels (K3 for the pRNN on the
   TFIM, B6 in both modes for the parity pRNN, B16 for the 2D MDRNN on the
   grid TFIM, B11 for the cRNN on J1-J2) when ``_select_family`` picks
   them, else the ansatz's sampler and the generic estimator;
2. the surrogate loss on ``ansatz.log_amp`` (kernels K1 forward and K2
   backward for the pRNN, twice for parity, B12 and B14 for the MDRNN), or
   for a complex ansatz on ``ansatz.log_amp_parts`` (B9's replay forward
   and B9 backward), when the ansatz runs its kernels;
3. ``torch.optim.Adam``, whose update ``lr * m_hat / (sqrt(v_hat) + eps)``
   is optax's ``adam`` with ``eps_root=0``; update k (counting from 0)
   takes the learning rate ``make_schedule(config)(k)``, as optax's count
   does.

With ``optimizer="minsr"`` steps 2 and 3 become: the per-sample rows of
d log psi (``vmc/jacobian.py``; on the card the kernels B17, or B19 and B20
for the cRNN), the sample-space SR direction (``vmc/minsr.py``: Gram and
back-contraction by ``torch.matmul``, the solve by the CG kernel B21 or a
Cholesky), written into the parameters' ``.grad`` and applied by
``torch.optim.SGD`` (optax's ``sgd``: ``p -= lr * direction``).

The parameters live in the ansatz module and are updated in place.  Per-step
randomness comes from a CPU ``torch.Generator`` seeded with ``config.seed``:
the kernel gets a (seed, offset) pair drawn from it, so no device sync is
needed to seed a step.  Where the JAX trainer folds the step count into a
key, this generator is the whole stream: a run is a function of
``config.seed`` and of the steps taken, and a checkpoint carries the
generator's state (``utils/checkpoints.py``).  Samples keep the ansatz's
own shape ((S, N) chains, (S, Nx, Ny) lattices): the step only averages
over their leading axis.

The phases run inside the spans of ``utils/trace.py`` (``rnnwf.block``,
``rnnwf.step``, ``rnnwf.sample_energy``, ``rnnwf.key_draw``,
``rnnwf.gradient`` with its forward ``rnnwf.gradient.forward``,
``rnnwf.minsr`` and its parts, ``rnnwf.optimizer``,
``rnnwf.readback``): profiler ranges while a profiler runs, one check
otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..interop import param_tree, tree_leaves
from ..ops.launch import draw_key
from ..utils.trace import span
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
    (500 samples, lr 5e-3, Adam) and the JAX package's schedule and minSR
    settings."""

    num_samples: int = 500
    learning_rate: float = 5e-3
    # "constant"; "inverse" lr / (1 + step / decay_scale); "harmonic"
    # 1 / (1 / lr + step / decay_scale); "exponential"
    # lr * decay_rate^(step / decay_steps), the exponent floored under
    # staircase; "staged" lr times lr_stage_scales[i] once step >=
    # lr_stage_bounds[i] (the scales compound)
    schedule: str = "constant"
    decay_scale: float = 10.0
    decay_rate: float = 1.0
    decay_steps: int = 100
    staircase: bool = True
    lr_stage_bounds: tuple = ()
    lr_stage_scales: tuple = ()
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


def make_schedule(config: TrainConfig) -> Callable[[int], float]:
    """The learning rate of update ``step`` (counting from 0), evaluated in
    float32 as the JAX package's schedules are (its ``make_schedule``);
    raises ``ValueError`` for an unknown schedule and for staged lists that
    do not match or bounds that do not ascend."""
    f32 = np.float32
    lr = config.learning_rate
    if config.schedule == "constant":
        return lambda step: float(f32(lr))
    if config.schedule == "inverse":
        return lambda step: float(f32(lr) / (f32(1.0) + f32(step) / f32(config.decay_scale)))
    if config.schedule == "harmonic":
        # 1 / lr is a Python float there, rounded to float32 where it meets
        # the step
        return lambda step: float(
            f32(1.0) / (f32(1.0 / lr) + f32(step) / f32(config.decay_scale)))
    if config.schedule == "exponential":

        def exp_schedule(step):
            p = f32(step) / f32(config.decay_steps)
            if config.staircase:
                p = np.floor(p)
            return float(f32(lr) * f32(config.decay_rate) ** p)

        return exp_schedule
    if config.schedule == "staged":
        bounds = tuple(config.lr_stage_bounds)
        scales = tuple(config.lr_stage_scales)
        if len(bounds) != len(scales):
            raise ValueError(
                f"staged schedule needs matching lr_stage_bounds/"
                f"lr_stage_scales; got {len(bounds)} vs {len(scales)}"
            )
        if list(bounds) != sorted(bounds):
            raise ValueError(f"lr_stage_bounds must ascend; got {bounds}")

        def staged_schedule(step):
            f = f32(lr)
            for b, sc in zip(bounds, scales):
                f = f * (f32(sc) if step >= b else f32(1.0))
            return float(f)

        return staged_schedule
    raise ValueError(f"unknown schedule {config.schedule!r}")


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
        _check_optimizer(config)
        self.schedule = make_schedule(config)
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
        with span("rnnwf.sample_energy"):
            n = self.config.num_samples
            if self._fused_sample_energy is not None:
                with span("rnnwf.key_draw"):
                    seed, offset = draw_key(state.generator)
                samples, _, e_re, e_im = self._fused_sample_energy(n, seed, offset)
                return samples, e_re, e_im
            samples, logp = self.ansatz.sample_with_log_prob(n, state.generator)
            la = (self._log_amp_of_batch(samples, logp) if self.local_energy.needs_log_amp
                  else None)
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
            with span("rnnwf.gradient"):
                with span("rnnwf.gradient.forward"):
                    la_re, la_im = (self.ansatz.log_amp_parts(samples) if is_complex
                                    else (self.ansatz.log_amp(samples), None))
                surrogate_loss(la_re, la_im, e_loc, e_im, e_mean, e_im_mean).backward()
        lr = self.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        with span("rnnwf.optimizer"):
            state.optimizer.step()
        state.step += 1
        return metrics

    @torch.no_grad()
    def _set_minsr_direction(self, samples, e_loc, e_im, e_mean, e_im_mean) -> None:
        """The minSR direction of these samples into every parameter's
        ``.grad``."""
        c = self.config
        with span("rnnwf.minsr"):
            rows_re, rows_im = minsr.per_sample_log_amp_grad_trees(self.ansatz, samples)
            direction = minsr.minsr_direction_tree(
                rows_re, rows_im, e_loc, e_im, e_mean, e_im_mean, c.sr_damping,
                solver=c.sr_solver, cg_iters=c.sr_cg_iters,
            )
        for p, d in zip(tree_leaves(param_tree(self.ansatz)), tree_leaves(direction)):
            p.grad = d

    def step(self, state: TrainState):
        """One VMC update.  Returns (state, metrics dict of 0-dim tensors)."""
        with span("rnnwf.step"):
            samples, e_re, e_im = self._sample_and_energy(state)
            return state, self._update(state, samples, e_re, e_im)

    def run_steps(self, state: TrainState, num_steps: int):
        """``num_steps`` updates; returns (state, metrics with a leading
        ``num_steps`` axis).  Metrics stay on the device until read."""
        with span("rnnwf.block"):
            ms = [self.step(state)[1] for _ in range(num_steps)]
            return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    # -- training loop (the run_X equivalent) -------------------------------

    def fit(self, num_steps: int, state: Optional[TrainState] = None, log_every: int = 10,
            callback: Optional[Callable[[int, Dict[str, Any]], None]] = None):
        """Trains for ``num_steps``; returns (state, meanE list, varE list),
        the reference's ``run_X`` contract.  Blocks of ``log_every`` steps
        run back to back (``run_steps``), each block's metrics read in one
        device-to-host copy.  The JAX ``fit`` takes a key; here the
        state's generator, seeded from ``config.seed``, is the stream."""
        if state is None:
            state = self.init()
        mean_energy, var_energy = [], []
        it = 0
        while it < num_steps:
            block = min(log_every, num_steps - it)
            state, ms = self.run_steps(state, block)
            for j, (me, ve) in enumerate(decode_metrics_block(ms)):
                mean_energy.append(me)
                var_energy.append(ve)
                if callback is not None and (it + j) % log_every == 0:
                    callback(it + j, {"mean_energy": me, "var_energy": ve})
            it += block
        return state, mean_energy, var_energy


def decode_metrics_block(ms: Dict[str, torch.Tensor]) -> List[Tuple[Union[float, complex], float]]:
    """One ``run_steps`` metrics block (leading axis = steps) as host-side
    (mean_energy, var_energy) pairs, in one device-to-host copy; a complex
    ansatz's mean comes back as ``complex(Re, Im)``.  Shared by ``fit`` and
    the CLI loop (``cli/run_loop.py``)."""
    keys = ["mean_energy", "var_energy"] + (["mean_energy_im"] if "mean_energy_im" in ms else [])
    with span("rnnwf.readback"):
        rows = torch.stack([ms[k] for k in keys]).cpu().tolist()
    if len(rows) == 3:
        return [(complex(re, im), ve) for re, ve, im in zip(*rows)]
    return list(zip(*rows))
