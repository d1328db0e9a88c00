"""The system under test, built from a configuration and a traffic mix:
``rnnwavefunctions_tpu_torch``'s ``VMCTrainer`` on the card, its initial
weights made by the benchmark from the seed, and a record of what its first
updates produce, read where the program produces it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

Params = Dict[str, torch.Tensor]


def train_config_kwargs(traffic: Dict, seed: int) -> Dict:
    """The traffic's ``TrainConfig`` fields, and the seed."""
    from rnnwavefunctions_tpu_torch import TrainConfig

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return {**{k: v for k, v in traffic.items() if k in fields}, "seed": seed}


def build(config: Dict, traffic: Dict, seed: int, device, mark=lambda name: None):
    """(trainer, state, initial weights): the configuration's ansatz and
    Hamiltonian on ``traffic["lattice"]``, a ``VMCTrainer`` for the
    traffic's optimizer, and the weights ``make_weights`` drew;
    ``mark(part)`` is called as each part is done."""
    import rnnwavefunctions_tpu_torch as port

    program, lattice = config["program"], traffic["lattice"]
    ansatz = getattr(port, program["ansatz"])(**lattice, **program["ansatz_kwargs"],
                                              device=device)
    hamiltonian = getattr(port, program["hamiltonian"])(**lattice,
                                                        **program["hamiltonian_kwargs"])
    mark("ansatz")
    trainer = port.VMCTrainer(ansatz, hamiltonian,
                              port.TrainConfig(**train_config_kwargs(traffic, seed)))
    state = trainer.init()
    mark("trainer")
    weights = make_weights(ansatz, seed)
    mark("weights")
    return trainer, state, weights


@torch.no_grad()
def make_weights(ansatz: torch.nn.Module, seed: int) -> Params:
    """Glorot-uniform matrices and zero biases, the published
    initialisation, drawn from ``seed`` on the parameters' device in one
    call and copied into ``ansatz``; returns a copy of them by parameter
    name."""
    named = list(ansatz.named_parameters())
    device = named[0][1].device
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(p.numel() for _, p in named), generator=gen, device=device)
    weights, offset = {}, 0
    for name, p in named:
        part = draw[offset:offset + p.numel()].reshape(p.shape)
        offset += p.numel()
        if p.dim() >= 2:
            limit = math.sqrt(6.0 / (p.shape[0] + p.shape[-1]))
            weights[name] = (2.0 * part - 1.0) * limit
        else:
            weights[name] = torch.zeros_like(part)
        p.copy_(weights[name])
    return weights


def current_params(ansatz: torch.nn.Module) -> Params:
    return {name: p.detach().clone() for name, p in ansatz.named_parameters()}


def first_direction(optimizer: torch.optim.Optimizer, params0: Params, params1: Params,
                    names: Dict[int, str]) -> Params:
    """The first update's direction as the optimizer got it, worked out
    from its state after one step: Adam's first moment over (1 - b1), or
    SGD's (p0 - p1) / lr.  A parameter the optimizer never stepped reads
    zero."""
    group = optimizer.param_groups[0]
    if isinstance(optimizer, torch.optim.Adam):
        b1 = group["betas"][0]
        out = {}
        for p in group["params"]:
            m = optimizer.state.get(p, {}).get("exp_avg")
            out[names[id(p)]] = (m / (1.0 - b1) if m is not None
                                 else torch.zeros_like(p)).detach().clone()
        return out
    return {k: (params0[k] - params1[k]) / group["lr"] for k in params0}


@dataclasses.dataclass
class FirstSteps:
    """What the timed path produced in its first ``steps`` updates: per
    update the drawn samples, their log p and local energies as the
    estimator returned them, and the parameters after it; the first
    direction as the optimizer got it; and (``energies``, set by the
    caller) the mean energies that ``fit`` reported, as complex numbers
    (a real ansatz's with an imaginary part of 0)."""

    params0: Params
    steps: int
    samples: List[torch.Tensor] = dataclasses.field(default_factory=list)
    log_prob: List[torch.Tensor] = dataclasses.field(default_factory=list)
    e_loc: List[torch.Tensor] = dataclasses.field(default_factory=list)
    params: List[Params] = dataclasses.field(default_factory=list)
    first: Optional[Params] = None
    energies: List[complex] = dataclasses.field(default_factory=list)


class Recorder:
    """Wraps the trainer's estimator (on the card, every configuration's
    fused one), its log p source and its update on the instance, for the
    first ``steps`` updates; ``remove`` restores them."""

    def __init__(self, trainer, state, params0: Params, steps: int):
        self.trainer, self.state = trainer, state
        self.record = FirstSteps(params0, steps)
        self.names = {id(p): n for n, p in trainer.ansatz.named_parameters()}
        self._installed = []
        if trainer._fused_sample_energy is not None:
            # (samples, log psi, e_re, e_im): log psi is a tensor, or for a
            # complex amplitude its (Re, Im) pair; log p = 2 Re log psi
            self._wrap(trainer, "_fused_sample_energy", self._log_amp)
        else:
            # the plain path on the CPU, which the harness's tests drive
            self._wrap(trainer.ansatz, "sample_with_log_prob",
                       lambda out: self.record.log_prob.append(out[1].detach().double()))
        self._wrap(trainer, "_sample_and_energy", self._estimated)
        update = trainer._update

        def recorded_update(*args, **kwargs):
            out = update(*args, **kwargs)
            self._updated()
            return out

        self._installed.append((trainer, "_update", trainer.__dict__.get("_update")))
        trainer._update = recorded_update

    def _wrap(self, owner, name, on_output):
        inner = getattr(owner, name)

        def wrapped(*args, **kwargs):
            out = inner(*args, **kwargs)
            if self._active():
                on_output(out)
            return out

        self._installed.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapped)

    def _active(self) -> bool:
        return len(self.record.params) < self.record.steps

    def _log_amp(self, out):
        re = out[1][0] if isinstance(out[1], tuple) else out[1]
        self.record.log_prob.append(2.0 * re.detach().double())

    def _estimated(self, out):
        samples, e_re, e_im = out
        e_loc = e_re.detach().double()
        if e_im is not None:
            e_loc = torch.complex(e_loc, e_im.detach().double())
        self.record.samples.append(samples.detach().clone())
        self.record.e_loc.append(e_loc)

    def _updated(self):
        rec = self.record
        if not self._active():
            return
        rec.params.append(current_params(self.trainer.ansatz))
        if len(rec.params) == 1:
            rec.first = first_direction(self.state.optimizer, rec.params0, rec.params[0],
                                        self.names)

    def remove(self) -> FirstSteps:
        for owner, name, previous in reversed(self._installed):
            if previous is None:
                delattr(owner, name)
            else:
                setattr(owner, name, previous)
        self._installed = []
        return self.record
