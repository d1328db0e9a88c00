"""How ``correct`` is decided: the plain reference follows the program's
first updates on the samples the program drew, and each number compared
stays under its cell's limit.

Update k of the reference starts from the program's parameters after its
update k - 1 (the initial weights for the first) and carries its own
optimizer state: it evaluates, with those parameters, the log p and the
local energies of the program's samples of update k, then its own
gradient (Adam cells) or minSR direction (minSR cells) and its own update.
So every update is judged from where the program stood, and round-off
that later updates amplify (``PERF.md``) does not pile up.  The numbers
compared (``readings``):

* ``logp_gap``: the largest |log p| gap over the samples of every update;
* ``eloc_gap``: the largest local-energy gap over the samples of every
  update, over the update's mean |E_loc|;
* ``energy_gap``: the largest gap of the mean energy ``fit`` reported, over
  the reference's |mean energy|, both as complex numbers (a real
  ansatz's with an imaginary part of 0), so that a complex ansatz's
  imaginary part is judged too;
* ``grad_gap``: the first update's direction as the optimizer got it (the
  loss gradient, or the minSR direction), by the worst leaf: the gap of the
  two norms over the larger of the reference leaf's norm and the median
  leaf's;
* ``update_gap``: the parameters' change over the ``steps`` updates (the
  reference's: the sum of its one-update changes), by the worst leaf in
  the same measure, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (a smaller one moves under Adam by
  round-off alone);
* ``nonfinite``: the window's mean energies with a part that is not finite.

The configuration names the reference's modules (``reference`` in its
file): ``model`` (``log_prob``), ``hamiltonian`` (``local_energy``) and
``vmc`` (``loss_gradient``, ``log_psi_rows``, ``minsr_direction``,
``Adam``, ``SGD``), each found as ``benchmark/reference/<name>.py``.
"""

from __future__ import annotations

import cmath
import dataclasses
import importlib
import math
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch

from .reference import FP32, TF32, Precision
from .system import FirstSteps, Params

MOVED = 1e-3  # a leaf moves when its reference gradient is this share of the median leaf's


@dataclasses.dataclass(frozen=True)
class Reference:
    """The configuration's plain reference: its model, its Hamiltonian
    (with ``terms``, the configuration's ``reference`` entry) and its
    VMC update."""

    model: ModuleType
    hamiltonian: ModuleType
    vmc: ModuleType
    terms: Dict


def reference_of(config: Dict) -> Reference:
    terms = config["reference"]

    def module(name: str) -> ModuleType:
        return importlib.import_module(f"benchmark.reference.{name}")

    return Reference(module(terms["model"]), module(terms["hamiltonian"]),
                     module(terms["vmc"]), terms)


def optimizer_of(ref: Reference, traffic: Dict, params: Params):
    """The reference's optimizer of the traffic's kind, at the learning
    rate the program's float32 parameter groups hold."""
    lr = float(torch.tensor(traffic["learning_rate"], dtype=torch.float32))
    return ref.vmc.SGD(params, lr) if traffic["optimizer"] == "minsr" else ref.vmc.Adam(params, lr)


def reference_update(ref: Reference, traffic: Dict, optimizer, params: Params,
                     samples: torch.Tensor, precision: Precision = FP32,
                     e_loc: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Params, Params]:
    """One update of the reference from ``params`` on ``samples``: (log p,
    E_loc, the direction the optimizer got, the parameters after it).  The
    direction is taken from ``e_loc`` where given (the round-off witness),
    else from the reference's own local energies."""
    with torch.no_grad():
        own, lp = ref.hamiltonian.local_energy(ref.model, params, samples, ref.terms,
                                               precision)
    weights = own if e_loc is None else e_loc
    if traffic["optimizer"] == "minsr":
        rows = ref.vmc.log_psi_rows(ref.model, params, samples, precision)
        direction = ref.vmc.minsr_direction(rows, weights, traffic["sr_damping"], precision)
    else:
        direction = ref.vmc.loss_gradient(ref.model, params, samples, weights, precision)
    stepped = {k: v.detach() for k, v in optimizer.step(params, direction).items()}
    return lp, own, direction, stepped


def follow(config: Dict, traffic: Dict, record: FirstSteps,
           precision: Precision = FP32) -> FirstSteps:
    """The reference's first updates on the program's samples, each from
    the program's parameters before it: what it computes where the
    program's ``record`` holds what the program did."""
    ref = reference_of(config)
    optimizer = optimizer_of(ref, traffic, record.params0)
    out = FirstSteps(record.params0, record.steps)
    starts = [record.params0] + record.params[:record.steps - 1]
    change = {k: torch.zeros_like(v) for k, v in record.params0.items()}
    for params, samples in zip(starts, record.samples):
        lp, e_loc, direction, stepped = reference_update(ref, traffic, optimizer, params,
                                                         samples, precision)
        change = {k: change[k] + (stepped[k] - params[k]) for k in change}
        out.samples.append(samples)
        out.log_prob.append(lp)
        out.e_loc.append(e_loc)
        out.energies.append(complex(e_loc.mean()))
        out.params.append({k: record.params0[k] + change[k] for k in change})
        if out.first is None:
            out.first = direction
    return out


def control_record(config: Dict, traffic: Dict, record: FirstSteps) -> FirstSteps:
    """The control: the reference computed in TF32, the precision one step
    below the configurations' float32, put in the program's place on the
    program's samples and states."""
    return follow(config, traffic, record, TF32)


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _leaf_gaps(got: Dict[str, float], ref: Dict[str, float], leaves: List[str]
               ) -> Dict[str, float]:
    median = sorted(ref.values())[len(ref) // 2]
    return {k: abs(got[k] - ref[k]) / max(ref[k], median) for k in leaves}


def _change(rec: FirstSteps) -> Dict[str, float]:
    return _norms({k: rec.params[-1][k] - rec.params0[k] for k in rec.params0})


def by_leaf(got: FirstSteps, ref: FirstSteps) -> Dict[str, Dict[str, float]]:
    """Per leaf, the first direction's gap (``grad``) and the change's
    (``update``, over the leaves that move): the gap of the two norms over
    the larger of the reference leaf's norm and the median leaf's."""
    first_ref = _norms(ref.first)
    median = sorted(first_ref.values())[len(first_ref) // 2]
    moved = [k for k, v in first_ref.items() if v >= MOVED * median]
    return {"grad": _leaf_gaps(_norms(got.first), first_ref, list(first_ref)),
            "update": _leaf_gaps(_change(got), _change(ref), moved)}


def readings(got: FirstSteps, ref: FirstSteps, window_energies: List[complex]
             ) -> Dict[str, float]:
    """The numbers compared: ``got`` is the program's record (or the
    control's), ``ref`` the reference's."""
    logp = max(float((a - b).abs().max()) for a, b in zip(got.log_prob, ref.log_prob))
    eloc = max(float((a - b).abs().max() / b.abs().mean()) for a, b in zip(got.e_loc, ref.e_loc))
    energy = max(abs(a - b) / abs(b) for a, b in zip(got.energies, ref.energies))
    leaves = by_leaf(got, ref)
    nonfinite = sum(1 for e in window_energies if not cmath.isfinite(e))
    return {"logp_gap": logp, "eloc_gap": eloc, "energy_gap": energy,
            "grad_gap": max(leaves["grad"].values()),
            "update_gap": max(leaves["update"].values()), "nonfinite": float(nonfinite)}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number present, finite and at most its limit."""
    return all(k in values and math.isfinite(values[k]) and values[k] <= limit
               for k, limit in limits.items())


@dataclasses.dataclass
class Verdict:
    correct: bool
    values: Dict[str, float]
    limits: Dict[str, float]

    def lines(self) -> List[str]:
        return [f"check {k}: {self.values.get(k, math.nan)!r} <= limit {v!r}"
                for k, v in self.limits.items()]

    def as_json(self) -> Dict[str, Dict[str, float]]:
        return {k: {"value": self.values.get(k, math.nan), "limit": v}
                for k, v in self.limits.items()}


def by_step(got: FirstSteps, ref: FirstSteps) -> Dict[str, List[float]]:
    """Each update's log p and local-energy gaps (the calibration's look)."""
    return {"logp_gap": [float((a - b).abs().max()) for a, b in zip(got.log_prob, ref.log_prob)],
            "eloc_gap": [float((a - b).abs().max() / b.abs().mean())
                         for a, b in zip(got.e_loc, ref.e_loc)],
            "energy_gap": [abs(a - b) / abs(b) for a, b in zip(got.energies, ref.energies)]}


def decide(config: Dict, traffic: Dict, record: FirstSteps, window_energies: List[complex],
           limits: Dict[str, float]) -> Verdict:
    values = readings(record, follow(config, traffic, record), window_energies)
    return Verdict(judge(values, limits), values, limits)
