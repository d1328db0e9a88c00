"""The port's spans (``utils/trace.py``): free without a profiler, nested as
the trainer's phases under one, and leaving training bit for bit as it is."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rnnwavefunctions_tpu_torch import CRNNU1, J1J2, PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from rnnwavefunctions_tpu_torch.utils import trace


def _trainer(**config):
    return VMCTrainer(PRNN1D(6, (8,), device="cpu"), TFIM1D(6, 1.0),
                      TrainConfig(num_samples=16, **config))


def _spans(prof):
    """[(name, innermost enclosing rnnwf span or None)] of the trace."""
    out = []
    for e in prof.events():
        if not e.name.startswith("rnnwf."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("rnnwf."):
            parent = parent.cpu_parent
        out.append((e.name, parent.name if parent is not None else None))
    return out


def test_without_a_profiler_a_span_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert trace.span("rnnwf.a") is trace.span("rnnwf.b")
    trainer = _trainer()
    trainer.fit(2, trainer.init(), log_every=2)
    trainer = _trainer(optimizer="minsr", learning_rate=5e-2)
    trainer.fit(1, trainer.init(), log_every=1)


def test_fit_under_the_profiler_gives_the_trainers_phases_nested():
    trainer = _trainer()
    state = trainer.init()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.fit(2, state, log_every=2)
    spans = _spans(prof)
    assert collections.Counter(name for name, _ in spans) == {
        "rnnwf.block": 1, "rnnwf.readback": 1, "rnnwf.step": 2,
        "rnnwf.sample_energy": 2, "rnnwf.gradient": 2, "rnnwf.gradient.forward": 2,
        "rnnwf.optimizer": 2}
    assert set(spans) == {
        ("rnnwf.block", None), ("rnnwf.readback", None), ("rnnwf.step", "rnnwf.block"),
        ("rnnwf.sample_energy", "rnnwf.step"), ("rnnwf.gradient", "rnnwf.step"),
        ("rnnwf.gradient.forward", "rnnwf.gradient"), ("rnnwf.optimizer", "rnnwf.step")}


@pytest.mark.parametrize("optimizer", ["adam", "minsr"])
@pytest.mark.parametrize("model", ["PRNN1D", "CRNNU1"])
def test_the_loss_gradients_forward_is_one_span_inside_each_adam_gradient(model, optimizer):
    """One ``rnnwf.gradient.forward`` per Adam step, inside its
    ``rnnwf.gradient``, around the forward pass alone (the backward runs
    after it); a minSR step has no loss gradient and none."""
    if model == "CRNNU1":
        ansatz, ham = CRNNU1(6, (8,), device="cpu"), J1J2(6, j2=0.2, marshall_sign=True)
    else:
        ansatz, ham = PRNN1D(6, (8,), device="cpu"), TFIM1D(6, 1.0)
    lr = 5e-2 if optimizer == "minsr" else 5e-3
    trainer = VMCTrainer(ansatz, ham, TrainConfig(num_samples=16, optimizer=optimizer,
                                                  learning_rate=lr))
    state = trainer.init()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.fit(3, state, log_every=3)
    spans = _spans(prof)
    forward = [parent for name, parent in spans if name == "rnnwf.gradient.forward"]
    if optimizer == "minsr":
        assert forward == []
        return
    assert forward == ["rnnwf.gradient"] * 3
    events = {e.name: e for e in prof.events() if e.name.startswith("rnnwf.gradient")}
    assert collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("rnnwf.gradient")) == {
        "rnnwf.gradient": 3, "rnnwf.gradient.forward": 3}
    fwd, whole = events["rnnwf.gradient.forward"], events["rnnwf.gradient"]
    assert fwd.time_range.end < whole.time_range.end


def test_a_minsr_step_under_the_profiler_gives_rows_gram_and_solve_inside_minsr():
    trainer = _trainer(optimizer="minsr", learning_rate=5e-2)
    state = trainer.init()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.step(state)
    spans = _spans(prof)
    assert collections.Counter(name for name, _ in spans) == {
        "rnnwf.step": 1, "rnnwf.sample_energy": 1, "rnnwf.minsr": 1, "rnnwf.minsr.rows": 1,
        "rnnwf.minsr.gram": 1, "rnnwf.minsr.solve": 1, "rnnwf.optimizer": 1}
    assert {("rnnwf.minsr", "rnnwf.step"), ("rnnwf.minsr.rows", "rnnwf.minsr"),
            ("rnnwf.minsr.gram", "rnnwf.minsr"),
            ("rnnwf.minsr.solve", "rnnwf.minsr")} <= set(spans)


def test_training_is_bit_identical_with_the_profiler_on_and_off():
    def run(traced):
        trainer = _trainer()
        state = trainer.init()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                _, energies, variances = trainer.fit(3, state, log_every=2)
        else:
            _, energies, variances = trainer.fit(3, state, log_every=2)
        return energies, variances, [p.detach().clone() for p in trainer.ansatz.parameters()]

    off, on = run(False), run(True)
    assert off[:2] == on[:2]
    assert all(torch.equal(a, b) for a, b in zip(off[2], on[2]))
