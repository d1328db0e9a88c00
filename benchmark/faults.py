"""Faults planted in the program, each of which the correctness check has
to catch: ``plant(trainer, state)`` breaks the trainer on the instance,
underneath everything the benchmark records.

* ``unchanged``: the update returns the state unchanged (the optimizer's
  step does nothing);
* ``half_batch``: the update sees half of the batch, its means taken over
  the rest;
* ``altered``: one drawn spin flipped where the sampler produces it.

(A chip exchange left out is not a fault these one-chip cells can have.)
"""

from __future__ import annotations


def unchanged(trainer, state) -> None:
    state.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer, state) -> None:
    update = trainer._update

    def halved(state, samples, e_loc, e_im=None):
        h = samples.shape[0] // 2
        return update(state, samples[:h], e_loc[:h], None if e_im is None else e_im[:h])

    trainer._update = halved


def _flip_first_spin(out):
    samples = out[0].clone()
    flat = samples.view(samples.shape[0], -1)
    flat[0, 0] = 1 - flat[0, 0]
    return (samples,) + tuple(out[1:])


def altered(trainer, state) -> None:
    # the fused estimator on the card; the plain path's sampler on the CPU
    owner, name = ((trainer, "_fused_sample_energy") if trainer._fused_sample_energy is not None
                   else (trainer.ansatz, "sample_with_log_prob"))
    inner = getattr(owner, name)
    setattr(owner, name, lambda *args, **kwargs: _flip_first_spin(inner(*args, **kwargs)))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
