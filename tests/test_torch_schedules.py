"""PyTorch port: the learning-rate schedules against the JAX package's
``make_schedule``, and Adam and minSR updates under them against optax on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.tree_utils as otu
import pytest
import torch

from rnnwavefunctions_tpu.hamiltonians.tfim1d import TFIM1D as JTFIM1D
from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.vmc import local_energy as jle
from rnnwavefunctions_tpu.vmc import minsr as jminsr
from rnnwavefunctions_tpu.vmc.loss import surrogate_loss as jsurrogate_loss
from rnnwavefunctions_tpu.vmc.trainer import TrainConfig as JTrainConfig
from rnnwavefunctions_tpu.vmc.trainer import make_schedule as jmake_schedule
from rnnwavefunctions_tpu_torch import PRNN1D, TFIM1D, TrainConfig, VMCTrainer, interop
from rnnwavefunctions_tpu_torch.vmc.trainer import make_schedule

torch.set_num_threads(1)

N, U, B = 8, 12, 24
STEPS = (0, 1, 7, 99, 100, 101, 10**4)

# id -> TrainConfig kwargs, the same for both packages
SCHEDULES = {
    "constant": dict(schedule="constant", learning_rate=5e-3),
    "inverse": dict(schedule="inverse", learning_rate=5e-3, decay_scale=10.0),
    "inverse-scale-1": dict(schedule="inverse", learning_rate=1e-2, decay_scale=1.0),
    "harmonic": dict(schedule="harmonic", learning_rate=5e-3, decay_scale=10.0),
    "exponential-staircase": dict(schedule="exponential", learning_rate=5e-3,
                                  decay_rate=0.5, decay_steps=100, staircase=True),
    "exponential-smooth": dict(schedule="exponential", learning_rate=5e-3,
                               decay_rate=0.5, decay_steps=100, staircase=False),
    "exponential-reference": dict(schedule="exponential", learning_rate=5e-3),
    "staged": dict(schedule="staged", learning_rate=5e-2, lr_stage_bounds=(7, 100),
                   lr_stage_scales=(0.1, 0.2)),
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_rates_match_jax(name):
    kwargs = SCHEDULES[name]
    got = make_schedule(TrainConfig(**kwargs))
    want = jmake_schedule(JTrainConfig(**kwargs))
    for step in STEPS:
        w = float(want(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got(step), w, rtol=1e-6, err_msg=f"step {step}")


def _jax_side(seed):
    jans = JPRNN1D(num_sites=N, units=(U,), impl="jnp")
    return jans, jans.init(jax.random.PRNGKey(seed))


def _port_trainer(params, config):
    trainer = VMCTrainer(PRNN1D(N, (U,), device="cpu"), TFIM1D(N, 1.0), config)
    state = trainer.init()
    interop.load_params(trainer.ansatz, jax.tree.map(np.asarray, params))
    return trainer, state


def _assert_params_close(model, params, atol):
    for a, b in zip(jax.tree.leaves(interop.params_to_numpy(model)), jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


@pytest.mark.parametrize("kwargs", [
    dict(schedule="inverse", decay_scale=1.0),
    dict(schedule="staged", lr_stage_bounds=(1, 2), lr_stage_scales=(0.5, 0.1)),
], ids=["inverse", "staged"])
def test_three_adam_updates_on_fed_samples_match_optax(kwargs):
    """Estimator, loss, gradient and Adam under a schedule, three updates on
    the same fed samples: update k takes the rate of step k, as optax's
    count does."""
    config = TrainConfig(num_samples=B, learning_rate=2e-2, **kwargs)
    jans, params = _jax_side(seed=5)
    jenergy = jle.make_local_energy_fn(jans, JTFIM1D(num_sites=N, bx=1.0))
    opt = optax.adam(jmake_schedule(JTrainConfig(learning_rate=2e-2, **kwargs)))
    opt_state = opt.init(params)
    trainer, state = _port_trainer(params, config)
    rng = np.random.default_rng(5)
    for k in range(3):
        s = rng.integers(0, 2, (B, N)).astype(np.int32)
        js = jnp.asarray(s)
        e, _, _ = jenergy(params, js, jans.log_amp(params, js))
        e_mean = jnp.mean(e)
        grads = jax.grad(lambda p: jsurrogate_loss(
            jans.log_amp(p, js), None, e, None, e_mean, None))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        ts = torch.from_numpy(s)
        e_port, _, _ = trainer.local_energy(ts, trainer.ansatz.log_amp(ts).detach())
        trainer._update(state, ts, e_port)
        assert state.optimizer.param_groups[0]["lr"] == trainer.schedule(k)
    assert state.step == 3
    _assert_params_close(trainer.ansatz, params, atol=1e-5)


def test_one_minsr_update_under_harmonic_matches_optax():
    """A minSR update at step 7 of a harmonic schedule: the JAX direction
    applied by optax.sgd whose count is 7."""
    kwargs = dict(schedule="harmonic", learning_rate=5e-2, decay_scale=2.0)
    jans, params = _jax_side(seed=6)
    rng = np.random.default_rng(6)
    samples = rng.integers(0, 2, (B, N)).astype(np.int32)
    e_re = (rng.standard_normal(B) - 5.0).astype(np.float32)
    rows_re, rows_im = jminsr.per_sample_log_amp_grad_trees(jans, params, jnp.asarray(samples))
    direction = jminsr.minsr_direction_tree(rows_re, rows_im, jnp.asarray(e_re), None,
                                            jnp.mean(e_re), None, 1e-2, solver="cg",
                                            cg_iters=64)
    opt = optax.sgd(jmake_schedule(JTrainConfig(optimizer="minsr", **kwargs)))
    opt_state = otu.tree_set(opt.init(params), count=jnp.asarray(7, jnp.int32))
    updates, _ = opt.update(direction, opt_state, params)
    want = optax.apply_updates(params, updates)

    trainer, state = _port_trainer(params, TrainConfig(num_samples=B, optimizer="minsr",
                                                       **kwargs))
    state.step = 7
    trainer._update(state, torch.from_numpy(samples), torch.from_numpy(e_re))
    lr = trainer.schedule(7)
    assert lr < kwargs["learning_rate"] and state.optimizer.param_groups[0]["lr"] == lr
    scale = lr * max(float(np.abs(np.asarray(d)).max()) for d in jax.tree.leaves(direction))
    for g, w in zip(jax.tree.leaves(interop.params_to_numpy(trainer.ansatz)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4 * scale + 1e-7)
