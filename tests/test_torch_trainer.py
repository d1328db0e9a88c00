"""PyTorch port: the surrogate loss, one Adam update, the whole training
step on fed samples, and a short run against exact diagonalization, held
against the JAX package (optax Adam) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rnnwavefunctions_tpu.hamiltonians.tfim1d import TFIM1D as JTFIM1D
from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.vmc import local_energy as jle
from rnnwavefunctions_tpu.vmc.loss import surrogate_loss as jsurrogate_loss
from rnnwavefunctions_tpu_torch import (
    CRNNU1, J1J2, PRNN1D, TFIM1D, TrainConfig, VMCTrainer, interop,
)
from rnnwavefunctions_tpu_torch.ed import exact
from rnnwavefunctions_tpu_torch.vmc.loss import surrogate_loss

torch.set_num_threads(1)

N, U, B = 8, 12, 24


def _jax_side(seed=0):
    jans = JPRNN1D(num_sites=N, units=(U,), impl="jnp")
    return jans, jans.init(jax.random.PRNGKey(seed))


def _port_trainer(params, config=TrainConfig(num_samples=B)):
    trainer = VMCTrainer(PRNN1D(N, (U,), device="cpu"), TFIM1D(N, 1.0), config)
    state = trainer.init()
    interop.load_params(trainer.ansatz, jax.tree.map(np.asarray, params))
    return trainer, state


def _assert_params_close(model, params, atol):
    got = interop.params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def test_surrogate_loss_matches_jax_real_and_complex():
    rng = np.random.default_rng(0)
    la_re, la_im, e_re, e_im = (rng.standard_normal(16).astype(np.float32) for _ in range(4))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = surrogate_loss(t(la_re), None, t(e_re), None, t(e_re).mean(), None)
    want = jsurrogate_loss(la_re, None, e_re, None, e_re.mean(), None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = surrogate_loss(t(la_re), t(la_im), t(e_re), t(e_im),
                         t(e_re).mean(), t(e_im).mean())
    want = jsurrogate_loss(la_re, la_im, e_re, e_im, e_re.mean(), e_im.mean())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the local energies are constants of the loss
    e = t(e_re).requires_grad_(True)
    la = t(la_re).requires_grad_(True)
    surrogate_loss(la, None, e, None, e.mean(), None).backward()
    assert e.grad is None
    np.testing.assert_allclose(la.grad.numpy(), 2.0 * (e_re - e_re.mean()) / 16, rtol=1e-5)


def test_one_adam_update_matches_optax():
    jans, params = _jax_side()
    rng = np.random.default_rng(1)
    samples = rng.integers(0, 2, (B, N)).astype(np.int32)
    e_loc = (rng.standard_normal(B) - 8.0).astype(np.float32)
    config = TrainConfig(num_samples=B)

    def loss(p):
        return jsurrogate_loss(jans.log_amp(p, jnp.asarray(samples)), None,
                               jnp.asarray(e_loc), None, jnp.mean(e_loc), None)

    opt = optax.adam(config.learning_rate, b1=config.b1, b2=config.b2, eps=config.eps)
    updates, _ = opt.update(jax.grad(loss)(params), opt.init(params), params)
    want = optax.apply_updates(params, updates)

    trainer, state = _port_trainer(params, config)
    metrics = trainer._update(state, torch.from_numpy(samples), torch.from_numpy(e_loc))
    _assert_params_close(trainer.ansatz, want, atol=1e-6)
    np.testing.assert_allclose(float(metrics["mean_energy"]), e_loc.mean(), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["var_energy"]), e_loc.var(), rtol=1e-5)
    assert state.step == 1


def test_three_steps_on_fed_samples_match_jax():
    """The slice as a whole: estimator, loss, gradient and Adam, three steps
    on the same fed samples, reach the same parameters."""
    jans, params = _jax_side(seed=2)
    jham = JTFIM1D(num_sites=N, bx=1.0)
    jenergy = jle.make_local_energy_fn(jans, jham)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)
    trainer, state = _port_trainer(params)
    rng = np.random.default_rng(2)
    for _ in range(3):
        s = rng.integers(0, 2, (B, N)).astype(np.int32)
        js = jnp.asarray(s)
        e, _, _ = jenergy(params, js, jans.log_amp(params, js))
        e_mean = jnp.mean(e)
        grads = jax.grad(lambda p: jsurrogate_loss(
            jans.log_amp(p, js), None, e, None, e_mean, None))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        ts = torch.from_numpy(s)
        la = trainer.ansatz.log_amp(ts).detach()
        e_port, _, _ = trainer.local_energy(ts, la)
        np.testing.assert_allclose(e_port.numpy(), np.asarray(e), rtol=1e-5, atol=1e-5)
        m = trainer._update(state, ts, e_port)
        np.testing.assert_allclose(float(m["mean_energy"]), float(e_mean), rtol=1e-5)
    _assert_params_close(trainer.ansatz, params, atol=1e-5)


def test_short_cpu_run_approaches_ed():
    n = 6
    e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0))
    trainer = VMCTrainer(PRNN1D(n, (16,), device="cpu"), TFIM1D(n, 1.0),
                         TrainConfig(num_samples=200, learning_rate=1e-2))
    state = trainer.init()
    state, ms = trainer.run_steps(state, 120)
    assert ms["mean_energy"].shape == (120,) and ms["var_energy"].shape == (120,)
    assert state.step == 120
    e_vmc = float(ms["mean_energy"][-20:].mean())
    assert abs(e_vmc - e_exact) / abs(e_exact) < 1e-2
    assert float(ms["var_energy"][-20:].mean()) < float(ms["var_energy"][:5].mean())


def test_steps_are_reproducible_from_the_seed():
    def run():
        trainer = VMCTrainer(PRNN1D(5, (8,), device="cpu"), TFIM1D(5, 1.0),
                             TrainConfig(num_samples=32, seed=7))
        state = trainer.init()
        return trainer.run_steps(state, 3)[1]["mean_energy"]

    assert torch.equal(run(), run())


def test_j1j2_cpu_run_approaches_ed():
    """The complex path end to end on the CPU (plain sampler, generic
    estimator, (Re, Im) loss): J1-J2 at N=6 with the Marshall sign, and a
    vanishing imaginary energy."""
    n = 6
    e_exact = exact.ground_state_energy(exact.j1j2_dense(n, 1.0, 0.2, marshall_sign=True))
    trainer = VMCTrainer(CRNNU1(n, (16,), device="cpu"), J1J2(n, j2=0.2, marshall_sign=True),
                         TrainConfig(num_samples=200, learning_rate=1e-2))
    state = trainer.init()
    state, ms = trainer.run_steps(state, 150)
    assert set(ms) == {"mean_energy", "var_energy", "mean_energy_im"}
    assert ms["mean_energy_im"].shape == (150,)
    e_vmc = float(ms["mean_energy"][-20:].mean())
    assert abs(e_vmc - e_exact) / abs(e_exact) < 2e-2
    assert abs(float(ms["mean_energy_im"][-20:].mean())) < 0.05


def test_j1j2_steps_are_reproducible_from_the_seed():
    def run():
        trainer = VMCTrainer(CRNNU1(6, (8,), device="cpu"), J1J2(6, j2=0.2),
                             TrainConfig(num_samples=32, seed=7))
        state = trainer.init()
        return trainer.run_steps(state, 3)[1]

    a, b = run(), run()
    assert torch.equal(a["mean_energy"], b["mean_energy"])
    assert torch.equal(a["mean_energy_im"], b["mean_energy_im"])


@pytest.mark.parametrize("kwargs,match", [
    (dict(schedule="inverse", optimizer="sgd"), "unknown optimizer"),
    (dict(schedule="staged", lr_stage_bounds=(10,), lr_stage_scales=()), "matching"),
    (dict(schedule="staged", lr_stage_bounds=(10, 5), lr_stage_scales=(0.1, 0.2)), "ascend"),
    (dict(schedule="cosine"), "unknown schedule"),
    (dict(optimizer="minsr", sr_damping=0.0), "sr_damping must be > 0"),
], ids=["inverse", "staged", "staged-descending", "unknown-schedule", "minsr-damping"])
def test_config_rejects_what_is_not_ported(kwargs, match):
    """The settings the JAX trainer refuses raise the same ValueError at
    VMCTrainer's construction; every schedule of the JAX package is ported."""
    from rnnwavefunctions_tpu import TrainConfig as JTrainConfig
    from rnnwavefunctions_tpu import VMCTrainer as JVMCTrainer

    with pytest.raises(ValueError, match=match) as want:
        JVMCTrainer(JPRNN1D(num_sites=5, units=(8,)), JTFIM1D(num_sites=5),
                    JTrainConfig(num_samples=8, **kwargs))
    with pytest.raises(ValueError, match=match) as got:
        VMCTrainer(PRNN1D(5, (8,), device="cpu"), TFIM1D(5, 1.0), TrainConfig(**kwargs))
    assert str(got.value) == str(want.value)
    schedule = kwargs.get("schedule")
    if schedule in ("inverse", "staged"):  # the schedule alone builds
        VMCTrainer(PRNN1D(5, (8,), device="cpu"), TFIM1D(5, 1.0), TrainConfig(schedule=schedule))
