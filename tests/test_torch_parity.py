"""PyTorch port: the parity-symmetrized PRNN1D — its log p, B6 (the per-flip
log p, teacher-forced and in sample mode), the "parity_flip" estimator, the
loss gradient through both directions, Adam, and the trainer's log psi of a
drawn batch — held on the CPU against the JAX package's jnp path, its
generic estimator and its Pallas kernel in interpret mode.  On a CPU tensor
every wrapper runs its plain version; the kernels themselves are checked on
the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: log p 1e-5 per site (f32 recurrences summed in another order),
local energies 1e-5 relative, gradients 1e-4 of the largest entry."""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.hamiltonians.tfim1d import TFIM1D as JTFIM1D
from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.ops.tfim_flip_kernel import tfim_flip_log_probs as jflip_log_probs
from rnnwavefunctions_tpu.vmc import local_energy as jle
from rnnwavefunctions_tpu.vmc.loss import surrogate_loss as jsurrogate_loss
from rnnwavefunctions_tpu_torch import PRNN1D, TFIM1D, TrainConfig, VMCTrainer, interop
from rnnwavefunctions_tpu_torch.ops import fused_gru
from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk
from rnnwavefunctions_tpu_torch.vmc import local_energy as le
from rnnwavefunctions_tpu_torch.vmc.loss import surrogate_loss

torch.set_num_threads(1)

N, U, B = 7, 10, 23


def _pair(n=N, units=(U,), seed=0):
    """A JAX parity PRNN1D with its params and the port's parity PRNN1D
    holding the same parameters (JAX-initialised, every tensor perturbed so
    the biases are not zero)."""
    jans = JPRNN1D(num_sites=n, units=units, parity=True, impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    model = PRNN1D(n, units, parity=True, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return jans, params, model


def _samples(b, n, seed=1):
    return np.random.default_rng(seed).integers(0, 2, (b, n)).astype(np.int32)


def _weights(model):
    return tuple(w.detach() for w in model.weights())


def _close_rel(got, want, rel=1e-4):
    """Agreement to ``rel`` of the largest entry (f32 sums in another order)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _on_kernels(model, monkeypatch):
    """Makes ``model`` take its kernel path; with CPU tensors every wrapper
    then runs its plain version, so the path's control flow runs here."""
    monkeypatch.setattr(model, "_use_kernels", lambda: True)
    return model


@pytest.mark.parametrize("units", [(U,), (6, 6)])
def test_log_prob_matches_jax_and_is_reflection_invariant(units):
    jans, params, model = _pair(units=units)
    s = _samples(B, N)
    ts = torch.from_numpy(s)
    want = np.asarray(jans.log_prob(params, jnp.asarray(s)))
    got = model.log_prob(ts).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * N)
    np.testing.assert_allclose(model.log_amp(ts).detach().numpy(), 0.5 * want, atol=1e-5 * N)
    rev = model.log_prob(ts.flip(1).contiguous()).detach().numpy()
    np.testing.assert_allclose(rev, got, atol=1e-6)
    assert model.parity and not model.plain_positive and not model.is_complex


def test_log_prob_over_all_configurations():
    """At N=5 over all 32 configurations: log((p(s) + p(rev s)) / 2) of the
    plain JAX model, the JAX parity model, and a normalised density."""
    n = 5
    jans, params, model = _pair(n=n, seed=2)
    basis = np.asarray(list(itertools.product([0, 1], repeat=n)), np.int32)
    plain = JPRNN1D(num_sites=n, units=(U,), impl="jnp")
    lp1 = np.asarray(plain.log_prob(params, jnp.asarray(basis)), np.float64)
    lp2 = np.asarray(plain.log_prob(params, jnp.asarray(basis[:, ::-1].copy())), np.float64)
    expected = np.log(0.5 * (np.exp(lp1) + np.exp(lp2)))
    got = model.log_prob(torch.from_numpy(basis)).detach().numpy()
    np.testing.assert_allclose(got, expected, atol=1e-5 * n)
    np.testing.assert_allclose(got, np.asarray(jans.log_prob(params, jnp.asarray(basis))),
                               atol=1e-5 * n)
    np.testing.assert_allclose(np.exp(got.astype(np.float64)).sum(), 1.0, atol=1e-5)


def test_b6_plain_matches_pallas_interpret_and_explicit_flips():
    jans, params, model = _pair(seed=3)
    s = _samples(B, N, seed=4)
    lpf, lp = tk.tfim_flip_log_probs(_weights(model), torch.from_numpy(s))
    assert lpf.shape == (B, N) and lp.shape == (B,)
    with pltpu.force_tpu_interpret_mode():
        j_lpf, j_lp = jflip_log_probs(params, jnp.asarray(s))
    np.testing.assert_allclose(lpf.numpy(), np.asarray(j_lpf), atol=1e-5 * N, rtol=0)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5 * N, rtol=0)
    flips = np.repeat(s[:, None, :], N, axis=1)
    idx = np.arange(N)
    flips[:, idx, idx] = 1 - flips[:, idx, idx]
    want = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(flips.reshape(-1, N))))
    np.testing.assert_allclose(lpf.numpy(), want.reshape(B, N), atol=1e-5 * N, rtol=0)
    want_lp = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(s)))
    np.testing.assert_allclose(lp.numpy(), want_lp, atol=1e-5 * N, rtol=0)
    # the flip-order sum of the terms is K4's ratio sum
    ratio, lp4 = tk.tfim_flip_ratio_sum(_weights(model), torch.from_numpy(s))
    torch.testing.assert_close(tk.ratio_sum(lpf, lp), ratio, atol=0, rtol=0)
    torch.testing.assert_close(lp4, lp, atol=0, rtol=0)
    assert tk.tfim_flip_log_probs.launches == 0  # the CPU path launches nothing


def test_b6_sample_mode_equals_teacher_forced_on_its_samples():
    _, _, model = _pair(seed=5)
    w = _weights(model)
    s, lp, lpf = tk.tfim_sample_and_flip_sum(w, B, N, 5, 9, per_flip=True)
    assert s.shape == (B, N) and s.dtype == torch.int32 and lpf.shape == (B, N)
    lpf_t, lp_t = tk.tfim_flip_log_probs(w, s)
    torch.testing.assert_close(lpf, lpf_t, atol=0, rtol=0)
    torch.testing.assert_close(lp, lp_t, atol=0, rtol=0)
    # K3 and B5 draw the same chains for the same key
    s3, lp3, _ = tk.tfim_sample_and_flip_sum(w, B, N, 5, 9)
    s5, lp5 = fused_gru.gru_sample(w, B, N, 5, 9)
    assert torch.equal(s3, s) and torch.equal(s5, s)
    torch.testing.assert_close(lp3, lp, atol=0, rtol=0)
    torch.testing.assert_close(lp5, lp, atol=0, rtol=0)
    assert tk.tfim_sample_and_flip_log_probs.launches == 0
    with pytest.raises(ValueError, match="2\\^32"):
        tk.tfim_sample_and_flip_sum(w, B, N, 2**32, 0, per_flip=True)


@pytest.mark.parametrize("bx", [1.0, 0.7])
def test_parity_estimator_matches_jax_generic(bx, monkeypatch):
    """The port's generic estimator (on the CPU) and its "parity_flip" path
    (faked onto the kernels) against the JAX package's generic estimator; the
    fused path's base log psi against ``log_amp``."""
    jans, params, model = _pair(seed=6)
    s = _samples(B, N, seed=7)
    js, ts = jnp.asarray(s), torch.from_numpy(s)
    jham = JTFIM1D(num_sites=N, bx=bx)
    jfn = jle.make_local_energy_fn(jans, jham)
    assert jfn.needs_log_amp
    want, _, _ = jfn(params, js, jans.log_amp(params, js))
    want = np.asarray(want)
    ham = TFIM1D(N, bx)
    generic = le.make_local_energy_fn(model, ham)
    assert generic.needs_log_amp
    got, e_im, _ = generic(ts, model.log_amp(ts).detach())
    assert e_im is None
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    fused = le.make_local_energy_fn(_on_kernels(model, monkeypatch), ham)
    assert not fused.needs_log_amp
    got, e_im, la = fused(ts)
    assert e_im is None
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(la.numpy(), np.asarray(jans.log_amp(params, js)), atol=1e-5 * N)


def test_fused_sample_energy_step_matches_the_generic_estimator(monkeypatch):
    _, _, model = _pair(seed=8)
    ham = TFIM1D(N, 1.1)
    generic = le.make_local_energy_fn(model, ham)
    fused = le.make_fused_sample_energy_fn(_on_kernels(model, monkeypatch), ham)
    samples, la, e, e_im = fused(B, 3, 4)
    assert e_im is None and samples.shape == (B, N)
    la_want = model.log_amp(samples).detach()
    torch.testing.assert_close(la, la_want, atol=1e-5 * N, rtol=0)
    want, _, _ = generic(samples, la_want)
    torch.testing.assert_close(e, want, rtol=1e-5, atol=1e-5)
    # the samples are K3's and B5's draws for the key: the plain sampler
    assert torch.equal(samples, fused_gru.gru_sample(_weights(model), B, N, 3, 4)[0])
    # trainer.local_energy on the same samples gives the same energies
    e2, _, la2 = le.make_local_energy_fn(model, ham)(samples)
    torch.testing.assert_close(e2, e, atol=0, rtol=0)
    torch.testing.assert_close(la2, la, atol=0, rtol=0)


def test_select_family_keeps_parity_out_of_plain_flip(monkeypatch):
    _, _, model = _pair()
    ham = TFIM1D(N, 1.0)
    # on the CPU "auto" never takes the kernels: both consumers agree on None
    assert le._select_family(model, ham) is None
    assert le.make_fused_sample_energy_fn(model, ham) is None
    _on_kernels(model, monkeypatch)
    assert le._select_family(model, ham) == "parity_flip"
    assert le._select_family(model, TFIM1D(N, 0.0)) is None  # no flips
    plain = PRNN1D(N, (U,), device="cpu")
    monkeypatch.setattr(plain, "_use_kernels", lambda: True)
    assert le._select_family(plain, ham) == "plain_flip"
    assert le._select_family(PRNN1D(N, (U,), parity=True, impl="plain", device="cpu"),
                             ham) is None
    with pytest.raises(ValueError, match="CUDA"):
        le._select_family(PRNN1D(N, (U,), parity=True, impl="kernel", device="cpu"), ham)


def test_loss_gradient_through_both_directions_matches_jax_grad(monkeypatch):
    """The loss runs GRULogProb on the samples and on their reversal in one
    graph; autograd adds the two backward passes, as jax.grad does."""
    jans, params, model = _pair(seed=9)
    _on_kernels(model, monkeypatch)
    s = _samples(B, N, seed=10)
    e = (np.random.default_rng(11).standard_normal(B) - 5.0).astype(np.float32)
    te = torch.from_numpy(e)
    surrogate_loss(model.log_amp(torch.from_numpy(s)), None, te, None, te.mean(),
                   None).backward()
    jgrad = jax.grad(lambda p: jsurrogate_loss(
        jans.log_amp(p, jnp.asarray(s)), None, jnp.asarray(e), None, jnp.mean(e), None))(params)
    got = {"rnn": [{k: getattr(layer, k).grad.numpy() for k in ("wx", "wh", "bx", "bh")}
                   for layer in model.rnn],
           "head": {"w": model.head.w.grad.numpy(), "b": model.head.b.grad.numpy()}}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jgrad)):
        _close_rel(a, np.asarray(b))
    assert fused_gru.gru_log_prob.launches == 0


def test_two_adam_updates_on_fed_samples_match_optax(monkeypatch):
    """Estimator, loss through both directions, gradient and Adam: two steps
    on the same fed samples reach the same parameters as the JAX package."""
    jans, params, model = _pair(seed=12)
    jham = JTFIM1D(num_sites=N, bx=1.0)
    jenergy = jle.make_local_energy_fn(jans, jham)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)
    trainer = VMCTrainer(_on_kernels(model, monkeypatch), TFIM1D(N, 1.0),
                         TrainConfig(num_samples=B))
    state = trainer.init()
    interop.load_params(trainer.ansatz, jax.tree.map(np.asarray, params))
    assert not trainer.local_energy.needs_log_amp  # the "parity_flip" path
    rng = np.random.default_rng(13)
    for _ in range(2):
        s = rng.integers(0, 2, (B, N)).astype(np.int32)
        js = jnp.asarray(s)
        e, _, _ = jenergy(params, js, jans.log_amp(params, js))
        e_mean = jnp.mean(e)
        grads = jax.grad(lambda p: jsurrogate_loss(
            jans.log_amp(p, js), None, e, None, e_mean, None))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ts = torch.from_numpy(s)
        e_port, _, _ = trainer.local_energy(ts)
        np.testing.assert_allclose(e_port.numpy(), np.asarray(e), rtol=1e-5, atol=1e-5)
        trainer._update(state, ts, e_port)
    for a, w in zip(jax.tree.leaves(interop.params_to_numpy(trainer.ansatz)),
                    jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-5)


def test_trainer_log_amp_of_batch_is_plain_positive_only(monkeypatch):
    """The generic step's ratio denominators: 0.5 * the sampling log p only
    for a plain positive ansatz.  A parity ansatz samples the plain density,
    so its step must run the teacher-forced symmetrized log psi; its
    energies then equal the parity estimator's on the same samples."""
    _, _, model = _pair(seed=14)
    ham = TFIM1D(N, 1.0)
    trainer = VMCTrainer(model, ham, TrainConfig(num_samples=B))
    state = trainer.init()
    assert trainer.local_energy.needs_log_amp  # the generic path on the CPU
    samples, logp = model.sample_with_log_prob(B, torch.Generator().manual_seed(15))
    la = trainer._log_amp_of_batch(samples, logp)
    torch.testing.assert_close(la, model.log_amp(samples).detach(), atol=0, rtol=0)
    assert not torch.allclose(la, 0.5 * logp)
    samples, e, _ = trainer._sample_and_energy(state)
    parity = le.make_local_energy_fn(_on_kernels(model, monkeypatch), ham)
    want, _, _ = parity(samples)
    torch.testing.assert_close(e, want, rtol=1e-5, atol=1e-5)
    # a plain positive ansatz keeps the free 0.5 * log p
    plain = VMCTrainer(PRNN1D(N, (U,), device="cpu"), ham, TrainConfig(num_samples=B))
    plain.init()
    s, lp = plain.ansatz.sample_with_log_prob(B, torch.Generator().manual_seed(16))
    torch.testing.assert_close(plain._log_amp_of_batch(s, lp), 0.5 * lp, atol=0, rtol=0)


def test_params_round_trip_bit_exact():
    """The parity PRNN1D keeps the pRNN pytree: interop needs nothing new."""
    params = JPRNN1D(num_sites=N, units=(U,), parity=True, impl="jnp").init(
        jax.random.PRNGKey(17))
    tree = jax.tree.map(np.asarray, params)
    model = PRNN1D(N, (U,), parity=True, device="cpu")
    interop.load_params(model, tree)
    got, got_def = jax.tree.flatten(interop.params_to_numpy(model))
    want, want_def = jax.tree.flatten(tree)
    assert got_def == want_def
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_short_cpu_run_approaches_ed():
    """Parity VMC end to end on the CPU (plain sampler, generic estimator
    with the teacher-forced log psi, loss through both directions)."""
    from rnnwavefunctions_tpu_torch.ed import exact

    n = 6
    e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0))
    trainer = VMCTrainer(PRNN1D(n, (16,), parity=True, device="cpu"), TFIM1D(n, 1.0),
                         TrainConfig(num_samples=200, learning_rate=1e-2))
    state = trainer.init()
    state, ms = trainer.run_steps(state, 100)
    e_vmc = float(ms["mean_energy"][-20:].mean())
    assert math.isfinite(e_vmc)
    assert abs(e_vmc - e_exact) / abs(e_exact) < 1e-2
