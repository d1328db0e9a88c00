"""PyTorch port: the J1-J2 slice — the Hamiltonian and its ED copy, B10
(the exchange sum on given samples), B11 (sampling fused in), the estimator
dispatch and one whole update — held on the CPU against the JAX package
(its generic estimator, its exchange kernel in interpret mode, jax.grad and
optax).  On CPU tensors the wrappers run their plain versions; the kernels
are checked on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.ed import exact as jexact
from rnnwavefunctions_tpu.hamiltonians.j1j2 import J1J2 as JJ1J2
from rnnwavefunctions_tpu.ops.j1j2_exchange_kernel import (
    j1j2_exchange_offdiag as jj1j2_exchange_offdiag,
)
from rnnwavefunctions_tpu.vmc import local_energy as jle
from rnnwavefunctions_tpu.vmc.loss import surrogate_loss as jsurrogate_loss
from rnnwavefunctions_tpu_torch import CRNNU1, J1J2, TFIM1D, TrainConfig, VMCTrainer, interop
from rnnwavefunctions_tpu_torch.ed import exact
from rnnwavefunctions_tpu_torch.ops import fused_crnn
from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk
from rnnwavefunctions_tpu_torch.vmc import local_energy as le
from test_torch_crnn import _pair, sector_samples

torch.set_num_threads(1)

N, U, B = 8, 8, 16
FLAGS = [(m, p) for m in (False, True) for p in (False, True)]
FLAG_IDS = ["obc", "pbc", "marshall_obc", "marshall_pbc"]


def _weights(model):
    return tuple(w.detach() for w in model.weights())


def _close_rel(got, want, rel=1e-4):
    """Agreement to ``rel`` of the largest entry (f32 sums in another order)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("marshall,periodic", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("j2", [0.0, 0.3])
def test_hamiltonian_matches_jax(marshall, periodic, j2):
    kw = dict(j1=0.9, j2=j2, bz=0.2, periodic=periodic, marshall_sign=marshall)
    jham, ham = JJ1J2(num_sites=N, **kw), J1J2(N, **kw)
    samples = np.random.default_rng(0).integers(0, 2, (B, N)).astype(np.int32)
    jd, jf, je, jm = jax.vmap(jham.connected)(jnp.asarray(samples))
    d, f, e, m = ham.connected(torch.from_numpy(samples))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(ham.diagonal(torch.from_numpy(samples)).numpy(),
                               np.asarray(jax.vmap(jham.diagonal)(jnp.asarray(samples))),
                               atol=1e-6)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert ham.n_offdiag == jham.n_offdiag == 2 * N
    assert ham.exchange_kernel_info == jham.exchange_kernel_info
    assert J1J2(N, j1=0.0).exchange_kernel_info is None


@pytest.mark.parametrize("marshall,periodic", FLAGS, ids=FLAG_IDS)
def test_ed_copy_matches_jax_package(marshall, periodic):
    for n, j2, bz in [(5, 0.0, 0.0), (6, 0.2, 0.3)]:
        kw = dict(periodic=periodic, marshall_sign=marshall)
        h = exact.j1j2_dense(n, 1.0, j2, bz, **kw)
        np.testing.assert_array_equal(h, jexact.j1j2_dense(n, 1.0, j2, bz, **kw))
        assert exact.ground_state_energy(h) == jexact.ground_state_energy(h)


@pytest.mark.parametrize("marshall,periodic", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("j2", [0.0, 0.2])
def test_b10_plain_matches_pallas_interpret_and_jax_generic(marshall, periodic, j2):
    jans, params, model = _pair(N, units=(U,), seed=1)
    samples = sector_samples(B, N, seed=2)
    js = jnp.asarray(samples)
    jham = JJ1J2(num_sites=N, j2=j2, periodic=periodic, marshall_sign=marshall)
    ham = J1J2(N, j2=j2, periodic=periodic, marshall_sign=marshall)
    info = ham.exchange_kernel_info
    e_re, e_im, lp_re, lp_im = (t.numpy() for t in jk.j1j2_exchange_offdiag(
        _weights(model), torch.from_numpy(samples), u1=True, **info))
    # the JAX generic estimator: every connected configuration in full
    want_re, want_im, _ = jle.make_local_energy_fn(jans, jham)(
        params, js, jans.log_amp_parts(params, js))
    diag = ham.diagonal(torch.from_numpy(samples)).numpy()
    _close_rel(diag + e_re, np.asarray(want_re))
    _close_rel(e_im, np.asarray(want_im))
    # the TPU kernel's prefix sharing, in interpret mode
    with pltpu.force_tpu_interpret_mode():
        p_re, p_im, p_lre, p_lim = (np.asarray(a) for a in jj1j2_exchange_offdiag(
            params, js, u1=True, **info))
    _close_rel(e_re, p_re)
    _close_rel(e_im, p_im)
    np.testing.assert_allclose(lp_re, p_lre, atol=1e-5 * N)
    np.testing.assert_allclose(lp_im, p_lim, atol=1e-5 * N)
    assert jk.j1j2_exchange_offdiag.launches == 0


ELEMENTS = dict(el_nn=0.5, el_nnn=0.1, has_nnn=True, periodic=True)


def test_b11_plain_samples_energies_and_log_amp():
    n = 10
    _, _, model = _pair(n, units=(U,), seed=3)
    w = _weights(model)
    samples, e_re, e_im, lp_re, lp_im = jk.j1j2_sample_and_exchange(
        w, 40, n, 5, 9, u1=True, **ELEMENTS)
    assert samples.shape == (40, n) and samples.dtype == torch.int32
    np.testing.assert_array_equal(samples.sum(dim=1).numpy(), n // 2)
    # the base pass's (Re, Im) is B7's on the drawn samples, and the
    # energies are B10's on them
    re, im = fused_crnn.crnn_log_amp_parts(w, samples, True)
    torch.testing.assert_close(lp_re, re, atol=1e-5 * n, rtol=0)
    torch.testing.assert_close(lp_im, im, atol=1e-5 * n, rtol=0)
    b10 = jk.j1j2_exchange_offdiag(w, samples, u1=True, **ELEMENTS)
    for a, b in zip((e_re, e_im), b10[:2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    again, *_ = jk.j1j2_sample_and_exchange(w, 40, n, 5, 9, u1=True, **ELEMENTS)
    other, *_ = jk.j1j2_sample_and_exchange(w, 40, n, 5, 10, u1=True, **ELEMENTS)
    assert torch.equal(again, samples) and not torch.equal(other, samples)
    with pytest.raises(ValueError, match="2\\^32"):
        jk.j1j2_sample_and_exchange(w, 40, n, 2**32, 0, u1=True, **ELEMENTS)
    assert jk.j1j2_sample_and_exchange.launches == 0


def test_b11_plain_frequencies_from_fed_uniforms_match_exact_density():
    """At N=4 the plain B11 on 20k fed uniforms draws the six sector states
    with the frequencies of |psi|^2 from the JAX model."""
    n, draws = 4, 20000
    jans, params, model = _pair(n, units=(U,), seed=4)
    uniforms = torch.from_numpy(np.random.default_rng(5).random((draws, n), np.float32))
    samples, *_ = jk.sample_and_exchange_plain(_weights(model), uniforms, u1=True, **ELEMENTS)
    freq = np.bincount(samples.numpy() @ (2 ** np.arange(n)), minlength=16) / draws
    basis = jnp.asarray([[(c >> i) & 1 for i in range(n)] for c in range(16)])
    probs = np.exp(np.asarray(jans.log_prob(params, basis)))
    assert (probs > 0).sum() == 6 and (freq[probs == 0] == 0).all()
    np.testing.assert_allclose(freq, probs, atol=0.02)


@pytest.mark.parametrize("units", [(U,), (6, 6)])
def test_generic_complex_estimator_matches_jax(units):
    jans, params, model = _pair(N, units=units, seed=6)
    samples = sector_samples(B, N, seed=7)
    js = jnp.asarray(samples)
    jham = JJ1J2(num_sites=N, j2=0.2, marshall_sign=True)
    want_re, want_im, _ = jle.make_local_energy_fn(jans, jham)(
        params, js, jans.log_amp_parts(params, js))
    fn = le.make_local_energy_fn(model, J1J2(N, j2=0.2, marshall_sign=True), chunk_size=50)
    assert fn.needs_log_amp
    parts = model.log_amp_parts(torch.from_numpy(samples))
    e_re, e_im, la = fn(torch.from_numpy(samples), parts)
    _close_rel(e_re.numpy(), np.asarray(want_re))
    _close_rel(e_im.numpy(), np.asarray(want_im))
    assert la is parts


def test_two_updates_on_fed_samples_match_jax():
    """The slice as a whole: from the same weights and the same samples, the
    local energies, the surrogate-loss gradient and Adam reach the JAX
    package's parameters (jax.grad and optax), two steps running."""
    jans, params, _ = _pair(N, units=(U,), seed=8)
    jham = JJ1J2(num_sites=N, j2=0.2)
    jenergy = jle.make_local_energy_fn(jans, jham)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)
    trainer = VMCTrainer(CRNNU1(N, (U,), device="cpu"), J1J2(N, j2=0.2),
                         TrainConfig(num_samples=B))
    state = trainer.init()
    interop.load_params(trainer.ansatz, jax.tree.map(np.asarray, params))
    for step in range(2):
        s = sector_samples(B, N, seed=9 + step)
        js = jnp.asarray(s)
        e_re, e_im, _ = jenergy(params, js, jans.log_amp_parts(params, js))
        m_re, m_im = jnp.mean(e_re), jnp.mean(e_im)
        grads = jax.grad(lambda p: jsurrogate_loss(
            *jans.log_amp_parts(p, js), e_re, e_im, m_re, m_im))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        ts = torch.from_numpy(s)
        p_re, p_im, _ = trainer.local_energy(ts, trainer._log_amp_of_batch(ts, None))
        _close_rel(p_re.numpy(), np.asarray(e_re))
        _close_rel(p_im.numpy(), np.asarray(e_im))
        m = trainer._update(state, ts, p_re, p_im)
        np.testing.assert_allclose(float(m["mean_energy"]), float(m_re), rtol=1e-5)
        np.testing.assert_allclose(float(m["mean_energy_im"]), float(m_im), atol=1e-5)
    got = interop.params_to_numpy(trainer.ansatz)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_select_family_dispatch():
    ham = J1J2(N, j2=0.2)
    cpu = CRNNU1(N, (U,), device="cpu")
    assert le._select_family(cpu, ham) is None
    assert le.make_fused_sample_energy_fn(cpu, ham) is None
    with pytest.raises(ValueError, match="CUDA"):
        le._select_family(CRNNU1(N, (U,), impl="kernel", device="cpu"), ham)

    class CudaModel(CRNNU1):
        device = torch.device("cuda", 0)

        def _kernelizable(self):
            # stands in for the kernel library's shared-memory query
            return len(self.units) == 1

    fake = CudaModel(N, (U,), device="cpu")
    assert le._select_family(fake, ham) == "exchange"
    assert le.make_local_energy_fn(fake, ham).needs_log_amp is False
    assert le.make_fused_sample_energy_fn(fake, ham) is not None
    # no NN exchange, or a Hamiltonian without one: the generic estimator
    assert le._select_family(fake, J1J2(N, j1=0.0, j2=0.2)) is None
    assert le._select_family(fake, TFIM1D(N, 1.0)) is None
    # an uncovered stack on the card raises instead of running the plain path
    with pytest.raises(ValueError, match="impl='plain'"):
        le._select_family(CudaModel(N, (U, U), device="cpu"), ham)
    assert le._select_family(CudaModel(N, (U, U), impl="plain", device="cpu"), ham) is None
