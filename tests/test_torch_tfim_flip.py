"""PyTorch port: TFIM1D, the estimator dispatch and the flip-ratio sums K3/K4
(their plain versions, on CPU tensors), held against the JAX package's
generic connected-configs estimator and explicit flips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu.hamiltonians.tfim1d import TFIM1D as JTFIM1D
from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.vmc import local_energy as jle
from rnnwavefunctions_tpu_torch import PRNN1D, TFIM1D, interop
from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk
from rnnwavefunctions_tpu_torch.vmc import local_energy as le

torch.set_num_threads(1)

N, U, B = 9, 12, 29


@pytest.fixture(scope="module")
def setup():
    jans = JPRNN1D(num_sites=N, units=(U,), impl="jnp")
    params = jans.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    model = PRNN1D(N, (U,), device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    samples = rng.integers(0, 2, (B, N)).astype(np.int32)
    return jans, params, model, samples


def _weights(model):
    return tuple(w.detach() for w in model.weights())


@pytest.mark.parametrize("bx", [1.0, 0.7])
def test_k4_plain_matches_jax_generic_estimator(setup, bx):
    jans, params, model, samples = setup
    jham = JTFIM1D(num_sites=N, bx=bx)
    jfn = jle.make_local_energy_fn(jans, jham)
    assert jfn.needs_log_amp  # the JAX side runs its generic path
    la = jans.log_amp(params, jnp.asarray(samples))
    want_e, _, _ = jfn(params, jnp.asarray(samples), la)
    ratio, lp = tk.tfim_flip_ratio_sum(_weights(model), torch.from_numpy(samples))
    ham = TFIM1D(N, bx)
    got_e = ham.diagonal(torch.from_numpy(samples)) + ham.uniform_flip_element * ratio
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), 2.0 * np.asarray(la), atol=1e-5)


def test_k4_plain_matches_explicit_flips(setup):
    jans, params, model, samples = setup
    flips = np.repeat(samples[:, None, :], N, axis=1)
    idx = np.arange(N)
    flips[:, idx, idx] = 1 - flips[:, idx, idx]
    lpf = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(flips.reshape(-1, N))))
    lp = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(samples)))
    want = np.exp(0.5 * (lpf.reshape(B, N) - lp[:, None])).sum(axis=1)
    ratio, _ = tk.tfim_flip_ratio_sum(_weights(model), torch.from_numpy(samples))
    np.testing.assert_allclose(ratio.numpy(), want, rtol=1e-5)


def test_k3_plain_samples_log_prob_and_ratio(setup):
    jans, params, model, _ = setup
    w = _weights(model)
    samples, lp, ratio = tk.tfim_sample_and_flip_sum(w, 40, N, 5, 9)
    assert samples.shape == (40, N) and samples.dtype == torch.int32
    assert set(np.unique(samples.numpy())) <= {0, 1}
    want = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(samples.numpy())))
    np.testing.assert_allclose(lp.numpy(), want, atol=1e-5)
    ratio4, lp4 = tk.tfim_flip_ratio_sum(w, samples)
    np.testing.assert_allclose(ratio.numpy(), ratio4.numpy(), rtol=1e-6)
    np.testing.assert_allclose(lp.numpy(), lp4.numpy(), rtol=1e-6)
    again, _, _ = tk.tfim_sample_and_flip_sum(w, 40, N, 5, 9)
    other, _, _ = tk.tfim_sample_and_flip_sum(w, 40, N, 5, 10)
    assert torch.equal(again, samples) and not torch.equal(other, samples)
    with pytest.raises(ValueError, match="2\\^32"):
        tk.tfim_sample_and_flip_sum(w, 40, N, -1, 0)


@pytest.mark.parametrize("chunk_size", [None, 50])
def test_generic_local_energy_matches_jax(setup, chunk_size):
    jans, params, model, samples = setup
    jham = JTFIM1D(num_sites=N, bx=1.0, jz=tuple(np.linspace(0.5, 1.5, N - 1)))
    ham = TFIM1D(N, 1.0, jz=jham.jz)
    la = jans.log_amp(params, jnp.asarray(samples))
    want, _, _ = jle.make_local_energy_fn(jans, jham)(params, jnp.asarray(samples), la)
    fn = le.make_local_energy_fn(model, ham, chunk_size)
    assert fn.needs_log_amp
    got, e_im, la_out = fn(torch.from_numpy(samples), torch.tensor(np.array(la)))
    assert e_im is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(la_out.numpy(), np.asarray(la))


def test_tfim_diagonal_and_connected_match_jax(setup):
    *_, samples = setup
    jham = JTFIM1D(num_sites=N, bx=0.3, jz=tuple(np.linspace(-1, 1, N - 1)))
    ham = TFIM1D(N, 0.3, jz=jham.jz)
    jd, jf, je, jm = jax.vmap(jham.connected)(jnp.asarray(samples))
    d, f, e, m = ham.connected(torch.from_numpy(samples))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert ham.n_offdiag == N and ham.uniform_flip_element == -0.3


def test_select_family_dispatch():
    ham = TFIM1D(N, 1.0)
    # on the CPU "auto" never takes the kernels, so both consumers agree on None
    cpu = PRNN1D(N, (U,), device="cpu")
    assert le._select_family(cpu, ham) is None
    assert le.make_fused_sample_energy_fn(cpu, ham) is None
    assert le._select_family(PRNN1D(N, (U,), impl="plain", device="cpu"), ham) is None
    # "kernel" demands a CUDA device: no silent CPU fallback
    with pytest.raises(ValueError, match="CUDA"):
        le._select_family(PRNN1D(N, (U,), impl="kernel", device="cpu"), ham)

    class CudaModel(PRNN1D):
        device = torch.device("cuda", 0)

        def _kernelizable(self):
            # stands in for the kernel library's shared-memory query
            return self._single_gru()

    fake = CudaModel(N, (U,), device="cpu")
    assert le._select_family(fake, ham) == "plain_flip"
    # a zero transverse field has no flips, whatever the device
    assert le._select_family(fake, TFIM1D(N, 0.0)) is None
    # an uncovered stack on the card raises instead of running the plain path
    with pytest.raises(ValueError, match="impl='plain'"):
        le._select_family(CudaModel(N, (U, U), device="cpu"), ham)
    assert le._select_family(CudaModel(N, (U, U), impl="plain", device="cpu"), ham) is None
    assert le.make_local_energy_fn(fake, ham).needs_log_amp is False
