"""PyTorch port: PRNN1D (teacher-forced log p, its gradient, the sampler and
the impl dispatch) held against the JAX package's jnp path on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu_torch import PRNN1D, interop
from rnnwavefunctions_tpu_torch.models.base import resolve_device, resolve_impl

torch.set_num_threads(1)


def _pair(n, units, seed=0):
    """A JAX ansatz with its params and the port's PRNN1D holding the same
    parameters (JAX-initialised, biases perturbed so they are not zero)."""
    jans = JPRNN1D(num_sites=n, units=units, impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    model = PRNN1D(n, units, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return jans, params, model


def _samples(b, n, seed=1):
    return np.random.default_rng(seed).integers(0, 2, (b, n)).astype(np.int32)


@pytest.mark.parametrize("units", [(12,), (6, 6)])
def test_log_prob_matches_jax_jnp(units):
    jans, params, model = _pair(8, units)
    s = _samples(33, 8)
    want = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(s)))
    got = model.log_prob(torch.from_numpy(s)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        model.log_amp(torch.from_numpy(s)).detach().numpy(), 0.5 * want, atol=1e-5
    )


@pytest.mark.parametrize("units", [(12,), (6, 6)])
def test_log_prob_gradient_matches_jax_grad(units):
    jans, params, model = _pair(8, units)
    s = _samples(33, 8)
    g = np.random.default_rng(2).standard_normal(33).astype(np.float32)
    jgrad = jax.grad(
        lambda p: jnp.sum(jnp.asarray(g) * jans._log_prob_plain_jnp(p, jnp.asarray(s)))
    )(params)
    (torch.from_numpy(g) * model.log_prob(torch.from_numpy(s))).sum().backward()
    got = {
        "rnn": [{k: getattr(layer, k).grad.numpy() for k in ("wx", "wh", "bx", "bh")}
                for layer in model.rnn],
        "head": {"w": model.head.w.grad.numpy(), "b": model.head.b.grad.numpy()},
    }
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_sampler_log_prob_matches_jax_teacher_forced():
    jans, params, model = _pair(10, (12,))
    samples, logp = model.sample_with_log_prob(64, torch.Generator().manual_seed(5))
    assert samples.shape == (64, 10) and samples.dtype == torch.int32
    assert set(np.unique(samples.numpy())) <= {0, 1}
    want = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(samples.numpy())))
    np.testing.assert_allclose(logp.numpy(), want, atol=1e-5)
    again = model.sample(64, torch.Generator().manual_seed(5))
    assert torch.equal(again, samples)


def test_sampler_frequencies_match_exact_density():
    n, draws = 3, 20000
    jans, params, model = _pair(n, (8,), seed=2)
    samples = model.sample(draws, torch.Generator().manual_seed(7)).numpy()
    freq = np.bincount(samples @ (2 ** np.arange(n)), minlength=8) / draws
    basis = jnp.asarray([[(c >> i) & 1 for i in range(n)] for c in range(8)])
    probs = np.exp(np.asarray(jans.log_prob(params, basis)))
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    np.testing.assert_allclose(freq, probs, atol=0.02)


def test_resolve_impl_rules_on_cpu():
    assert not PRNN1D(6, (8,), impl="plain", device="cpu")._use_kernels()
    # auto takes the kernels only when the parameters lie on a CUDA device
    assert not PRNN1D(6, (8,), impl="auto", device="cpu")._use_kernels()
    with pytest.raises(ValueError, match="CUDA"):
        PRNN1D(6, (8,), impl="kernel", device="cpu")._use_kernels()
    with pytest.raises(ValueError, match="support"):
        PRNN1D(6, (8, 8), impl="kernel", device="cpu")._use_kernels()
    with pytest.raises(ValueError, match="unknown impl"):
        PRNN1D(6, (8,), impl="pallas", device="cpu")._use_kernels()

    class Fake:
        impl = "auto"
        device = torch.device("cuda", 0)

    assert resolve_impl(Fake(), lambda: True, "")
    # on the card "auto" never gives way to the plain path: an uncovered
    # configuration raises, and only impl="plain" runs the plain path there
    with pytest.raises(ValueError, match="impl='plain'"):
        resolve_impl(Fake(), lambda: False, "one GRU layer")
    Fake.impl = "plain"
    assert not resolve_impl(Fake(), lambda: False, "")


@pytest.mark.parametrize("units", [(8, 8), (16,)])
def test_auto_on_cuda_raises_outside_coverage(units):
    class CudaModel(PRNN1D):
        device = torch.device("cuda", 0)

        def _kernelizable(self):
            # stands in for the kernel library's shared-memory query
            return self._single_gru() and self.units[0] <= 8

    assert CudaModel(6, (8,), device="cpu")._use_kernels()
    uncovered = CudaModel(6, units, device="cpu")
    with pytest.raises(ValueError, match="support one GRU layer"):
        uncovered.log_prob(torch.zeros(3, 6, dtype=torch.int32))
    with pytest.raises(ValueError, match="support one GRU layer"):
        uncovered.sample_with_log_prob(3, torch.Generator().manual_seed(0))
    assert not CudaModel(6, units, impl="plain", device="cpu")._use_kernels()


@pytest.mark.parametrize(
    "kwargs", [dict(parity=True, cell="lstm"), dict(cell="lstm"), dict(units=(4, 6))]
)
def test_unported_configurations_raise(kwargs):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PRNN1D(6, **kwargs, device="cpu")


def test_plain_positive_and_kernel_coverage():
    model = PRNN1D(100, (50,), device="cpu")
    assert model.plain_positive and not model.is_complex
    assert model._kernelizable()
    assert not PRNN1D(100, (50, 50), device="cpu")._kernelizable()
    # the shared-memory bound is the card's (tests/test_torch_cuda.py); on
    # the CPU the plain versions take any width of a single layer
    assert PRNN1D(10, (200,), device="cpu")._kernelizable()


def test_default_device_is_the_card(monkeypatch):
    """No ``device`` means the card: without CUDA the constructor raises
    (no CPU fallback); with CUDA the rule resolves to ``cuda``.  No CUDA
    tensor is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PRNN1D(5, (8,))
    assert PRNN1D(5, (8,), device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
