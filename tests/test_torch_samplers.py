"""PyTorch port: the stand-alone samplers B5 (GRU, ``fused_gru.gru_sample``)
and B8 (U(1) cRNN, ``fused_crnn.crnn_sample``) — their plain versions on CPU
tensors, and the models' samplers that call them — held against the JAX
package's teacher-forced jnp paths and the exact densities on the CPU.  The
kernels draw from Philox keyed by (seed, offset) and match K3's and B11's
draws bit for bit on the card (tests/test_torch_cuda.py, chip_smoke.py);
off the card the counterpart is that the plain samplers take the same
uniforms, ``plain_uniforms(seed, offset)``, as the plain K3 and B11."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu.models.crnn_u1 import CRNNU1 as JCRNNU1
from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu_torch import CRNNU1, MDRNN2D, PRNN1D, interop
from rnnwavefunctions_tpu_torch.ops import fused_crnn, fused_gru, fused_mdrnn, launch
from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk
from rnnwavefunctions_tpu_torch.ops import mdrnn_flip_kernel as mk
from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk

torch.set_num_threads(1)

U, B = 10, 41


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                        params)


def _prnn_pair(n, seed=0):
    jans = JPRNN1D(num_sites=n, units=(U,), impl="jnp")
    params = _perturbed(jans.init(jax.random.PRNGKey(seed)), seed)
    model = PRNN1D(n, (U,), device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return jans, params, model


def _crnn_pair(n, seed=0, u1=True):
    jans = JCRNNU1(num_sites=n, units=(U,), u1=u1, impl="jnp")
    params = _perturbed(jans.init(jax.random.PRNGKey(seed)), seed)
    model = CRNNU1(n, (U,), u1=u1, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return jans, params, model


def _weights(model):
    return tuple(w.detach() for w in model.weights())


def _basis(n):
    return np.asarray([[(c >> i) & 1 for i in range(n)] for c in range(1 << n)], np.int32)


def test_b5_plain_log_prob_is_the_teacher_forced_one():
    n = 9
    jans, params, model = _prnn_pair(n, seed=1)
    w = _weights(model)
    s, lp = fused_gru.gru_sample(w, B, n, 7, 3)
    assert s.shape == (B, n) and s.dtype == torch.int32
    assert set(np.unique(s.numpy())) <= {0, 1}
    torch.testing.assert_close(lp, fused_gru.log_prob_plain(w, s), atol=0, rtol=0)
    want = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(s.numpy())))
    np.testing.assert_allclose(lp.numpy(), want, atol=1e-5 * n)
    assert torch.equal(fused_gru.gru_sample(w, B, n, 7, 3)[0], s)
    assert not torch.equal(fused_gru.gru_sample(w, B, n, 7, 4)[0], s)
    with pytest.raises(ValueError, match="2\\^32"):
        fused_gru.gru_sample(w, B, n, -1, 0)
    assert fused_gru.gru_sample.launches == 0  # the CPU path launches nothing


def test_b5_plain_draws_equal_k3_plain_draws():
    n = 8
    _, _, model = _prnn_pair(n, seed=2)
    w = _weights(model)
    s5, lp5 = fused_gru.gru_sample(w, B, n, 11, 12)
    s3, lp3, _ = tk.tfim_sample_and_flip_sum(w, B, n, 11, 12)
    assert torch.equal(s5, s3)
    torch.testing.assert_close(lp5, lp3, atol=0, rtol=0)
    uni = launch.plain_uniforms(B, n, 11, 12, "cpu")
    s_p, lp_p = fused_gru.sample_plain(w, uni)
    assert torch.equal(s_p, s5)
    torch.testing.assert_close(lp_p, lp5, atol=0, rtol=0)


def test_b5_frequencies_match_exact_density():
    n, draws = 3, 20000
    jans, params, model = _prnn_pair(n, seed=3)
    s, _ = fused_gru.gru_sample(_weights(model), draws, n, 21, 0)
    freq = np.bincount(s.numpy() @ (2 ** np.arange(n)), minlength=8) / draws
    probs = np.exp(np.asarray(jans.log_prob(params, jnp.asarray(_basis(n)))))
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    np.testing.assert_allclose(freq, probs, atol=0.02)


@pytest.mark.parametrize("u1", [True, False], ids=["u1", "no_u1"])
def test_b8_plain_log_prob_is_the_teacher_forced_one(u1):
    n = 10
    jans, params, model = _crnn_pair(n, seed=4, u1=u1)
    w = _weights(model)
    s, lp = fused_crnn.crnn_sample(w, B, n, 5, 6, u1)
    assert s.shape == (B, n) and s.dtype == torch.int32
    re, _ = fused_crnn.log_amp_parts_plain(w, s, u1)
    torch.testing.assert_close(lp, 2.0 * re, atol=0, rtol=0)
    want = np.asarray(jans.log_prob(params, jnp.asarray(s.numpy())))
    np.testing.assert_allclose(lp.numpy(), want, atol=2e-5 * n)
    if u1:  # the sector
        np.testing.assert_array_equal(s.sum(dim=1).numpy(), n // 2)
    assert torch.equal(fused_crnn.crnn_sample(w, B, n, 5, 6, u1)[0], s)
    assert not torch.equal(fused_crnn.crnn_sample(w, B, n, 5, 7, u1)[0], s)
    with pytest.raises(ValueError, match="2\\^32"):
        fused_crnn.crnn_sample(w, B, n, 0, 2**32, u1)
    assert fused_crnn.crnn_sample.launches == 0


def test_b8_plain_draws_equal_b11_plain_draws():
    n = 8
    _, _, model = _crnn_pair(n, seed=5)
    w = _weights(model)
    s8, lp8 = fused_crnn.crnn_sample(w, B, n, 13, 14, True)
    s11, _, _, lp_re, _ = jk.j1j2_sample_and_exchange(
        w, B, n, 13, 14, u1=True, el_nn=0.5, el_nnn=0.1, has_nnn=True)
    assert torch.equal(s8, s11)
    torch.testing.assert_close(lp8, 2.0 * lp_re, atol=0, rtol=0)


def test_b8_frequencies_match_exact_density_in_the_sector():
    n, draws = 4, 20000
    jans, params, model = _crnn_pair(n, seed=6)
    s, _ = fused_crnn.crnn_sample(_weights(model), draws, n, 23, 0, True)
    np.testing.assert_array_equal(s.sum(dim=1).numpy(), n // 2)
    freq = np.bincount(s.numpy() @ (2 ** np.arange(n)), minlength=16) / draws
    probs = np.exp(np.asarray(jans.log_prob(params, jnp.asarray(_basis(n)))))
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    assert (probs > 0).sum() == 6
    np.testing.assert_allclose(freq, probs, atol=0.02)


def test_models_sample_through_b5_and_b8_on_the_kernel_path(monkeypatch):
    """With the kernel path taken (faked: CPU tensors run the plain
    versions), PRNN1D.sample calls B5 and CRNNU1.sample calls B8 with a key
    drawn from the generator; neither touches K3's or B11's wrapper."""
    n = 8
    _, _, prnn = _prnn_pair(n, seed=7)
    _, _, crnn = _crnn_pair(n, seed=8)
    for model in (prnn, crnn):
        monkeypatch.setattr(model, "_use_kernels", lambda: True)
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapper(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, name, wrapper)

    def refuse(*args, **kwargs):
        pytest.fail("a fused sample-and-estimate kernel ran")

    spy(fused_gru, "gru_sample")
    spy(fused_crnn, "crnn_sample")
    monkeypatch.setattr(tk, "tfim_sample_and_flip_sum", refuse)
    monkeypatch.setattr(jk, "j1j2_sample_and_exchange", refuse)
    s, lp = prnn.sample_with_log_prob(B, torch.Generator().manual_seed(9))
    key = torch.randint(0, 2**32, (2,), generator=torch.Generator().manual_seed(9),
                        dtype=torch.int64).tolist()
    want, want_lp = fused_gru.sample_plain(_weights(prnn),
                                           launch.plain_uniforms(B, n, *key, "cpu"))
    assert torch.equal(s, want)
    torch.testing.assert_close(lp, want_lp, atol=0, rtol=0)
    s, lp = crnn.sample_with_log_prob(B, torch.Generator().manual_seed(10))
    np.testing.assert_array_equal(s.sum(dim=1).numpy(), n // 2)
    torch.testing.assert_close(lp, crnn.log_prob(s).detach(), atol=2e-5 * n, rtol=0)
    assert calls == ["gru_sample", "crnn_sample"]


# every wrapper that draws from a key: (its weights' model, the call at a
# 4-site chain or a 2x2 lattice)
KEYED = {
    "gru_sample": ("prnn", lambda w, b, key: fused_gru.gru_sample(w, b, 4, *key)),
    "tfim_sample_and_flip_sum": (
        "prnn", lambda w, b, key: tk.tfim_sample_and_flip_sum(w, b, 4, *key)),
    "tfim_sample_and_flip_log_probs": (
        "prnn", lambda w, b, key: tk.tfim_sample_and_flip_log_probs(w, b, 4, *key)),
    "crnn_sample": ("crnn", lambda w, b, key: fused_crnn.crnn_sample(w, b, 4, *key, True)),
    "j1j2_sample_and_exchange": ("crnn", lambda w, b, key: jk.j1j2_sample_and_exchange(
        w, b, 4, *key, u1=True, el_nn=0.5, el_nnn=0.1, has_nnn=True)),
    "mdrnn_sample": ("mdrnn", lambda w, b, key: fused_mdrnn.mdrnn_sample(w, b, 2, 2, *key)),
    "mdrnn_sample_and_flip_sum": (
        "mdrnn", lambda w, b, key: mk.mdrnn_sample_and_flip_sum(w, b, 2, 2, *key)),
}


@pytest.mark.parametrize("name", sorted(KEYED))
def test_keyed_samplers_refuse_a_bad_key_and_an_empty_draw_on_the_cpu(name):
    """Each sampler runs the same prologue on both devices: the key's words
    in [0, 2^32) and at least one sample, checked before the plain version
    runs."""
    models = {"prnn": lambda: PRNN1D(4, (U,), device="cpu"),
              "crnn": lambda: CRNNU1(4, (U,), device="cpu"),
              "mdrnn": lambda: MDRNN2D(2, 2, U, device="cpu")}
    kind, draw = KEYED[name]
    w = _weights(models[kind]().init(torch.Generator().manual_seed(0)))
    assert draw(w, 3, (5, 6))[0].shape[0] == 3
    for key in ((2**32, 0), (0, -1)):
        with pytest.raises(ValueError, match="2\\^32"):
            draw(w, 3, key)
    with pytest.raises(ValueError, match=">= 1"):
        draw(w, 0, (5, 6))
