"""PyTorch port: the complex U(1) cRNN — B7 ((Re, Im) log psi), B9 (its
VJP) and CRNNU1 (init, sampler, dispatch) — held on the CPU against the JAX
package's jnp path and its Pallas kernels in interpret mode.  On a CPU
tensor every wrapper runs its plain version; the kernels themselves are
checked on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.models.crnn_u1 import CRNNU1 as JCRNNU1
from rnnwavefunctions_tpu.ops import fused_crnn as jfused_crnn
from rnnwavefunctions_tpu.ops.fused_crnn_bwd import crnn_log_amp_bwd as jcrnn_log_amp_bwd
from rnnwavefunctions_tpu_torch import CRNNU1, PRNN1D, interop
from rnnwavefunctions_tpu_torch.models import cells
from rnnwavefunctions_tpu_torch.ops import fused_crnn, fused_crnn_bwd

torch.set_num_threads(1)

U, B = 12, 37


def _pair(n, units=(U,), u1=True, seed=0):
    """A JAX CRNNU1 with its params and the port's CRNNU1 holding the same
    parameters (JAX-initialised, every tensor perturbed so the biases are
    not zero)."""
    jans = JCRNNU1(num_sites=n, units=units, u1=u1, impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    model = CRNNU1(n, units, u1=u1, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return jans, params, model


def sector_samples(b, n, seed=1):
    """Zero-magnetisation samples: random permutations of N/2 ones."""
    rng = np.random.default_rng(seed)
    base = np.array([1] * (n // 2) + [0] * (n - n // 2), np.int32)
    return np.stack([rng.permutation(base) for _ in range(b)])


def _weights(model):
    return tuple(w.detach() for w in model.weights())


def _parts(model, samples):
    re, im = fused_crnn.crnn_log_amp_parts(_weights(model), torch.from_numpy(samples),
                                           model.u1)
    return re.numpy(), im.numpy()


@pytest.mark.parametrize("u1", [True, False], ids=["u1", "no_u1"])
@pytest.mark.parametrize("n", [10, 9], ids=["even", "odd"])
@pytest.mark.parametrize("sector", [True, False], ids=["in_sector", "out_of_sector"])
def test_b7_plain_matches_jnp_and_pallas_interpret(u1, n, sector):
    jans, params, model = _pair(n, u1=u1)
    rng = np.random.default_rng(3)
    samples = (sector_samples(B, n) if sector
               else rng.integers(0, 2, (B, n)).astype(np.int32))
    re, im = _parts(model, samples)
    tol = 1e-5 * n  # f32 site recurrences summed in another order
    want_re, want_im = (np.asarray(a) for a in jans._log_amp_parts_jnp(params, jnp.asarray(samples)))
    # the jnp path takes log 0 = -inf for a masked target; the kernels and
    # the port the finite LOG_ZERO stand-in
    finite = np.isfinite(want_re)
    assert not u1 or n % 2 or not sector or finite.all()
    np.testing.assert_allclose(re[finite], want_re[finite], atol=tol)
    np.testing.assert_allclose(im[finite], want_im[finite], atol=tol)
    assert np.all(re[~finite] <= 0.25 * fused_crnn.LOG_ZERO)
    with pltpu.force_tpu_interpret_mode():
        p_re, p_im = (np.asarray(a) for a in jfused_crnn.crnn_log_amp_parts(
            params, jnp.asarray(samples), u1))
    np.testing.assert_allclose(re, p_re, atol=tol, rtol=1e-6)
    np.testing.assert_allclose(im, p_im, atol=tol)
    assert fused_crnn.crnn_log_amp_parts.launches == 0  # the CPU path launches nothing


def _close_rel(got, want, rel=1e-4):
    """Agreement to ``rel`` of the largest entry (f32 sums in another order)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("u1", [True, False], ids=["u1", "no_u1"])
def test_b9_plain_matches_jax_grad_and_pallas_interpret(u1):
    n = 10
    jans, params, model = _pair(n, u1=u1, seed=4)
    samples = sector_samples(B, n, seed=5)  # gradients are defined in the sector only
    rng = np.random.default_rng(6)
    g_re, g_im = (rng.standard_normal(B).astype(np.float32) for _ in range(2))
    got = fused_crnn_bwd.crnn_log_amp_bwd(
        _weights(model), torch.from_numpy(samples), torch.from_numpy(g_re),
        torch.from_numpy(g_im), u1)

    def loss(p):
        re, im = jans._log_amp_parts_jnp(p, jnp.asarray(samples))
        return jnp.sum(g_re * re) + jnp.sum(g_im * im)

    want = jax.grad(loss)(params)
    with pltpu.force_tpu_interpret_mode():
        pallas = jcrnn_log_amp_bwd(params, jnp.asarray(samples), jnp.asarray(g_re),
                                   jnp.asarray(g_im), u1)
    names = ("wx", "wh", "bx", "bh")
    for ref in (want, pallas):
        flat = [ref["rnn"][0][k] for k in names] + [
            ref[h][k] for h in ("head_ampl", "head_phase") for k in ("w", "b")]
        for a, b in zip(got, flat):
            _close_rel(a.numpy(), np.asarray(b))
    assert fused_crnn_bwd.crnn_log_amp_bwd.launches == 0


def test_autograd_function_matches_plain_autograd():
    """The Function (B7 forward, B9 backward) and autograd through the plain
    loop give the same values and gradients."""
    n = 8
    _, _, model = _pair(n, seed=7)
    s = torch.from_numpy(sector_samples(B, n, seed=8))
    g_re, g_im = torch.randn(2, B, generator=torch.Generator().manual_seed(9))
    ws = [w.detach().requires_grad_(True) for w in model.weights()]
    re, im = fused_crnn.log_amp_parts(ws, s, True)
    ((g_re * re).sum() + (g_im * im).sum()).backward()
    want = fused_crnn_bwd.log_amp_bwd_plain(_weights(model), s, g_re, g_im, True)
    want_re, want_im = fused_crnn.log_amp_parts_plain(_weights(model), s, True)
    torch.testing.assert_close(re.detach(), want_re, atol=0, rtol=0)
    torch.testing.assert_close(im.detach(), want_im, atol=0, rtol=0)
    for w, g in zip(ws, want):
        torch.testing.assert_close(w.grad, g, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("units", [(U,), (8, 8)])
def test_model_log_amp_and_gradient_match_jax(units):
    """CRNNU1's differentiable (Re, Im), its complex view and log_prob,
    single layer and stack, against the JAX jnp path and jax.grad."""
    n = 8
    jans, params, model = _pair(n, units=units, seed=10)
    samples = sector_samples(B, n, seed=11)
    js = jnp.asarray(samples)
    ts = torch.from_numpy(samples)
    want_re, want_im = (np.asarray(a) for a in jans._log_amp_parts_jnp(params, js))
    re, im = model.log_amp_parts(ts)
    np.testing.assert_allclose(re.detach().numpy(), want_re, atol=1e-5 * n)
    np.testing.assert_allclose(im.detach().numpy(), want_im, atol=1e-5 * n)
    la = model.log_amp(ts)
    assert la.dtype == torch.complex64
    np.testing.assert_allclose(la.detach().numpy(), np.asarray(jans.log_amp(params, js)),
                               atol=1e-5 * n)
    np.testing.assert_allclose(model.log_prob(ts).detach().numpy(), 2.0 * want_re,
                               atol=2e-5 * n)
    (re.sum() + 0.5 * im.sum()).backward()
    jgrad = jax.grad(lambda p: (lambda r, i: jnp.sum(r) + 0.5 * jnp.sum(i))(
        *jans._log_amp_parts_jnp(p, js)))(params)
    got = interop.params_to_numpy(model)  # the tree layout, filled below with grads
    got["rnn"] = [{k: getattr(layer, k).grad.numpy() for k in ("wx", "wh", "bx", "bh")}
                  for layer in model.rnn]
    for h in model.head_names:
        got[h] = {"w": getattr(model, h).w.grad.numpy(), "b": getattr(model, h).b.grad.numpy()}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jgrad)):
        _close_rel(a, np.asarray(b))


@pytest.mark.parametrize("units", [(U,), (8, 8)])
def test_sampler_draws_the_sector_with_its_log_prob(units):
    n = 10
    jans, params, model = _pair(n, units=units, seed=12)
    samples, logp = model.sample_with_log_prob(64, torch.Generator().manual_seed(13))
    assert samples.shape == (64, n) and samples.dtype == torch.int32
    np.testing.assert_array_equal(samples.sum(dim=1).numpy(), n // 2)
    want = np.asarray(jans.log_prob(params, jnp.asarray(samples.numpy())))
    np.testing.assert_allclose(logp.numpy(), want, atol=2e-5 * n)
    again = model.sample(64, torch.Generator().manual_seed(13))
    assert torch.equal(again, samples)


def test_sampler_frequencies_match_exact_density():
    """At N=4 the 20k draws' frequencies over the 16 states match |psi|^2 of
    the JAX model: zero outside the six sector states."""
    n, draws = 4, 20000
    jans, params, model = _pair(n, units=(8,), seed=14)
    samples = model.sample(draws, torch.Generator().manual_seed(15)).numpy()
    freq = np.bincount(samples @ (2 ** np.arange(n)), minlength=16) / draws
    basis = jnp.asarray([[(c >> i) & 1 for i in range(n)] for c in range(16)])
    probs = np.exp(np.asarray(jans.log_prob(params, basis)))
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    assert (probs > 0).sum() == 6
    np.testing.assert_allclose(freq, probs, atol=0.02)


def test_init_is_seeded_in_trunk_ampl_phase_order():
    a = CRNNU1(7, (16,), device="cpu").init(torch.Generator().manual_seed(3))
    b = CRNNU1(7, (16,), device="cpu").init(torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    # the same draws as a pRNN's trunk and head, then the phase head's
    gen = torch.Generator().manual_seed(3)
    p = PRNN1D(7, (16,), device="cpu").init(gen)
    for k in ("wx", "wh"):
        assert torch.equal(getattr(a.rnn[0], k), getattr(p.rnn[0], k))
    assert torch.equal(a.head_ampl.w, p.head.w)
    assert torch.equal(a.head_phase.w, cells.glorot_(torch.empty(16, 2), gen))
    assert not torch.equal(a.head_ampl.w, a.head_phase.w)
    assert float(a.rnn[0].bx.detach().abs().max()) == 0.0
    assert float(a.head_phase.b.detach().abs().max()) == 0.0
    assert float(a.head_phase.w.abs().max()) <= np.sqrt(6.0 / 18)
    assert a.is_complex and not a.plain_positive


@pytest.mark.parametrize("kwargs", [dict(cell="lstm"), dict(units=(4, 6)), dict(local_dim=3)])
def test_unported_configurations_raise(kwargs):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        CRNNU1(6, **kwargs, device="cpu")


def test_default_device_and_dispatch_rules(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CRNNU1(6, (8,))
    assert not CRNNU1(6, (8,), device="cpu")._use_kernels()
    with pytest.raises(ValueError, match="CUDA"):
        CRNNU1(6, (8,), impl="kernel", device="cpu")._use_kernels()
    with pytest.raises(ValueError, match="support one GRU layer"):
        CRNNU1(6, (8, 8), impl="kernel", device="cpu")._use_kernels()
    # on the CPU the plain versions take any width of a single layer
    assert CRNNU1(100, (50,), device="cpu")._kernelizable()
    assert not CRNNU1(100, (50, 50), device="cpu")._kernelizable()
