"""PyTorch port: K1 (teacher-forced log p) and K2 (its VJP) through their
wrappers and the autograd Function, held on the CPU against the JAX jnp
path and the JAX package's Pallas kernels in interpret mode.  On a CPU
tensor every wrapper runs its plain version; the kernels themselves are
checked on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.ops import fused_gru as jfused_gru
from rnnwavefunctions_tpu.ops.fused_gru_bwd import gru_log_prob_bwd as jgru_log_prob_bwd
from rnnwavefunctions_tpu_torch import PRNN1D, interop
from rnnwavefunctions_tpu_torch.ops import fused_gru, fused_gru_bwd, launch

torch.set_num_threads(1)

N, U, B = 12, 16, 37


@pytest.fixture(scope="module")
def setup():
    jans = JPRNN1D(num_sites=N, units=(U,), impl="jnp")
    params = jans.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    model = PRNN1D(N, (U,), device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    samples = rng.integers(0, 2, (B, N)).astype(np.int32)
    g = rng.standard_normal(B).astype(np.float32)
    return jans, params, model, samples, g


def _weights(model):
    return tuple(w.detach() for w in model.weights())


def test_k1_plain_matches_jnp_and_pallas_interpret(setup):
    jans, params, model, samples, _ = setup
    got = fused_gru.gru_log_prob(_weights(model), torch.from_numpy(samples)).numpy()
    want = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(samples)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jfused_gru._log_prob_pallas(params, jnp.asarray(samples)))
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    assert fused_gru.gru_log_prob.launches == 0  # the CPU path launches nothing


def test_k2_plain_matches_jax_grad_and_pallas_interpret(setup):
    jans, params, model, samples, g = setup
    got = fused_gru_bwd.gru_log_prob_bwd(
        _weights(model), torch.from_numpy(samples), torch.from_numpy(g)
    )
    want = jax.grad(
        lambda p: jnp.sum(jnp.asarray(g) * jans._log_prob_plain_jnp(p, jnp.asarray(samples)))
    )(params)
    with pltpu.force_tpu_interpret_mode():
        pallas = jgru_log_prob_bwd(params, jnp.asarray(samples), jnp.asarray(g))
    for ref in (want, pallas):
        flat = [ref["rnn"][0][k] for k in ("wx", "wh", "bx", "bh")]
        flat += [ref["head"]["w"], ref["head"]["b"]]
        for a, b in zip(got, flat):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert fused_gru_bwd.gru_log_prob_bwd.launches == 0


def test_autograd_function_matches_jax_grad(setup):
    jans, params, model, samples, g = setup
    ws = [w.detach().clone().requires_grad_(True) for w in model.weights()]
    lp = fused_gru.log_prob(tuple(ws), torch.from_numpy(samples))
    want_lp = np.asarray(jans._log_prob_plain_jnp(params, jnp.asarray(samples)))
    np.testing.assert_allclose(lp.detach().numpy(), want_lp, atol=1e-5)
    # a mean over samples hands backward an expanded (non-contiguous) cotangent
    (torch.from_numpy(g) * lp).mean().backward()
    want = jax.grad(
        lambda p: jnp.mean(jnp.asarray(g) * jans._log_prob_plain_jnp(p, jnp.asarray(samples)))
    )(params)
    flat = [want["rnn"][0][k] for k in ("wx", "wh", "bx", "bh")]
    flat += [want["head"]["w"], want["head"]["b"]]
    for w, b in zip(ws, flat):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(b), atol=1e-5)


def test_wrappers_raise_instead_of_falling_back(setup):
    _, _, model, samples, g = setup
    ws = _weights(model)
    meta = tuple(w.to("meta") for w in ws)
    with pytest.raises(ValueError, match="devices"):
        fused_gru.gru_log_prob(meta, torch.from_numpy(samples).to("meta"))
    with pytest.raises(ValueError, match="devices"):
        fused_gru.gru_log_prob(ws, torch.from_numpy(samples).to("meta"))
    with pytest.raises(ValueError, match="int32"):
        launch.check_samples(torch.from_numpy(samples).long())
    with pytest.raises(ValueError, match="contiguous"):
        launch.check_samples(torch.from_numpy(samples).T)
    with pytest.raises(ValueError, match="float32"):
        launch.check_weights((ws[0].double(),) + ws[1:])
    with pytest.raises(ValueError, match="6 weight"):
        launch.check_weights(ws[:5])
    assert launch.check_weights(ws) == U


def test_kernel_coverage_and_shared_memory():
    cpu = torch.device("cpu")
    assert fused_gru.supports(100, (50,), cpu)
    assert not fused_gru.supports(100, (50, 50), cpu)
    assert not fused_gru.supports(0, (50,), cpu)
    # the shared-memory bound is asked of the kernel library on the card
    # (tests/test_torch_cuda.py); the plain versions take any width
    assert fused_gru.supports(100, (256,), cpu)
