"""PyTorch port: the per-sample log-derivative rows of minSR
(``vmc/jacobian.py``) and the plain versions of the jacobian kernels B17,
B19 and B20 (``ops/fused_jac.py``), held on the CPU against the JAX
package's jnp rows and its Pallas kernels in interpret mode.  The kernels
themselves are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerance: rows to 1e-4 relative and 2e-5 absolute, the JAX package's own
for its fused rows (tests/test_fused_jac.py): f32 sums over sites taken in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.models.crnn_u1 import CRNNU1 as JCRNNU1
from rnnwavefunctions_tpu.models.mdrnn2d import MDRNN2D as JMDRNN2D
from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.models.prnn_snake2d import PRNNSnake2D as JPRNNSnake2D
from rnnwavefunctions_tpu.ops import fused_jac as jfused_jac
from rnnwavefunctions_tpu.vmc import jacobian as jjacobian
from rnnwavefunctions_tpu.vmc import minsr as jminsr
from rnnwavefunctions_tpu_torch import CRNNU1, MDRNN2D, PRNN1D, PRNNSnake2D, interop
from rnnwavefunctions_tpu_torch.ops import fused_jac
from rnnwavefunctions_tpu_torch.vmc import jacobian, minsr

torch.set_num_threads(1)

N, U, S = 8, 8, 24


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                        params)


def _pair(jans, model, seed=0):
    """JAX params (Glorot plus seeded noise, so no bias is zero) and the port's
    model holding the same values."""
    params = _perturbed(jans.init(jax.random.PRNGKey(seed)), seed)
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return params, model


def _chains(b, n, seed=1):
    return np.random.default_rng(seed).integers(0, 2, (b, n)).astype(np.int32)


def _sector(b, n, seed=1):
    """Chains with n/2 ups (the U(1) sector the cRNN's sampler draws)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) < n // 2 for _ in range(b)]).astype(np.int32)


def _assert_tree_close(got, want, rtol=1e-4, atol=2e-5):
    got_leaves, want_leaves = interop.tree_leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("units", [(U,), (U, U)], ids=["1-layer", "2-layer"])
def test_prnn1d_rows_match_jax(units):
    params, model = _pair(JPRNN1D(num_sites=N, units=units, impl="jnp"),
                          PRNN1D(N, units, device="cpu"))
    s = _chains(S, N)
    want = jjacobian.log_amp_rows(JPRNN1D(num_sites=N, units=units, impl="jnp"), params,
                                  jnp.asarray(s))
    _assert_tree_close(jacobian.log_amp_rows(model, torch.from_numpy(s)), want)


def test_parity_rows_match_jax():
    jans = JPRNN1D(num_sites=N, units=(U,), parity=True, impl="jnp")
    params, model = _pair(jans, PRNN1D(N, (U,), parity=True, device="cpu"), seed=2)
    s = _chains(S, N, seed=3)
    _assert_tree_close(jacobian.log_amp_rows(model, torch.from_numpy(s)),
                       jjacobian.log_amp_rows(jans, params, jnp.asarray(s)))


def test_snake_rows_match_jax():
    jans = JPRNNSnake2D(4, 3, units=(U,), impl="jnp")
    params, model = _pair(jans, PRNNSnake2D(4, 3, (U,), device="cpu"), seed=4)
    s = _chains(S, 12, seed=5)
    _assert_tree_close(jacobian.log_amp_rows(model, torch.from_numpy(s)),
                       jjacobian.log_amp_rows(jans, params, jnp.asarray(s)))


@pytest.mark.parametrize("units", [(U,), (U, U)], ids=["1-layer", "2-layer"])
def test_crnn_rows_match_jax(units):
    jans = JCRNNU1(num_sites=N, units=units, impl="jnp")
    params, model = _pair(jans, CRNNU1(N, units, device="cpu"), seed=6)
    s = _sector(S, N, seed=7)
    want_re, want_im = jjacobian.crnn_log_amp_rows(jans, params, jnp.asarray(s))
    got_re, got_im = jacobian.crnn_log_amp_rows(model, torch.from_numpy(s))
    _assert_tree_close(got_re, want_re)
    _assert_tree_close(got_im, want_im)


def test_crnn_head_seeds_match_jax():
    jans = JCRNNU1(num_sites=N, units=(U,), impl="jnp")
    params, model = _pair(jans, CRNNU1(N, (U,), device="cpu"), seed=8)
    s = _sector(S, N, seed=9)
    top = np.random.default_rng(10).standard_normal((N, S, U)).astype(np.float32)
    targets = s.T
    cum_up = np.cumsum(targets, axis=0) - targets
    want = jjacobian.crnn_head_seeds(jans, params, jnp.asarray(top), jnp.asarray(targets),
                                     jnp.asarray(cum_up))
    got = jacobian.crnn_head_seeds(model, torch.from_numpy(top), torch.from_numpy(targets),
                                   torch.from_numpy(cum_up), torch.arange(N)[:, None])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nx, ny", [(3, 3), (4, 3)], ids=["3x3", "4x3"])
def test_mdrnn_rows_match_jax(nx, ny):
    jans = JMDRNN2D(nx=nx, ny=ny, units=U, impl="jnp")
    params, model = _pair(jans, MDRNN2D(nx, ny, U, device="cpu"), seed=11)
    s = np.random.default_rng(12).integers(0, 2, (S, nx, ny)).astype(np.int32)
    _assert_tree_close(jacobian.log_amp_rows(model, torch.from_numpy(s)),
                       jjacobian.log_amp_rows(jans, params, jnp.asarray(s)))


@pytest.mark.parametrize("n,b", [(1, 4), (6, 5), (100, 3)], ids=["n1", "odd-b", "long"])
def test_b17_plain_matches_pallas_interpret(n, b):
    """B17's plain version (K2's plain replay and reverse sweep with g = 1)
    against the JAX kernel in interpret mode, output by output: the JAX
    layouts are feature-major, the port's A and C rows are read column for
    column as (hist, dg, dl1); then the rows and log p of prnn1d_rows (one
    product A_s^T C_s per sample)."""
    jans = JPRNN1D(num_sites=n, units=(U,))
    params, model = _pair(jans, PRNN1D(n, (U,), device="cpu"), seed=13)
    s = _chains(b, n, seed=14)
    with pltpu.force_tpu_interpret_mode():
        hist, dg, dl1 = jfused_jac.jac_sweep(params, jnp.asarray(s))
        want_lp, want_rows = jfused_jac.prnn1d_rows(jans, params, jnp.asarray(s))
    w = tuple(t.detach() for t in model.weights())
    got = fused_jac.jac_sweep(w, torch.from_numpy(s))
    for g, ref in zip((got.hist, got.dg, got.dl1),
                      (np.transpose(hist, (2, 0, 1)), np.transpose(dg, (2, 0, 1)),
                       np.asarray(dl1).T)):
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=2e-6)
    got_lp, got_rows = fused_jac.prnn1d_rows(w, torch.from_numpy(s))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5 * n)
    _assert_tree_close(got_rows, want_rows)


def test_b19_b20_plain_match_pallas_interpret():
    """B19 and B20 (two parts) against the JAX kernels in interpret mode, and
    the cRNN's rows through them against the JAX package's fused rows."""
    n, b = 6, 5
    jans = JCRNNU1(num_sites=n, units=(U,))
    params, model = _pair(jans, CRNNU1(n, (U,), device="cpu"), seed=15)
    s = _sector(b, n, seed=16)
    douts = np.random.default_rng(17).standard_normal((2, b, n, U)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        hist = jfused_jac.rollout_hist(params, jnp.asarray(s))
        dgs = jfused_jac.sweep_dgates(params, jnp.asarray(s), hist,
                                      [jnp.transpose(d, (1, 2, 0)) for d in douts])
        want_re, want_im = jjacobian._crnn_rows_fused(jans, params, jnp.asarray(s))
    trunk = tuple(t.detach() for t in model.weights()[:4])
    got_hist = fused_jac.rollout_hist(trunk, torch.from_numpy(s))
    np.testing.assert_allclose(got_hist.numpy(), np.transpose(hist, (2, 0, 1)),
                               rtol=1e-5, atol=1e-6)
    got_dg = fused_jac.sweep_dgates(trunk, torch.from_numpy(s), got_hist,
                                    torch.from_numpy(douts))
    for p in range(2):
        np.testing.assert_allclose(got_dg[p].numpy(), np.transpose(dgs[p], (2, 0, 1)),
                                   rtol=1e-4, atol=2e-6)
    got_re, got_im = jacobian._crnn_rows_fused(model, torch.from_numpy(s))
    _assert_tree_close(got_re, want_re)
    _assert_tree_close(got_im, want_im)


def test_kernel_rows_equal_plain_rows():
    """Within the port: the rows through the kernels' plain versions equal
    the autodiff rows (what chip_smoke.py holds the kernels to on the card)."""
    model = PRNN1D(N, (U,), device="cpu").init(torch.Generator().manual_seed(0))
    s = torch.from_numpy(_chains(S, N, seed=18))
    _, rows = fused_jac.prnn1d_rows(tuple(t.detach() for t in model.weights()), s)
    _, want = jacobian._prnn1d_log_prob_rows(model, s)
    for g, w in zip(interop.tree_leaves(rows), interop.tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=2e-5)
    crnn = CRNNU1(N, (U,), device="cpu").init(torch.Generator().manual_seed(1))
    s = torch.from_numpy(_sector(S, N, seed=19))
    plain_model = CRNNU1(N, (U,), impl="plain", device="cpu")
    plain_model.load_state_dict(crnn.state_dict())
    for got, want in zip(jacobian._crnn_rows_fused(crnn, s),
                         jacobian.crnn_log_amp_rows(plain_model, s)):
        for g, w in zip(interop.tree_leaves(got), interop.tree_leaves(want)):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=2e-5)


def test_generic_rows_match_jax():
    """An ansatz outside jacobian.supports (an MDRNN with local_dim=3) takes
    the generic rows, torch.func over the plain path, against the JAX
    package's vmap of grad; and the generic rows of a covered ansatz equal
    its stash-and-contract rows."""
    jans = JMDRNN2D(nx=2, ny=2, units=U, local_dim=3, impl="jnp")
    params, model = _pair(jans, MDRNN2D(2, 2, U, local_dim=3, device="cpu"), seed=20)
    assert not jacobian.supports(model) and not jjacobian.supports(jans)
    s = np.random.default_rng(21).integers(0, 3, (6, 2, 2)).astype(np.int32)
    got, got_im = minsr.per_sample_log_amp_grad_trees(model, torch.from_numpy(s))
    want, _ = jminsr.per_sample_log_amp_grad_trees(jans, params, jnp.asarray(s))
    assert got_im is None
    _assert_tree_close(got, want)
    prnn = PRNN1D(5, (U,), device="cpu").init(torch.Generator().manual_seed(2))
    s = torch.from_numpy(_chains(6, 5, seed=22))
    generic, _ = minsr._generic_rows(prnn, s)
    for g, w in zip(interop.tree_leaves(generic),
                    interop.tree_leaves(jacobian.log_amp_rows(prnn, s))):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=2e-5)


def test_supports_matches_jax():
    cases = [
        (PRNN1D(4, (U,), device="cpu"), JPRNN1D(num_sites=4, units=(U,))),
        (PRNN1D(4, (U,), local_dim=3, device="cpu"), JPRNN1D(num_sites=4, units=(U,),
                                                              local_dim=3)),
        (CRNNU1(4, (U,), device="cpu"), JCRNNU1(num_sites=4, units=(U,))),
        (MDRNN2D(2, 2, U, device="cpu"), JMDRNN2D(nx=2, ny=2, units=U)),
        (MDRNN2D(2, 2, U, local_dim=3, device="cpu"), JMDRNN2D(nx=2, ny=2, units=U,
                                                               local_dim=3)),
    ]
    for port, jax_ansatz in cases:
        assert jacobian.supports(port) == jjacobian.supports(jax_ansatz)
