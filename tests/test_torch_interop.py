"""PyTorch port: parameter interchange, compensated sums, init and the ED
copy, held against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu.ed import exact as jexact
from rnnwavefunctions_tpu.models.crnn_u1 import CRNNU1 as JCRNNU1
from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.ops import compsum as jcompsum
from rnnwavefunctions_tpu_torch import CRNNU1, PRNN1D, interop
from rnnwavefunctions_tpu_torch.ed import exact
from rnnwavefunctions_tpu_torch.models import cells
from rnnwavefunctions_tpu_torch.ops import compsum

torch.set_num_threads(1)


@pytest.mark.parametrize("units", [(8,), (6, 6)])
def test_params_round_trip_bit_exact(units):
    params = JPRNN1D(num_sites=5, units=units, impl="jnp").init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = PRNN1D(5, units, device="cpu")
    interop.load_params(model, tree)
    back = interop.params_to_numpy(model)
    want, want_def = jax.tree.flatten(tree)
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("units", [(8,), (6, 6)])
def test_crnn_params_round_trip_bit_exact(units):
    """The CRNNU1 tree has two heads; the model, not the keys, says so."""
    params = JCRNNU1(num_sites=6, units=units, impl="jnp").init(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    model = CRNNU1(6, units, device="cpu")
    interop.load_params(model, tree)
    back = interop.params_to_numpy(model)
    want, want_def = jax.tree.flatten(tree)
    got, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # a pRNN tree has no phase head: the cRNN does not take it
    with pytest.raises(KeyError):
        interop.load_params(model, interop.params_to_numpy(PRNN1D(6, units, device="cpu")))


def test_load_params_rejects_wrong_shapes():
    tree = interop.params_to_numpy(PRNN1D(5, (8,), device="cpu"))
    with pytest.raises(ValueError):
        interop.load_params(PRNN1D(5, (6,), device="cpu"), tree)
    with pytest.raises(ValueError):
        interop.load_params(PRNN1D(5, (8, 8), device="cpu"), tree)


def test_kahan_sum_matches_jax_and_float64():
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((400, 6)) * 10.0 - 0.7).astype(np.float32)
    got = compsum.compensated_sum(torch.from_numpy(xs)).numpy()
    want = np.asarray(jcompsum.compensated_sum(jnp.asarray(xs)))
    np.testing.assert_array_equal(got, want)
    exact64 = xs.astype(np.float64).sum(axis=0)
    assert np.abs(got - exact64).max() < np.abs(xs.sum(axis=0) - exact64).max() + 1e-6
    # along another axis, and one compensated add on its own
    got1 = compsum.compensated_sum(torch.from_numpy(xs.T), dim=1).numpy()
    np.testing.assert_array_equal(got1, got)
    s, c = compsum.kadd(torch.tensor(1e8), torch.tensor(0.0), torch.tensor(1.0))
    js, jc = jcompsum.kadd(jnp.float32(1e8), jnp.float32(0.0), jnp.float32(1.0))
    assert float(s) == float(js) and float(c) == float(jc)
    assert float(compsum.kfinal(s, c)) == float(jcompsum.kfinal(js, jc))


def test_kahan_sum_keeps_minus_infinity():
    xs = np.array([[-1.0, 0.5], [-np.inf, 0.25], [-2.0, 0.125]], np.float32)
    got = compsum.compensated_sum(torch.from_numpy(xs)).numpy()
    want = np.asarray(jcompsum.compensated_sum(jnp.asarray(xs)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == -np.inf and got[1] == 0.875


def test_glorot_init_is_seeded_and_bounded():
    a = PRNN1D(7, (16,), device="cpu").init(torch.Generator().manual_seed(3)).requires_grad_(False)
    b = PRNN1D(7, (16,), device="cpu").init(torch.Generator().manual_seed(3))
    c = PRNN1D(7, (16,), device="cpu").init(torch.Generator().manual_seed(4))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.rnn[0].wh, c.rnn[0].wh)
    limit = np.sqrt(6.0 / (16 + 48))
    assert float(a.rnn[0].wh.abs().max()) <= limit
    assert float(a.rnn[0].wh.abs().max()) > 0.5 * limit
    assert float(a.rnn[0].bx.abs().max()) == 0.0 and float(a.head.b.abs().max()) == 0.0
    w = torch.empty(2, 48)
    cells.glorot_(w, torch.Generator().manual_seed(0))
    assert float(w.abs().max()) <= np.sqrt(6.0 / 50)


def test_ed_copy_matches_jax_package():
    for n, bx in [(5, 1.0), (6, 0.7)]:
        np.testing.assert_array_equal(exact.tfim1d_dense(n, bx), jexact.tfim1d_dense(n, bx))
        h = exact.tfim1d_dense(n, bx)
        assert exact.ground_state_energy(h) == jexact.ground_state_energy(h)
