"""PyTorch port: the snake-ordered 1D pRNN on a 2D lattice (PRNNSnake2D, a
PRNN1D over Nx*Ny sites on the flat-encoded TFIM2D) — log p, the lattice
attribute, the pytree, local energies (generic and "plain_flip"), the
dispatch by encoding and a short run against exact diagonalization — held
on the CPU against the JAX package's PRNNSnake2D and dense H.

Tolerances: log p 1e-5 per site (f32 recurrences summed in another order),
local energies 1e-5 relative (2e-4 against dense H, whose amplitude table
is built from a separate pass)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu.hamiltonians.tfim2d import TFIM2D as JTFIM2D
from rnnwavefunctions_tpu.models.prnn_snake2d import PRNNSnake2D as JPRNNSnake2D
from rnnwavefunctions_tpu.vmc import local_energy as jle
from rnnwavefunctions_tpu_torch import (
    PRNN1D, PRNNSnake2D, TFIM2D, TrainConfig, VMCTrainer, interop,
)
from rnnwavefunctions_tpu_torch.ed import exact
from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk
from rnnwavefunctions_tpu_torch.vmc import local_energy as le

torch.set_num_threads(1)

U, B = 10, 29


def _pair(nx, ny, seed=0, units=(U,)):
    """The JAX PRNNSnake2D with its params and the port's holding the same
    parameters (JAX-initialised, every tensor perturbed)."""
    jans = JPRNNSnake2D(nx, ny, units=units, impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    model = PRNNSnake2D(nx, ny, units, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return jans, params, model


def _samples(b, n, seed=1):
    return np.random.default_rng(seed).integers(0, 2, (b, n)).astype(np.int32)


@pytest.mark.parametrize("shape", [(3, 2), (3, 4)], ids=["3x2", "3x4"])
@pytest.mark.parametrize("units", [(U,), (6, 6)])
def test_log_prob_matches_jax(shape, units):
    nx, ny = shape
    jans, params, model = _pair(nx, ny, seed=2, units=units)
    s = _samples(B, nx * ny, seed=3)
    want = np.asarray(jans.log_prob(params, jnp.asarray(s)))
    got = model.log_prob(torch.from_numpy(s)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * nx * ny)
    samples, lp = model.sample_with_log_prob(B, torch.Generator().manual_seed(4))
    assert samples.shape == (B, nx * ny)
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(jans.log_prob(params, jnp.asarray(samples.numpy()))),
        atol=1e-5 * nx * ny)


def test_is_a_prnn1d_over_the_flat_lattice():
    model = PRNNSnake2D(4, 3, (8,), device="cpu")
    assert isinstance(model, PRNN1D)
    assert model.lattice == (4, 3) == JPRNNSnake2D(4, 3, units=(8,)).lattice
    assert model.num_sites == 12 and model.units == (8,) and not model.parity
    assert model.plain_positive and model.impl == "auto"
    assert PRNNSnake2D(2, 2, impl="plain", device="cpu").impl == "plain"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        PRNNSnake2D(2, 2, cell="lstm", device="cpu")


def test_params_round_trip_bit_exact():
    """The snake model keeps the pRNN pytree: interop needs nothing new."""
    params = JPRNNSnake2D(3, 2, units=(U,)).init(jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, params)
    model = PRNNSnake2D(3, 2, (U,), device="cpu")
    interop.load_params(model, tree)
    got, got_def = jax.tree.flatten(interop.params_to_numpy(model))
    want, want_def = jax.tree.flatten(tree)
    assert got_def == want_def
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_local_energies_match_jax_and_dense_h(monkeypatch):
    """The generic estimator (on the CPU) and the "plain_flip" path (faked
    onto the kernels: K4's plain version) against the JAX package's
    estimator on the flat TFIM2D and against dense H."""
    nx, ny, bx = 3, 2, 3.0
    n = nx * ny
    jans, params, model = _pair(nx, ny, seed=6)
    s = _samples(B, n, seed=7)
    js, ts = jnp.asarray(s), torch.from_numpy(s)
    jham = JTFIM2D(nx=nx, ny=ny, bx=bx, encoding="flat")
    want = np.asarray(jle.make_local_energy_fn(jans, jham)(params, js,
                                                          jans.log_amp(params, js))[0])
    ham = TFIM2D(nx, ny, bx=bx, encoding="flat")
    generic = le.make_local_energy_fn(model, ham)
    assert generic.needs_log_amp
    got = generic(ts, model.log_amp(ts).detach())[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(model, "_use_kernels", lambda: True)
    fused = le.make_local_energy_fn(model, ham)
    assert not fused.needs_log_amp
    got_k, _, la = fused(ts)
    np.testing.assert_allclose(got_k.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(la.numpy(), np.asarray(jans.log_amp(params, js)), atol=1e-5 * n)
    # dense H: E_loc(s) = sum_s' H[s', s] psi(s') / psi(s), basis bit i = flat site i
    h = exact.tfim2d_dense(nx, ny, bx)
    codes = np.arange(1 << n)
    basis = ((codes[:, None] >> np.arange(n)) & 1).astype(np.int32)
    la_all = model.log_amp(torch.from_numpy(basis)).detach().numpy()
    dense = []
    for row in s:
        code = int(row @ (2 ** np.arange(n)))
        col = h[:, code]
        nz = np.nonzero(col)[0]
        dense.append(np.sum(col[nz] * np.exp(la_all[nz] - la_all[code])))
    np.testing.assert_allclose(got_k.numpy(), np.asarray(dense), rtol=2e-4)


def test_dispatch_by_encoding(monkeypatch):
    """Flat TFIM2D: "plain_flip" on the kernels (K3 and K4 on the snake
    chain), None on the CPU; the grid encoding (the MDRNN's) never reaches
    the chain kernels."""
    nx, ny = 3, 3
    _, _, model = _pair(nx, ny, seed=8)
    flat, grid = TFIM2D(nx, ny, bx=3.0), TFIM2D(nx, ny, bx=3.0, encoding="grid")
    assert le._select_family(model, flat) is None
    monkeypatch.setattr(model, "_use_kernels", lambda: True)
    assert le._select_family(model, flat) == "plain_flip"
    assert le._select_family(model, grid) is None
    assert le._select_family(model, TFIM2D(nx, ny, bx=0.0)) is None
    fused = le.make_fused_sample_energy_fn(model, flat)
    samples, la, e, e_im = fused(B, 5, 6)
    assert e_im is None and samples.shape == (B, nx * ny)
    s3, lp3, ratio = tk.tfim_sample_and_flip_sum(tuple(w.detach() for w in model.weights()),
                                                 B, nx * ny, 5, 6)
    assert torch.equal(samples, s3)
    torch.testing.assert_close(e, flat.diagonal(s3) - 3.0 * ratio, atol=0, rtol=0)
    torch.testing.assert_close(la, 0.5 * lp3, atol=0, rtol=0)


def test_short_cpu_run_approaches_ed():
    nx, ny = 2, 2
    e_exact = exact.ground_state_energy(exact.tfim2d_dense(nx, ny, 1.0))
    trainer = VMCTrainer(PRNNSnake2D(nx, ny, (12,), device="cpu"), TFIM2D(nx, ny, 1.0),
                         TrainConfig(num_samples=200, learning_rate=1e-2))
    state = trainer.init()
    state, ms = trainer.run_steps(state, 120)
    e_vmc = float(ms["mean_energy"][-20:].mean())
    assert abs(e_vmc - e_exact) / abs(e_exact) < 2e-2
