"""PyTorch port: the minSR CG solve B21 (``ops/sr_cg.py``), its plain
version held on the CPU against the JAX package's ``cg_solve_jnp`` and its
Pallas kernel in interpret mode.  The kernel itself is checked on the card
by tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: 1e-5 relative to the solution's norm plus 1e-6 absolute per
entry: the same CG steps in f32, whose matrix-vector products and dot
products are summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu.ops import sr_cg as jsr_cg
from rnnwavefunctions_tpu_torch.ops import sr_cg

torch.set_num_threads(1)


def _spd(s, seed, cond_boost=0.0):
    """An SR-Gram-like SPD system from a numpy seed: A A^T / (2S) + 1e-2 I,
    optionally with one dominant direction, and a right-hand side."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((s, 2 * s))
    t = a @ a.T / (2 * s) + 1e-2 * np.eye(s)
    if cond_boost:
        v = rng.standard_normal((s, 1))
        v /= np.linalg.norm(v)
        t += cond_boost * (v @ v.T)
    return t.astype(np.float32), rng.standard_normal(s).astype(np.float32)


def _assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.linalg.norm(want) + 1e-6)


@pytest.mark.parametrize("s", [24, 128, 200])
def test_plain_cg_matches_jax(s):
    t, c = _spd(s, 3, cond_boost=10.0)
    got = sr_cg.sr_cg_solve(torch.from_numpy(t), torch.from_numpy(c), 48).numpy()
    _assert_close(got, jsr_cg.cg_solve_jnp(jnp.asarray(t), jnp.asarray(c), iters=48))
    _assert_close(got, jsr_cg.sr_cg_solve(jnp.asarray(t), jnp.asarray(c), iters=48,
                                          interpret=True))


@pytest.mark.parametrize("s", [24, 128])
def test_plain_cg_reaches_the_exact_solution(s):
    t, c = _spd(s, 0, cond_boost=30.0)
    got = sr_cg.cg_solve_plain(torch.from_numpy(t), torch.from_numpy(c), 2 * s).numpy()
    want = np.linalg.solve(t.astype(np.float64), c.astype(np.float64))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3


def test_exact_convergence_guard():
    """2 I x = 1 converges in one step; the 1e-30 guards then freeze the
    iterate instead of dividing 0 by 0, as in the JAX kernel."""
    t, c = 2.0 * np.eye(8, dtype=np.float32), np.ones(8, dtype=np.float32)
    got = sr_cg.sr_cg_solve(torch.from_numpy(t), torch.from_numpy(c), 64).numpy()
    want = np.asarray(jsr_cg.sr_cg_solve(jnp.asarray(t), jnp.asarray(c), iters=64,
                                         interpret=True))
    np.testing.assert_array_equal(got, np.full(8, 0.5, np.float32))
    np.testing.assert_array_equal(got, want)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    t, c = _spd(16, 5)
    before = sr_cg.sr_cg_solve.launches
    got = sr_cg.sr_cg_solve(torch.from_numpy(t), torch.from_numpy(c), 20)
    assert sr_cg.sr_cg_solve.launches == before
    assert torch.equal(got, sr_cg.cg_solve_plain(torch.from_numpy(t), torch.from_numpy(c), 20))
    with pytest.raises(ValueError, match="iters"):
        sr_cg.sr_cg_solve(torch.from_numpy(t), torch.from_numpy(c), 0)
