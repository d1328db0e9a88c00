"""PyTorch port: the 2D TFIM (both sample encodings, scalar and per-site
couplings) and the 2D ED copy, held against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu.ed import exact as jexact
from rnnwavefunctions_tpu.hamiltonians.tfim2d import TFIM2D as JTFIM2D
from rnnwavefunctions_tpu_torch import TFIM2D
from rnnwavefunctions_tpu_torch.ed import exact

torch.set_num_threads(1)


def _batch(encoding, nx, ny, b=13, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, nx * ny) if encoding == "flat" else (b, nx, ny)
    return rng.integers(0, 2, shape).astype(np.int32)


@pytest.mark.parametrize("encoding", ["flat", "grid"])
@pytest.mark.parametrize("shape", [(3, 2), (2, 4), (3, 3)], ids=["3x2", "2x4", "3x3"])
@pytest.mark.parametrize("per_site", [False, True], ids=["scalar_jz", "per_site_jz"])
def test_diagonal_and_connected_match_jax(encoding, shape, per_site):
    nx, ny = shape
    jz = np.random.default_rng(1).uniform(0.5, 1.5, (nx, ny)) if per_site else 0.8
    ham = TFIM2D(nx, ny, bx=1.3, jz=jz, encoding=encoding)
    jham = JTFIM2D(nx=nx, ny=ny, bx=1.3, jz=jz, encoding=encoding)
    s = _batch(encoding, nx, ny)
    diag, flips, elements, mask = ham.connected(torch.from_numpy(s))
    want = jax.vmap(jham.connected)(jnp.asarray(s))
    np.testing.assert_allclose(diag.numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ham.diagonal(torch.from_numpy(s)).numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(flips.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(elements.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[3]))
    assert ham.n_sites == ham.n_offdiag == nx * ny
    assert ham.uniform_flip_element == -1.3


def test_encodings_agree_on_the_same_lattice():
    nx, ny = 3, 4
    grid = _batch("grid", nx, ny, seed=2)
    flat = np.transpose(grid, (0, 2, 1)).reshape(len(grid), -1)  # y-major
    jz = np.random.default_rng(3).uniform(0.5, 1.5, (nx, ny))
    got = TFIM2D(nx, ny, jz=jz, encoding="grid").diagonal(torch.from_numpy(grid))
    want = TFIM2D(nx, ny, jz=jz, encoding="flat").diagonal(torch.from_numpy(flat))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="encoding"):
        TFIM2D(2, 2, encoding="snake")
    with pytest.raises(ValueError, match="per-bond jz"):
        TFIM2D(2, 3, jz=np.ones((3, 2)))


@pytest.mark.parametrize("shape", [(2, 2), (3, 2)])
def test_dense_copy_matches_jax_and_the_connected_expansion(shape):
    nx, ny = shape
    h = exact.tfim2d_dense(nx, ny, 0.9)
    np.testing.assert_array_equal(h, jexact.tfim2d_dense(nx, ny, 0.9))
    n = nx * ny
    ham = TFIM2D(nx, ny, bx=0.9, encoding="flat")
    codes = np.arange(1 << n)
    basis = ((codes[:, None] >> np.arange(n)) & 1).astype(np.int32)  # bit i = flat site i
    diag, flips, elements, _ = ham.connected(torch.from_numpy(basis))
    np.testing.assert_allclose(diag.numpy(), np.diag(h), rtol=1e-6)
    targets = (flips.numpy() * (2 ** np.arange(n))).sum(-1)
    for c in codes:
        np.testing.assert_allclose(h[targets[c], c], elements[c].numpy(), rtol=1e-6)
    assert exact.E_TFIM2D_4X4_BX3 == pytest.approx(-50.1866238828, abs=1e-10)
