"""PyTorch port: the cRNN kernels at the J1-J2 benchmark cell's size, a
1000-site open chain with J2 = 0.2 and the Marshall sign, S = 64, U = 50,
against their plain versions on the card: B11 against its plain twin on
the chains it drew (every exchanged configuration evaluated in full by the
plain loop; the kernel's Philox uniforms have no plain counterpart, so the
twin takes B11's chains), and B9 against plain autograd.  At 1000 sites the
bond lists hold up to 2N - 3 terms a sample, the suffixes run up to 999
sites and the sums of log psi reach hundreds, where float32 keeps ~3e-5.
B11's suffix pass runs the turned-around kernel (64 packed trajectories a
tile) at U = 50 and the first design (32 trajectories of one start site a
tile) past pad8(U) = 56; both are held here, and the turned-around one
also at the published N = 100, S = 500.  They skip without a CUDA device
(a CUDA kernel has no CPU mode).  This file imports no JAX, so on a
machine with a card and without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_j1j2_n1000.py
"""

import pytest
import torch

from rnnwavefunctions_tpu_torch import CRNNU1, J1J2
from rnnwavefunctions_tpu_torch.ops import fused_crnn_bwd
from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk

pytestmark = pytest.mark.cuda

N, S, U = 1000, 64, 50
SEED, OFFSET = 2**31 + 11, 77


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _weights(device, n=N, u=U):
    """The cell's initial weights: Glorot matrices, zero biases."""
    model = CRNNU1(n, (u,), device="cpu").init(torch.Generator().manual_seed(5))
    return tuple(w.detach().to(device) for w in model.weights())


def _b11_against_its_twin(cuda, n, s, u):
    w = _weights(cuda, n, u)
    info = J1J2(n, j2=0.2, marshall_sign=True).exchange_kernel_info
    samples, *got = jk.j1j2_sample_and_exchange(w, s, n, SEED, OFFSET, u1=True, **info)
    assert bool((samples.sum(dim=1) == n // 2).all())
    again = jk.j1j2_exchange_offdiag(w, samples, u1=True, **info)
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    want = jk.exchange_offdiag_plain(w, samples, u1=True, **info)
    scale = float(torch.complex(*want[:2]).abs().max())
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0)


@pytest.mark.parametrize("u", [U, 64], ids=["turned_around", "first_design"])
def test_b11_matches_its_plain_twin_at_1000_sites(cuda, u):
    """B11's chains lie in the U(1) sector, and B10 on them gives B11's
    numbers.  Against the plain twin: the exchange sums (Re, Im) within
    1e-4 of the largest |sum| (every ratio of a sample is exp of a float32
    difference from the sample's own log psi, whose rounding, one ulp of
    ~3e-5 at |log psi| ~350, moves all of that sample's ~1000 terms alike:
    up to ~3e-5 of its sum, in the kernel and in the twin), and (Re, Im) log
    psi within 2e-4 (Kahan sums of 1000 float32 terms, each rounded to
    ~1e-7 of up to |log 2| and pi, in another order: a few ulps at ~350).
    U = 64 runs the first design of the suffix pass."""
    _b11_against_its_twin(cuda, N, S, u)


def test_b11_matches_its_plain_twin_at_100_sites_500_samples(cuda):
    """As above at the published N = 100, S = 500 (~50,000 terms, ~780
    packed tiles of 64 over 99 start sites)."""
    _b11_against_its_twin(cuda, 100, 500, U)


def test_b9_matches_plain_autograd_at_1000_sites(cuda):
    """B9's weight cotangents of (Re, Im) log psi at 1000 sites, seeded by
    random cotangents, within 1e-4 of the largest |entry| of plain autograd's
    (float32 recurrences over 1000 sites, summed in another order)."""
    w = _weights(cuda)
    gen = torch.Generator().manual_seed(3)
    samples = (torch.rand(S, N, generator=gen).argsort(dim=1) < N // 2).to(torch.int32)
    g_re, g_im = torch.randn(2, S, generator=gen).to(cuda)
    samples = samples.to(cuda)
    got = fused_crnn_bwd.crnn_log_amp_bwd(w, samples, g_re, g_im, True)
    want = fused_crnn_bwd.log_amp_bwd_plain(w, samples, g_re, g_im, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)
