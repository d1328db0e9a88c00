"""B10 and B11: the J1-J2 off-diagonal local energy of the U(1) cRNN by
prefix sharing.

Counterpart of ``rnnwavefunctions_tpu/ops/j1j2_exchange_kernel.py``
(``j1j2_exchange_offdiag`` and ``j1j2_sample_and_exchange``).  Per sample it
returns

    eoff[b] = sum_k el_k exp(dRe_k) (cos dIm_k, sin dIm_k),
    dRe_k + i dIm_k = log psi(sigma_b with bond k exchanged) - log psi(sigma_b),

over the anti-aligned NN bonds (element ``el_nn``), the anti-aligned NNN
bonds (``el_nnn``, when ``has_nnn``) and, when ``periodic``, the wrap bonds
(0, N-1), (0, N-2) and (1, N-1); an aligned bond contributes exactly 0.
The base (Re, Im) log psi comes back as a by-product.  B11 draws the samples
first, in the same base pass.

The CUDA kernels are ``csrc/j1j2_exchange.cu``.  The plain versions are
independent of the kernels' prefix sharing: they list every exchanged
configuration with ``J1J2.connected`` and evaluate each in full with the
plain B7 loop.
"""

from __future__ import annotations

import torch

from ..hamiltonians.j1j2 import J1J2
from .build import load_library
from .fused_crnn import base_pass_plain, check_crnn_weights, log_amp_parts_plain
from .launch import (
    CRNN_FAMILY,
    Weights,
    begin_draw,
    check_chains,
    counts_launches,
    is_cpu_call,
    launch,
)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

@torch.no_grad()
def exchange_offdiag_plain(weights: Weights, samples: torch.Tensor, *, u1: bool,
                           el_nn: float, el_nnn: float, has_nnn: bool, periodic: bool):
    """Brute force: every connected configuration of the chain whose
    exchange elements are (el_nn, el_nnn) through the full plain loop.
    Returns (eoff_re, eoff_im, lp_re, lp_im)."""
    b, n = samples.shape
    ham = J1J2(n, j1=2.0 * el_nn, j2=2.0 * el_nnn if has_nnn else 0.0, periodic=periodic)
    _, flips, elements, mask = ham.connected(samples)
    k = flips.shape[1]
    lp_re, lp_im = log_amp_parts_plain(weights, samples, u1)
    la_re, la_im = log_amp_parts_plain(weights, flips.reshape(b * k, n), u1)
    d_re = la_re.view(b, k) - lp_re[:, None]
    d_im = la_im.view(b, k) - lp_im[:, None]
    w = torch.where(mask, elements * torch.exp(d_re), 0.0)
    return (w * torch.cos(d_im)).sum(dim=1), (w * torch.sin(d_im)).sum(dim=1), lp_re, lp_im


@torch.no_grad()
def sample_and_exchange_plain(weights: Weights, uniforms: torch.Tensor, *, u1: bool,
                              **elements):
    """The plain sampler on given (B, N) uniforms, then the plain B10 on its
    samples: (samples, eoff_re, eoff_im, lp_re, lp_im)."""
    spins, _, _ = base_pass_plain(weights, u1, uniforms=uniforms)
    samples = spins.to(torch.int32)
    return (samples, *exchange_offdiag_plain(weights, samples, u1=u1, **elements))


# ---------------------------------------------------------------------------
# the suffix pass's packing (launch 3 where pad8(U) <= 56)
# ---------------------------------------------------------------------------

SUFFIX_ROWS = 64  # trajectories per tile of exchange_suffix_rs_kernel (wgmma's M)


def list_lengths(samples: torch.Tensor, *, el_nn: float, el_nnn: float, has_nnn: bool,
                 periodic: bool = False) -> torch.Tensor:
    """The length of each start site's bond list, as the list launch forms
    it: per start site a, the (bond, sample) terms of the bonds (a, b) with
    a nonzero element whose spins differ.  (N,) int64."""
    s = samples.to(torch.int64)
    n = s.shape[1]
    counts = torch.zeros(n, dtype=torch.int64, device=s.device)
    bonds = []
    if el_nn != 0.0:
        bonds.append((torch.arange(n - 1), torch.arange(1, n)))
    if has_nnn and el_nnn != 0.0:
        bonds.append((torch.arange(n - 2), torch.arange(2, n)))
    if periodic:
        wraps = [(0, n - 1, el_nn)] + ([(0, n - 2, el_nnn), (1, n - 1, el_nnn)] if has_nnn else [])
        bonds += [(torch.tensor([a]), torch.tensor([b])) for a, b, el in wraps if el != 0.0]
    for a, b in bonds:
        live = (s[:, a] != s[:, b]).sum(dim=0)
        counts.index_add_(0, a.to(s.device), live)
    return counts


def suffix_occupancy(counts) -> float:
    """Live trajectory-sites over issued row-sites of the packed suffix pass
    for the start sites' list lengths ``counts`` (N,): tiles are runs of
    SUFFIX_ROWS consecutive terms of all lists in start-site order, a term
    of start site a lives on the N - 1 - a sites after it, and every row of
    a tile is issued from its first start site on.  1.0 when nothing is
    listed."""
    counts = torch.as_tensor(counts, dtype=torch.int64).cpu()
    n = counts.numel()
    starts = torch.repeat_interleave(torch.arange(n), counts)
    if starts.numel() == 0:
        return 1.0
    live = int((n - 1 - starts).sum())
    issued = SUFFIX_ROWS * int((n - 1 - starts[::SUFFIX_ROWS]).sum())
    return live / issued


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch(name: str, weights: Weights, samples: torch.Tensor, seed: int, offset: int,
            u1: bool, el_nn: float, el_nnn: float, has_nnn: bool, periodic: bool):
    """Allocates the scratch and runs the four launches of B10 (``samples``
    read) or B11 (``samples`` written): the base pass, the bond lists, the
    suffix pass on the tensor cores and the per-sample sum."""
    b, n = samples.shape
    u = weights[1].shape[0]
    dev = samples.device
    k = load_library().lib.rnnwf_j1j2_num_bonds(n, int(has_nnn), int(periodic))
    f32 = dict(dtype=torch.float32, device=dev)
    hist = torch.empty(b * n * u, **f32)
    pfx = torch.empty(5, b * n, **f32)     # Re and Im prefixes, up-counts, flipped site terms
    terms = torch.empty(2, k * b, **f32)   # Re and Im term of each (bond, sample)
    # the start sites' lists of exchanged terms, then their offsets, lengths
    # and packed offsets, and the list launch's counter of finished blocks
    order = torch.empty(k * b + 3 * n + 2, dtype=torch.int32, device=dev)
    out = torch.empty(4, b, **f32)         # eoff_re, eoff_im, lp_re, lp_im
    launch(name, dev, samples, seed, offset, *weights, hist, pfx, terms, order, out, b, n, u,
           int(u1), float(el_nn), float(el_nnn), int(has_nnn), int(periodic))
    return tuple(out)


@counts_launches()
def j1j2_exchange_offdiag(weights: Weights, samples: torch.Tensor, *, u1: bool,
                          el_nn: float, el_nnn: float, has_nnn: bool,
                          periodic: bool = False):
    """B10: (B, N) int32 samples -> (eoff_re, eoff_im, lp_re, lp_im), each
    (B,) float32."""
    elements = dict(el_nn=el_nn, el_nnn=el_nnn, has_nnn=has_nnn, periodic=periodic)
    if is_cpu_call(samples, *weights):
        return exchange_offdiag_plain(weights, samples, u1=u1, **elements)
    check_chains(weights, samples, CRNN_FAMILY, heads=2)
    return _launch("rnnwf_j1j2_exchange_offdiag", weights, samples, 0, 0, u1, **elements)


@counts_launches()
def j1j2_sample_and_exchange(weights: Weights, num_samples: int, n_sites: int,
                             seed: int, offset: int, *, u1: bool, el_nn: float,
                             el_nnn: float, has_nnn: bool, periodic: bool = False):
    """B11: draw ``num_samples`` U(1)-masked chains of ``n_sites`` spins
    and estimate their exchange sums in one pass.  ``(seed, offset)`` (each
    in [0, 2^32)) keys the kernel's Philox generator.  Returns (samples
    (B, N) int32, eoff_re, eoff_im, lp_re, lp_im)."""
    elements = dict(el_nn=el_nn, el_nnn=el_nnn, has_nnn=has_nnn, periodic=periodic)
    draw = begin_draw(weights, num_samples, (n_sites,), seed, offset, CRNN_FAMILY,
                      check_crnn_weights)
    if draw.uniforms is not None:
        return sample_and_exchange_plain(weights, draw.uniforms, u1=u1, **elements)
    out = _launch("rnnwf_j1j2_sample_and_exchange", weights, draw.samples, seed, offset, u1,
                  **elements)
    return (draw.samples, *out)
