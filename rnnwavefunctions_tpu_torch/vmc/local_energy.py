"""Local-energy estimation — the single estimator dispatch module.

Counterpart of ``rnnwavefunctions_tpu/vmc/local_energy.py``.  ONE predicate,
``_select_family``, decides the kernel family for both consumers:

* ``make_local_energy_fn``        — estimator on given samples;
* ``make_fused_sample_energy_fn`` — the trainer's sample-AND-estimate step,

so the trainer and the standalone estimator cannot disagree about which path
a configuration takes.  The choice is made when the function is built, from
the ansatz's device and coverage: build it after the ansatz is on its device.

Local energies are data for the surrogate loss: everything here runs without
autograd.  They come back as ``(e_re, e_im, log_amp)`` with ``e_im`` None
for real ansatze.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from ..models.mdrnn2d import MDRNN2D


def _chunks(flat: torch.Tensor, chunk_size: Optional[int]):
    """``flat`` split along its leading axis into chunks of at most
    ``chunk_size`` rows (the whole batch at once when None)."""
    if chunk_size is None or chunk_size >= flat.shape[0]:
        return [flat]
    return torch.split(flat, chunk_size)


def _flip_kernel_ok(ansatz, hamiltonian, encoding: str) -> bool:
    """Gate for the single-flip kernels (pRNN family on a flat TFIM, MDRNN
    on a grid TFIM).  The ansatz's kernel coverage covers the flip kernels'
    shapes too, and its ``_use_kernels`` raises for an uncovered
    configuration on the card."""
    flip_element = getattr(hamiltonian, "uniform_flip_element", None)
    return (
        flip_element is not None
        and flip_element != 0.0
        and getattr(hamiltonian, "encoding", "flat") == encoding
        and hasattr(ansatz, "_use_kernels")
        and ansatz._use_kernels()
    )


def _select_family(ansatz: Any, hamiltonian: Any) -> Optional[str]:
    """``"plain_flip"`` (positive pRNN + flat TFIM on the kernels),
    ``"parity_flip"`` (parity-symmetrized pRNN + flat TFIM on the kernels),
    ``"mdrnn_flip"`` (2D MDRNN + grid TFIM on the kernels), ``"exchange"``
    (complex cRNN + J1-J2 spin exchange on the kernels) or None (the
    generic connected-configs estimator).  A parity pRNN is not
    ``plain_positive``, so it never reaches ``"plain_flip"``.  The ansatz's
    ``_use_kernels`` raises for an uncovered configuration on the card."""
    is_complex = getattr(ansatz, "is_complex", False)
    positive = getattr(ansatz, "plain_positive", False) and not is_complex
    is_mdrnn = isinstance(ansatz, MDRNN2D)
    if positive and not is_mdrnn and _flip_kernel_ok(ansatz, hamiltonian, "flat"):
        return "plain_flip"
    if getattr(ansatz, "parity", False) and _flip_kernel_ok(ansatz, hamiltonian, "flat"):
        return "parity_flip"
    if positive and is_mdrnn and _flip_kernel_ok(ansatz, hamiltonian, "grid"):
        return "mdrnn_flip"
    if (
        is_complex
        and getattr(hamiltonian, "exchange_kernel_info", None) is not None
        and hasattr(ansatz, "_use_kernels")
        and ansatz._use_kernels()
    ):
        return "exchange"
    return None


def _parity_energy(hamiltonian, samples, lpf1, lp1, lpf2_rev, lp2):
    """The parity-symmetrized contraction: the forward and reversed per-flip
    log p are combined BEFORE the ratio (the symmetrized density's ratios do
    not decompose per direction).  A flip of site i in the chain is a flip
    of site N-1-i in its reversal.  Returns (e_re, None, symmetrized base
    log psi)."""
    num = torch.logaddexp(lpf1, lpf2_rev.flip(1))  # (B, N), + log 2
    den = torch.logaddexp(lp1, lp2)                 # the same log 2 cancels
    ratio_sum = torch.exp(0.5 * (num - den[:, None])).sum(dim=1)
    e = hamiltonian.diagonal(samples) + hamiltonian.uniform_flip_element * ratio_sum
    return e, None, 0.5 * (den - math.log(2.0))


def make_local_energy_fn(ansatz: Any, hamiltonian: Any,
                         chunk_size: Optional[int] = None) -> Callable:
    """Returns ``local_energy(samples, log_amp_samples=None) -> (e_re, e_im,
    log_amp)``.  The function's ``needs_log_amp`` attribute says whether it
    needs log psi of the samples (the generic path) or computes the base
    pass itself and returns it as the third output (the kernel path)."""
    family = _select_family(ansatz, hamiltonian)

    if family == "plain_flip":
        from ..ops.tfim_flip_kernel import tfim_flip_ratio_sum

        flip_element = hamiltonian.uniform_flip_element

        @torch.no_grad()
        def local_energy_fused(samples, log_amp_samples=None):
            diag = hamiltonian.diagonal(samples)
            ratio_sum, lp = tfim_flip_ratio_sum(ansatz.weights(), samples)
            return diag + flip_element * ratio_sum, None, 0.5 * lp

        local_energy_fused.needs_log_amp = False
        return local_energy_fused

    if family == "parity_flip":
        from ..ops.tfim_flip_kernel import tfim_flip_log_probs

        @torch.no_grad()
        def local_energy_parity(samples, log_amp_samples=None):
            w = ansatz.weights()
            lpf1, lp1 = tfim_flip_log_probs(w, samples)
            lpf2_rev, lp2 = tfim_flip_log_probs(w, samples.flip(1).contiguous())
            return _parity_energy(hamiltonian, samples, lpf1, lp1, lpf2_rev, lp2)

        local_energy_parity.needs_log_amp = False
        return local_energy_parity

    if family == "mdrnn_flip":
        from ..ops.mdrnn_flip_kernel import mdrnn_flip_ratio_sum

        flip_element = hamiltonian.uniform_flip_element

        @torch.no_grad()
        def local_energy_mdrnn(samples, log_amp_samples=None):
            diag = hamiltonian.diagonal(samples)
            ratio_sum, lp = mdrnn_flip_ratio_sum(ansatz.weights(), samples)
            return diag + flip_element * ratio_sum, None, 0.5 * lp

        local_energy_mdrnn.needs_log_amp = False
        return local_energy_mdrnn

    if family == "exchange":
        from ..ops.j1j2_exchange_kernel import j1j2_exchange_offdiag

        exch = hamiltonian.exchange_kernel_info

        @torch.no_grad()
        def local_energy_exchange(samples, log_amp_samples=None):
            diag = hamiltonian.diagonal(samples)
            e_re, e_im, lp_re, lp_im = j1j2_exchange_offdiag(
                ansatz.weights(), samples, u1=ansatz.u1, **exch)
            return diag + e_re, e_im, (lp_re, lp_im)

        local_energy_exchange.needs_log_amp = False
        return local_energy_exchange

    # ---- generic connected-configs path; ``log_amp_samples`` is log psi of
    # the samples, an (Re, Im) pair for a complex ansatz
    @torch.no_grad()
    def local_energy(samples, log_amp_samples):
        diag, flips, elements, mask = hamiltonian.connected(samples)
        s, k = flips.shape[0], flips.shape[1]
        flat = flips.reshape((s * k,) + flips.shape[2:])
        if getattr(ansatz, "is_complex", False):
            parts = [ansatz.log_amp_parts(c) for c in _chunks(flat, chunk_size)]
            la_re = torch.cat([p[0] for p in parts]).reshape(s, k)
            la_im = torch.cat([p[1] for p in parts]).reshape(s, k)
            s_re, s_im = log_amp_samples
            d_im = la_im - s_im[:, None]
            w = torch.where(mask, elements * torch.exp(la_re - s_re[:, None]), 0.0)
            off_re = torch.sum(w * torch.cos(d_im), dim=1)
            off_im = torch.sum(w * torch.sin(d_im), dim=1)
            return diag + off_re, off_im, log_amp_samples
        la = torch.cat([ansatz.log_amp(c) for c in _chunks(flat, chunk_size)]).reshape(s, k)
        ratios = torch.exp(la - log_amp_samples[:, None])
        contrib = elements.to(ratios.dtype) * ratios
        offdiag = torch.sum(torch.where(mask, contrib, torch.zeros_like(contrib)), dim=1)
        return diag.to(offdiag.dtype) + offdiag, None, log_amp_samples

    local_energy.needs_log_amp = True
    return local_energy


def make_fused_sample_energy_fn(ansatz: Any, hamiltonian: Any):
    """Single-launch sample + local-energy step for the trainer, selected by
    the SAME ``_select_family`` as ``make_local_energy_fn``.  Returns
    ``fused(num_samples, seed, offset) -> (samples, log_amp, e_re, e_im)``
    or None when no kernel applies."""
    family = _select_family(ansatz, hamiltonian)
    if family is None:
        return None
    if family == "exchange":
        from ..ops.j1j2_exchange_kernel import j1j2_sample_and_exchange

        n, exch = ansatz.num_sites, hamiltonian.exchange_kernel_info

        @torch.no_grad()
        def fused_j1j2(num_samples, seed, offset):
            samples, e_re, e_im, lp_re, lp_im = j1j2_sample_and_exchange(
                ansatz.weights(), num_samples, n, seed, offset, u1=ansatz.u1, **exch)
            return samples, (lp_re, lp_im), hamiltonian.diagonal(samples) + e_re, e_im

        return fused_j1j2

    if family == "parity_flip":
        # B6 in sample mode covers the forward chain, teacher-forced B6 the
        # reversed one; the sampler stays the plain autoregressive one
        from ..ops import tfim_flip_kernel as tk

        n = ansatz.num_sites

        @torch.no_grad()
        def fused_parity(num_samples, seed, offset):
            w = ansatz.weights()
            samples, lp1, lpf1 = tk.tfim_sample_and_flip_sum(
                w, num_samples, n, seed, offset, per_flip=True)
            lpf2_rev, lp2 = tk.tfim_flip_log_probs(w, samples.flip(1).contiguous())
            e_re, e_im, la = _parity_energy(hamiltonian, samples, lpf1, lp1, lpf2_rev, lp2)
            return samples, la, e_re, e_im

        return fused_parity

    flip_element = hamiltonian.uniform_flip_element
    if family == "mdrnn_flip":
        from ..ops.mdrnn_flip_kernel import mdrnn_sample_and_flip_sum

        nx, ny = ansatz.nx, ansatz.ny

        @torch.no_grad()
        def fused_mdrnn(num_samples, seed, offset):
            samples, lp, ratio = mdrnn_sample_and_flip_sum(
                ansatz.weights(), num_samples, nx, ny, seed, offset)
            return samples, 0.5 * lp, hamiltonian.diagonal(samples) + flip_element * ratio, None

        return fused_mdrnn

    from ..ops import tfim_flip_kernel as tk

    n = ansatz.num_sites

    @torch.no_grad()
    def fused_plain(num_samples, seed, offset):
        samples, lp, ratio = tk.tfim_sample_and_flip_sum(
            ansatz.weights(), num_samples, n, seed, offset
        )
        diag = hamiltonian.diagonal(samples)
        return samples, 0.5 * lp, diag + flip_element * ratio, None

    return fused_plain
