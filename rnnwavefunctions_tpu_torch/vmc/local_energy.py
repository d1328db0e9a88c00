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

from typing import Any, Callable, Optional

import torch


def _chunked_apply(fn: Callable, flat: torch.Tensor, chunk_size: Optional[int]):
    """Apply ``fn`` over the leading axis of ``flat`` in chunks of at most
    ``chunk_size`` rows (the whole batch at once when None)."""
    if chunk_size is None or chunk_size >= flat.shape[0]:
        return fn(flat)
    return torch.cat([fn(c) for c in torch.split(flat, chunk_size)])


def _flip_kernel_ok(ansatz, hamiltonian) -> bool:
    """Gate for the single-flip kernels (pRNN family on a flat TFIM).  The
    ansatz's kernel coverage covers the flip kernels' shapes too, and its
    ``_use_kernels`` raises for an uncovered configuration on the card."""
    flip_element = getattr(hamiltonian, "uniform_flip_element", None)
    return (
        flip_element is not None
        and flip_element != 0.0
        and getattr(hamiltonian, "encoding", "flat") == "flat"
        and hasattr(ansatz, "_use_kernels")
        and ansatz._use_kernels()
    )


def _select_family(ansatz: Any, hamiltonian: Any) -> Optional[str]:
    """``"plain_flip"`` (positive pRNN + flat TFIM on the kernels) or None
    (the generic connected-configs estimator)."""
    if (
        getattr(ansatz, "plain_positive", False)
        and not getattr(ansatz, "is_complex", False)
        and _flip_kernel_ok(ansatz, hamiltonian)
    ):
        return "plain_flip"
    return None


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

    # ---- generic connected-configs path
    @torch.no_grad()
    def local_energy(samples, log_amp_samples):
        diag, flips, elements, mask = hamiltonian.connected(samples)
        s, k = flips.shape[0], flips.shape[1]
        flat = flips.reshape((s * k,) + flips.shape[2:])
        la = _chunked_apply(ansatz.log_amp, flat, chunk_size).reshape(s, k)
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
    from ..ops import tfim_flip_kernel as tk

    n = ansatz.num_sites
    flip_element = hamiltonian.uniform_flip_element

    @torch.no_grad()
    def fused_plain(num_samples, seed, offset):
        samples, lp, ratio = tk.tfim_sample_and_flip_sum(
            ansatz.weights(), num_samples, n, seed, offset
        )
        diag = hamiltonian.diagonal(samples)
        return samples, 0.5 * lp, diag + flip_element * ratio, None

    return fused_plain
