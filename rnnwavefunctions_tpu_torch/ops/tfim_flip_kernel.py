"""K3, K4 and B6: the TFIM single-flip log-probabilities by prefix sharing.

Counterpart of ``rnnwavefunctions_tpu/ops/tfim_flip_kernel.py``
(``tfim_flip_ratio_sum``, ``tfim_flip_log_probs`` and
``tfim_sample_and_flip_sum``).  Per sample, K3/K4 return

    ratio[b] = sum_f exp(0.5 * (log p(sigma_b with site f flipped) - log p(sigma_b)))

and the base log p; B6 returns the per-flip log p ``lpf[b, f] = log
p(sigma_b with site f flipped)`` in place of the sum (the parity-symmetrized
estimator combines two directions before the ratio).  Flipping site f leaves
sites < f untouched, so ``log p(sigma^(f)) = pfx[f-1] + fl[f] + suffix_f``:
only the suffix after f is recomputed, from the stored hidden state h_f with
the flipped input.

The CUDA kernels are ``csrc/tfim_flip.cu`` (one source, sample mode on or
off, ratio sum or per-flip output).  The plain versions below run the same
base pass and recompute the suffixes explicitly, all flips of a sample side
by side.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .compsum import kadd, kfinal
from .fused_gru import base_pass_plain, logp2, site_step
from .launch import (
    GRU_FAMILY,
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

def flip_log_probs_plain(weights: Weights, spins, hist, pfx, fl) -> torch.Tensor:
    """(B, N) log p of every single-flip configuration, by explicit suffix
    recomputation from the base pass: at site i the flips f < i advance."""
    b, n, u = hist.shape
    h = hist.clone()
    x = 1.0 - spins
    acc = torch.cat([torch.zeros_like(pfx[:, :1]), pfx[:, :-1]], dim=1) + fl
    cmp = torch.zeros_like(acc)
    for i in range(1, n):
        tgt = spins[:, i : i + 1].expand(b, i).reshape(-1)
        h_new, l0, l1 = site_step(
            weights, h[:, :i].reshape(-1, u), x[:, :i].reshape(-1), 1.0
        )
        a, c = kadd(acc[:, :i].reshape(-1), cmp[:, :i].reshape(-1),
                    logp2(l0, l1, tgt))
        h[:, :i] = h_new.view(b, i, u)
        acc[:, :i] = a.view(b, i)
        cmp[:, :i] = c.view(b, i)
        x[:, :i] = tgt.view(b, i)
    return kfinal(acc, cmp)


def ratio_sum(lpf: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """Sum of exp(0.5 (lpf - lp)) over flips, in flip order."""
    terms = torch.exp(0.5 * (lpf - lp[:, None]))
    out = torch.zeros_like(lp)
    for f in range(terms.shape[1]):
        out = out + terms[:, f]
    return out


@torch.no_grad()
def flip_ratio_sum_plain(weights: Weights, samples: torch.Tensor):
    spins, lp, hist, pfx, fl = base_pass_plain(weights, samples=samples)
    return ratio_sum(flip_log_probs_plain(weights, spins, hist, pfx, fl), lp), lp


@torch.no_grad()
def sample_and_flip_sum_plain(weights: Weights, uniforms: torch.Tensor):
    spins, lp, hist, pfx, fl = base_pass_plain(weights, uniforms=uniforms)
    ratio = ratio_sum(flip_log_probs_plain(weights, spins, hist, pfx, fl), lp)
    return spins.to(torch.int32), lp, ratio


@torch.no_grad()
def per_flip_log_probs_plain(weights: Weights, samples: torch.Tensor):
    """(lpf (B, N), base log p (B,)) of given samples."""
    spins, lp, hist, pfx, fl = base_pass_plain(weights, samples=samples)
    return flip_log_probs_plain(weights, spins, hist, pfx, fl), lp


@torch.no_grad()
def sample_and_per_flip_plain(weights: Weights, uniforms: torch.Tensor):
    """(samples (B, N) int32, base log p (B,), lpf (B, N)) drawn from given
    uniforms."""
    spins, lp, hist, pfx, fl = base_pass_plain(weights, uniforms=uniforms)
    return spins.to(torch.int32), lp, flip_log_probs_plain(weights, spins, hist, pfx, fl)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _scratch(b: int, n: int, u: int, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return (
        torch.empty(b * n * u, **f32),  # hidden history
        torch.empty(b * n, **f32),      # pfx
        torch.empty(b * n, **f32),      # fl
        torch.empty(b, n, **f32),       # per-flip ratio terms, or lpf
        torch.empty(b, **f32),          # base log p
    )


@counts_launches()
def tfim_flip_ratio_sum(weights: Weights, samples: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (B, N) int32 samples -> (ratio_sum (B,), base log p (B,))."""
    if is_cpu_call(samples, *weights):
        return flip_ratio_sum_plain(weights, samples)
    b, n, u = check_chains(weights, samples)
    hist, pfx, fl, terms, lp = _scratch(b, n, u, samples.device)
    ratio = torch.empty_like(lp)
    launch("rnnwf_tfim_flip_ratio_sum", samples.device, samples, *weights, hist, pfx, fl,
           terms, lp, ratio, b, n, u)
    return ratio, lp


@counts_launches()
def tfim_flip_log_probs(weights: Weights, samples: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6, teacher-forced: (B, N) int32 samples -> (lpf (B, N), base log p
    (B,)), ``lpf[b, f]`` the log p of sample b with site f flipped."""
    if is_cpu_call(samples, *weights):
        return per_flip_log_probs_plain(weights, samples)
    b, n, u = check_chains(weights, samples)
    hist, pfx, fl, lpf, lp = _scratch(b, n, u, samples.device)
    launch("rnnwf_tfim_flip_log_probs", samples.device, samples, *weights, hist, pfx, fl, lpf,
           lp, b, n, u)
    return lpf, lp


@counts_launches()
def tfim_sample_and_flip_log_probs(weights: Weights, num_samples: int, n_sites: int,
                                   seed: int, offset: int):
    """B6 in sample mode: K3's draws for ``(seed, offset)`` with their
    per-flip log p.  Returns (samples (B, N) int32, base log p (B,), lpf
    (B, N)).  ``tfim_sample_and_flip_sum(..., per_flip=True)`` calls it."""
    draw = begin_draw(weights, num_samples, (n_sites,), seed, offset, GRU_FAMILY)
    if draw.uniforms is not None:
        return sample_and_per_flip_plain(weights, draw.uniforms)
    dev = draw.samples.device
    hist, pfx, fl, lpf, lp = _scratch(num_samples, n_sites, draw.u, dev)
    launch("rnnwf_tfim_sample_and_flip_log_probs", dev, seed, offset, *weights, draw.samples,
           hist, pfx, fl, lpf, lp, num_samples, n_sites, draw.u)
    return draw.samples, lp, lpf


@counts_launches()
def tfim_sample_and_flip_sum(weights: Weights, num_samples: int, n_sites: int,
                             seed: int, offset: int, per_flip: bool = False):
    """K3: draw ``num_samples`` chains of ``n_sites`` spins and estimate their
    flip-ratio sums in one pass.  ``(seed, offset)`` (each in [0, 2^32))
    keys the kernel's Philox generator.  Returns (samples (B, N) int32,
    base log p (B,), ratio_sum (B,)); with ``per_flip`` (B6 in sample mode,
    ``tfim_sample_and_flip_log_probs``, which counts the launch) the
    per-flip log p (B, N) in place of the ratio sum."""
    if per_flip:
        return tfim_sample_and_flip_log_probs(weights, num_samples, n_sites, seed, offset)
    draw = begin_draw(weights, num_samples, (n_sites,), seed, offset, GRU_FAMILY)
    if draw.uniforms is not None:
        return sample_and_flip_sum_plain(weights, draw.uniforms)
    dev = draw.samples.device
    hist, pfx, fl, terms, lp = _scratch(num_samples, n_sites, draw.u, dev)
    ratio = torch.empty_like(lp)
    launch("rnnwf_tfim_sample_and_flip_sum", dev, seed, offset, *weights, draw.samples, hist,
           pfx, fl, terms, lp, ratio, num_samples, n_sites, draw.u)
    return draw.samples, lp, ratio
