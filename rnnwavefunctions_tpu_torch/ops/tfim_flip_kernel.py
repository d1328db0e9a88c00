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

from typing import Optional, Tuple

import torch

from .build import check, load_library
from .compsum import kadd, kfinal
from .fused_gru import (
    Weights,
    check_samples,
    check_supported,
    check_weights,
    is_cpu_call,
    logp2,
    site_step,
    stream_of,
)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def base_pass_plain(weights: Weights, samples: Optional[torch.Tensor] = None,
                    uniforms: Optional[torch.Tensor] = None):
    """Teacher-forced (``samples`` given) or sampling (``uniforms`` (B, N)
    given: s = 1 iff u >= p0) base pass.  Returns (spins (B, N) float,
    lp (B,), hist (B, N, U), pfx (B, N), fl (B, N))."""
    src = samples if samples is not None else uniforms
    b, n = src.shape
    u = weights[1].shape[0]
    dev = src.device
    h = torch.zeros(b, u, dtype=torch.float32, device=dev)
    x = torch.zeros(b, dtype=torch.float32, device=dev)
    acc = torch.zeros_like(x)
    cmp = torch.zeros_like(x)
    spins, hist, pfx, fl = [], [], [], []
    for i in range(n):
        h, l0, l1 = site_step(weights, h, x, 1.0 if i > 0 else 0.0)
        if samples is not None:
            s = samples[:, i].to(torch.float32)
        else:
            s = (uniforms[:, i] >= torch.sigmoid(l0 - l1)).to(torch.float32)
        acc, cmp = kadd(acc, cmp, logp2(l0, l1, s))
        spins.append(s)
        hist.append(h)
        pfx.append(kfinal(acc, cmp))
        fl.append(logp2(l0, l1, 1.0 - s))
        x = s
    stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    return stack(spins), kfinal(acc, cmp), stack(hist), stack(pfx), stack(fl)


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


def check_key(seed: int, offset: int) -> None:
    """The samplers' Philox key: each word in [0, 2^32)."""
    if not (0 <= seed < 2**32 and 0 <= offset < 2**32):
        raise ValueError(f"seed and offset must lie in [0, 2^32); got {seed}, {offset}")


def plain_uniforms(num_samples: int, n_sites: int, seed: int, offset: int,
                   device) -> torch.Tensor:
    """The plain sampler's (B, N) uniforms, drawn from a CPU generator seeded
    by the (seed, offset) pair the kernel would get."""
    gen = torch.Generator().manual_seed((seed << 32) | offset)
    return torch.rand(num_samples, n_sites, generator=gen).to(device)


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


def tfim_flip_ratio_sum(weights: Weights, samples: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (B, N) int32 samples -> (ratio_sum (B,), base log p (B,))."""
    if is_cpu_call(samples, *weights):
        return flip_ratio_sum_plain(weights, samples)
    u = check_weights(weights)
    b, n = check_samples(samples)
    check_supported(n, u, samples.device)
    hist, pfx, fl, terms, lp = _scratch(b, n, u, samples.device)
    ratio = torch.empty_like(lp)
    lib = load_library().lib
    with torch.cuda.device(samples.device):
        err = lib.rnnwf_tfim_flip_ratio_sum(
            samples.data_ptr(), *[w.data_ptr() for w in weights],
            hist.data_ptr(), pfx.data_ptr(), fl.data_ptr(), terms.data_ptr(),
            lp.data_ptr(), ratio.data_ptr(), b, n, u, stream_of(samples),
        )
    check(err, "rnnwf_tfim_flip_ratio_sum")
    tfim_flip_ratio_sum.launches += 1
    return ratio, lp


tfim_flip_ratio_sum.launches = 0


def tfim_flip_log_probs(weights: Weights, samples: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6, teacher-forced: (B, N) int32 samples -> (lpf (B, N), base log p
    (B,)), ``lpf[b, f]`` the log p of sample b with site f flipped."""
    if is_cpu_call(samples, *weights):
        return per_flip_log_probs_plain(weights, samples)
    u = check_weights(weights)
    b, n = check_samples(samples)
    check_supported(n, u, samples.device)
    hist, pfx, fl, lpf, lp = _scratch(b, n, u, samples.device)
    lib = load_library().lib
    with torch.cuda.device(samples.device):
        err = lib.rnnwf_tfim_flip_log_probs(
            samples.data_ptr(), *[w.data_ptr() for w in weights],
            hist.data_ptr(), pfx.data_ptr(), fl.data_ptr(), lpf.data_ptr(),
            lp.data_ptr(), b, n, u, stream_of(samples),
        )
    check(err, "rnnwf_tfim_flip_log_probs")
    tfim_flip_log_probs.launches += 1
    return lpf, lp


tfim_flip_log_probs.launches = 0


def tfim_sample_and_flip_log_probs(weights: Weights, num_samples: int, n_sites: int,
                                   seed: int, offset: int):
    """B6 in sample mode: K3's draws for ``(seed, offset)`` with their
    per-flip log p.  Returns (samples (B, N) int32, base log p (B,), lpf
    (B, N)).  ``tfim_sample_and_flip_sum(..., per_flip=True)`` calls it."""
    check_key(seed, offset)
    if is_cpu_call(*weights):
        uni = plain_uniforms(num_samples, n_sites, seed, offset, weights[0].device)
        return sample_and_per_flip_plain(weights, uni)
    u = check_weights(weights)
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1; got {num_samples}")
    check_supported(n_sites, u, weights[0].device)
    b, n, dev = num_samples, n_sites, weights[0].device
    samples = torch.empty(b, n, dtype=torch.int32, device=dev)
    hist, pfx, fl, lpf, lp = _scratch(b, n, u, dev)
    lib = load_library().lib
    with torch.cuda.device(dev):
        err = lib.rnnwf_tfim_sample_and_flip_log_probs(
            seed, offset, *[w.data_ptr() for w in weights], samples.data_ptr(),
            hist.data_ptr(), pfx.data_ptr(), fl.data_ptr(), lpf.data_ptr(),
            lp.data_ptr(), b, n, u, stream_of(weights[0]),
        )
    check(err, "rnnwf_tfim_sample_and_flip_log_probs")
    tfim_sample_and_flip_log_probs.launches += 1
    return samples, lp, lpf


tfim_sample_and_flip_log_probs.launches = 0


def tfim_sample_and_flip_sum(weights: Weights, num_samples: int, n_sites: int,
                             seed: int, offset: int, per_flip: bool = False):
    """K3: draw ``num_samples`` chains of ``n_sites`` spins and estimate their
    flip-ratio sums in one pass.  ``(seed, offset)`` (each in [0, 2^32))
    keys the kernel's Philox generator.  Returns (samples (B, N) int32,
    base log p (B,), ratio_sum (B,)); with ``per_flip`` (B6 in sample mode,
    ``tfim_sample_and_flip_log_probs``) the per-flip log p (B, N) in place
    of the ratio sum."""
    if per_flip:
        return tfim_sample_and_flip_log_probs(weights, num_samples, n_sites, seed, offset)
    check_key(seed, offset)
    if is_cpu_call(*weights):
        uni = plain_uniforms(num_samples, n_sites, seed, offset, weights[0].device)
        return sample_and_flip_sum_plain(weights, uni)
    u = check_weights(weights)
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1; got {num_samples}")
    check_supported(n_sites, u, weights[0].device)
    b, n, dev = num_samples, n_sites, weights[0].device
    samples = torch.empty(b, n, dtype=torch.int32, device=dev)
    hist, pfx, fl, terms, lp = _scratch(b, n, u, dev)
    ratio = torch.empty_like(lp)
    lib = load_library().lib
    with torch.cuda.device(dev):
        err = lib.rnnwf_tfim_sample_and_flip_sum(
            seed, offset, *[w.data_ptr() for w in weights], samples.data_ptr(),
            hist.data_ptr(), pfx.data_ptr(), fl.data_ptr(), terms.data_ptr(),
            lp.data_ptr(), ratio.data_ptr(), b, n, u, stream_of(weights[0]),
        )
    check(err, "rnnwf_tfim_sample_and_flip_sum")
    tfim_sample_and_flip_sum.launches += 1
    return samples, lp, ratio


tfim_sample_and_flip_sum.launches = 0
