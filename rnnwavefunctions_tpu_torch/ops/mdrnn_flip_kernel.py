"""B15 and B16: the 2D TFIM single-flip ratio sum of the MDRNN by prefix
sharing in visit order.

Counterpart of ``rnnwavefunctions_tpu/ops/mdrnn_flip_kernel.py``
(``mdrnn_flip_ratio_sum`` and ``mdrnn_sample_and_flip_sum``).  Per sample it
returns

    ratio[b] = sum_f exp(0.5 * (log p(sigma_b with site f flipped) - log p(sigma_b)))

over the NS lattice sites, and the base log p.  The MDRNN is autoregressive
in the boustrophedon visit order, so flipping the spin at visit position f
leaves positions < f untouched: ``log p(sigma^(f)) = pfx[f-1] + (positions
f..NS-1 recomputed)``.  The recomputed suffix reads its vertical states from
its own row buffer where the site above was recomputed (``vis_up >= f``) and
from the base history otherwise; the flipped spin is also the vertical
input of the site below it, one row later.

The CUDA kernels are ``csrc/mdrnn_flip.cu`` (with the sweep of
``csrc/fused_mdrnn.cu`` as base pass, sample mode on or off; the suffix
pass runs each site's two recurrent products as one 3xTF32 product on the
tensor cores, its row buffers in device memory).  The plain versions below run the same base pass and
recompute every flip's suffix explicitly, all flips of a sample side by
side.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .compsum import kadd, kfinal
from .fused_gru import logp2
from .fused_mdrnn import (
    check_lattices,
    check_weights,
    site_step,
    sweep_plain,
    to_lattice,
    visit_order,
)
from .launch import MDRNN_FAMILY, Weights, begin_draw, call, counts_launches, is_cpu_call, launch
from .tfim_flip_kernel import ratio_sum

# the base pass: (spins (B, NS), lp (B,), hist (B, NS, U), pfx (B, NS)), visit order
base_pass_plain = sweep_plain


def flip_log_probs_plain(weights: Weights, spins: torch.Tensor, hist: torch.Tensor,
                         pfx: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """(B, NS) log p of every single-flip configuration (flip index = visit
    position), by explicit suffix recomputation from the base pass.  Every
    flip carries its own horizontal state and spin and its own
    column-indexed (Nx, U) row buffer; at position m the flips f <= m
    advance, flip m starting there."""
    b, ns, u = hist.shape
    xx, _ = visit_order(nx, ny)
    f = dict(dtype=hist.dtype, device=hist.device)  # float32, or float64 for a reference
    dev = hist.device
    h = torch.zeros(b, ns, u, **f)  # horizontal carries
    x = torch.zeros(b, ns, **f)     # their spins
    acc = torch.zeros(b, ns, **f)
    cmp = torch.zeros_like(acc)
    rowbuf = torch.zeros(nx, b, ns, u, **f)
    flips = torch.arange(ns, device=dev)
    for m in range(ns):
        y, k, col = m // nx, m % nx, int(xx[m])
        up = m - 2 * k - 1
        if k > 0:  # flip m starts from the base pass at m - 1
            h[:, m] = hist[:, m - 1]
            x[:, m] = spins[:, m - 1]
        if m > 0:
            acc[:, m] = pfx[:, m - 1]
        a = m + 1
        tgt = spins[:, m : m + 1].expand(b, a).clone()
        tgt[:, m] = 1.0 - tgt[:, m]
        zeros = torch.zeros(b * a, u, **f)
        if y > 0:
            xv = spins[:, up : up + 1].expand(b, a).clone()
            xv[:, up] = 1.0 - xv[:, up]
            own = (up >= flips[:a])[None, :, None]
            hv = torch.where(own, rowbuf[col, :, :a], hist[:, up, None, :]).reshape(-1, u)
            xv, sv = xv.reshape(-1), 1.0
        else:
            hv, xv, sv = zeros, torch.zeros(b * a, **f), 0.0
        if k > 0:
            hh, xh, sh = h[:, :a].reshape(-1, u), x[:, :a].reshape(-1), 1.0
        else:
            hh, xh, sh = zeros, torch.zeros(b * a, **f), 0.0
        h_new, l0, l1 = site_step(weights, hh, xh, sh, hv, xv, sv)
        s_acc, s_cmp = kadd(acc[:, :a].reshape(-1), cmp[:, :a].reshape(-1),
                            logp2(l0, l1, tgt.reshape(-1)))
        acc[:, :a] = s_acc.view(b, a)
        cmp[:, :a] = s_cmp.view(b, a)
        h[:, :a] = h_new.view(b, a, u)
        x[:, :a] = tgt
        rowbuf[col, :, :a] = h_new.view(b, a, u)
    return kfinal(acc, cmp)


@torch.no_grad()
def flip_ratio_sum_plain(weights: Weights, samples: torch.Tensor):
    _, nx, ny = samples.shape
    spins, lp, hist, pfx = base_pass_plain(weights, nx, ny, samples=samples)
    return ratio_sum(flip_log_probs_plain(weights, spins, hist, pfx, nx, ny), lp), lp


@torch.no_grad()
def sample_and_flip_sum_plain(weights: Weights, uniforms: torch.Tensor, nx: int, ny: int):
    """Draws with the (B, NS) visit-order ``uniforms`` (as ``sample_plain``)
    and returns (samples (B, Nx, Ny) int32, base log p (B,), ratio (B,))."""
    spins, lp, hist, pfx = base_pass_plain(weights, nx, ny, uniforms=uniforms)
    ratio = ratio_sum(flip_log_probs_plain(weights, spins, hist, pfx, nx, ny), lp)
    return to_lattice(spins, nx, ny), lp, ratio


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _scratch(b: int, nx: int, ny: int, u: int, dev):
    """hist, pfx, terms, lp, ratio and the suffix pass's row buffers (sized
    by the library)."""
    ns = nx * ny
    rows = ctypes.c_longlong(0)
    call("rnnwf_mdrnn_suffix_scratch_floats", dev, b, nx, ny, u, ctypes.byref(rows))
    f32 = dict(dtype=torch.float32, device=dev)
    return (
        torch.empty(b * ns * u, **f32),            # cell-output history
        torch.empty(b * ns, **f32),                # pfx
        torch.empty(b * ns, **f32),                # per-flip ratio terms
        torch.empty(b, **f32),                     # base log p
        torch.empty(b, **f32),                     # ratio sum
        torch.empty(rows.value, **f32),            # row buffers
    )


@counts_launches()
def mdrnn_flip_ratio_sum(weights: Weights, samples: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B15: (B, Nx, Ny) int32 samples -> (ratio_sum (B,), base log p (B,))."""
    if is_cpu_call(samples, *weights):
        return flip_ratio_sum_plain(weights, samples)
    b, nx, ny, u = check_lattices(weights, samples)
    hist, pfx, terms, lp, ratio, rows = _scratch(b, nx, ny, u, samples.device)
    launch("rnnwf_mdrnn_flip_ratio_sum", samples.device, samples, *weights, hist, pfx, terms,
           lp, ratio, rows, rows.numel(), b, nx, ny, u)
    return ratio, lp


@counts_launches()
def mdrnn_sample_and_flip_sum(weights: Weights, num_samples: int, nx: int, ny: int,
                              seed: int, offset: int):
    """B16: draw ``num_samples`` Nx x Ny lattices (the same draws as B13 for
    the same ``(seed, offset)``) and estimate their flip-ratio sums in one
    pass.  Returns (samples (B, Nx, Ny) int32, base log p (B,), ratio_sum
    (B,))."""
    draw = begin_draw(weights, num_samples, (nx, ny), seed, offset, MDRNN_FAMILY, check_weights)
    if draw.uniforms is not None:
        return sample_and_flip_sum_plain(weights, draw.uniforms, nx, ny)
    dev = draw.samples.device
    hist, pfx, terms, lp, ratio, rows = _scratch(num_samples, nx, ny, draw.u, dev)
    launch("rnnwf_mdrnn_sample_and_flip_sum", dev, seed, offset, *weights, draw.samples, hist,
           pfx, terms, lp, ratio, rows, rows.numel(), num_samples, nx, ny, draw.u)
    return draw.samples, lp, ratio
