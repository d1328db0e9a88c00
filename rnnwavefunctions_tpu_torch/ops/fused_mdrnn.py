"""B12 and B13: the 2D MDRNN's boustrophedon sweep, teacher-forced (joint
log p) and sampling, and the ``autograd.Function`` whose forward is B12 and
whose backward is B14.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_mdrnn.py`` (``mdrnn_log_prob``,
``mdrnn_sample``, ``make_mdrnn_log_prob_fn``).  The CUDA kernels are
``csrc/fused_mdrnn.cu``; when a gradient follows, B12 stores B14's replay
(``Replay``) and B14 (``ops/fused_mdrnn_bwd.py``) starts from it.  The plain
PyTorch versions below are the same site loop in visit order written with
tensor ops (the replay's is ``replay_plain``).

Visit order: left to right on even rows, right to left on odd rows
(``visit_order``).  Each site consumes the spin and cell output of its
horizontal predecessor in visit order and of its neighbour one row up; at
the lattice boundary that neighbour is a zero vector input and a zero
state.  The site step keeps the kernels' conventions (``fused_mdrnn.py:48-66``
of the JAX package): input terms ``sh * ((1 - x_h) uh[0] + x_h uh[1])`` with
boundary flags ``sh``/``sv``, and the activation ``exp(min(pre, 0)) - 1``
for ``pre <= 0`` (the jnp path's ``elu`` uses expm1; the two agree to f32
rounding).  Site log-probs are Kahan-summed in visit order.

A kernel's weights travel as a 7-tuple in the JAX package's layout:
``(uh (2, U), uv (2, U), wh (U, U), wv (U, U), b (U,), head_w (U, 2),
head_b (2,))``.  Samples are (B, Nx, Ny) int32 spins indexed [b, x, y].
Every wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; on any other input it raises.  Each wrapper counts
its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .compsum import kadd, kfinal
from .fused_gru import logp2
from .launch import (
    MDRNN_FAMILY,
    Weights,
    begin_draw,
    check_layout,
    check_samples,
    check_supported,
    counts_launches,
    fits_shared_memory,
    is_cpu_call,
    launch,
)


def supports(nx: int, ny: int, u: int, device) -> bool:
    """True when the MDRNN kernels B12-B16 take an Nx x Ny lattice at width
    U on ``device`` (asked of the kernel library on a CUDA device)."""
    return ny >= 1 and fits_shared_memory(MDRNN_FAMILY, nx * ny, (u,), device, nx=nx)


def visit_order(nx: int, ny: int):
    """Boustrophedon (visit-order) lattice coordinates: arrays (NS,) of x, y."""
    yy = np.repeat(np.arange(ny), nx)
    kk = np.tile(np.arange(nx), ny)
    xx = np.where(yy % 2 == 0, kk, nx - 1 - kk)
    return xx, yy


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _input_term(w_in: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The one-hot row of ``w_in`` (2, U) picked by the spins ``x`` (B,)."""
    x = x[:, None]
    return (1.0 - x) * w_in[0] + x * w_in[1]


def site_step(weights: Weights, hh, xh, sh: float, hv, xv, sv: float):
    """One MDRNN cell + head step on (B, U) neighbour states and (B,)
    neighbour spins; ``sh``/``sv`` are 0 where the neighbour lies outside
    the lattice.  Returns (h_new, logit_0, logit_1)."""
    uh, uv, wh, wv, b, hw, hb = weights
    pre = sh * _input_term(uh, xh) + sv * _input_term(uv, xv) + hh @ wh + hv @ wv + b
    h = torch.where(pre > 0, pre, torch.exp(torch.clamp(pre, max=0.0)) - 1.0)
    logits = h @ hw + hb
    return h, logits[:, 0], logits[:, 1]


def sweep_plain(weights: Weights, nx: int, ny: int, samples: Optional[torch.Tensor] = None,
                uniforms: Optional[torch.Tensor] = None, history: bool = True):
    """Teacher-forced (``samples`` (B, Nx, Ny) given) or sampling
    (``uniforms`` (B, NS) in visit order given: s = 1 iff u >= p0) sweep.
    Returns, in visit order, (spins (B, NS) float, lp (B,), the cell-output
    history (B, NS, U), the corrected running prefix pfx (B, NS)); the last
    two are None without ``history``."""
    src = samples if samples is not None else uniforms
    b, dev = src.shape[0], src.device
    u, dtype = weights[2].shape[0], weights[2].dtype  # float32, or float64 for a reference
    xx, yy = visit_order(nx, ny)
    if samples is not None:
        idx = [torch.from_numpy(a).to(dev) for a in (xx, yy)]
        spins_v = samples[:, idx[0], idx[1]].to(dtype)
    zeros = torch.zeros(b, u, dtype=dtype, device=dev)
    zb = torch.zeros(b, dtype=dtype, device=dev)
    row, srow = [zeros] * nx, [zb] * nx  # the last state and spin of each column
    h, x, acc, cmp = zeros, zb, zb, zb
    spins, hist, pfx = [], [], []
    for m in range(nx * ny):
        y, k, col = m // nx, m % nx, int(xx[m])
        hh, xh, sh = (h, x, 1.0) if k > 0 else (zeros, zb, 0.0)
        hv, xv, sv = (row[col], srow[col], 1.0) if y > 0 else (zeros, zb, 0.0)
        h, l0, l1 = site_step(weights, hh, xh, sh, hv, xv, sv)
        if samples is not None:
            s = spins_v[:, m]
        else:
            s = (uniforms[:, m] >= torch.sigmoid(l0 - l1)).to(dtype)
        acc, cmp = kadd(acc, cmp, logp2(l0, l1, s))
        row[col], srow[col], x = h, s, s
        spins.append(s)
        if history:
            hist.append(h)
            pfx.append(kfinal(acc, cmp))
    stack = lambda xs: torch.stack(xs, dim=1) if xs else None  # noqa: E731
    return stack(spins), kfinal(acc, cmp), stack(hist), stack(pfx)


def to_lattice(spins: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """(B, NS) visit-order spins -> (B, Nx, Ny) int32 samples."""
    xx, yy = (torch.from_numpy(a).to(spins.device) for a in visit_order(nx, ny))
    out = torch.zeros(spins.shape[0], nx, ny, dtype=torch.int32, device=spins.device)
    out[:, xx, yy] = spins.to(torch.int32)
    return out


def log_prob_plain(weights: Weights, samples: torch.Tensor) -> torch.Tensor:
    """(B, Nx, Ny) int samples -> (B,) joint log p."""
    _, nx, ny = samples.shape
    return sweep_plain(weights, nx, ny, samples=samples, history=False)[1]


@torch.no_grad()
def sample_plain(weights: Weights, uniforms: torch.Tensor, nx: int, ny: int):
    """Draws with the (B, NS) visit-order ``uniforms``; returns (samples
    (B, Nx, Ny) int32, log p (B,))."""
    spins, lp, _, _ = sweep_plain(weights, nx, ny, uniforms=uniforms, history=False)
    return to_lattice(spins, nx, ny), lp


class Replay(NamedTuple):
    """B14's replay, B12 storing (stage 1 of ``csrc/fused_mdrnn_bwd.cu``):
    the joint log p and, per (sample, visit position), what the reverse
    sweep and the weight cotangent read."""

    lp: torch.Tensor    # (B,)
    hist: torch.Tensor  # (B, NS, U) the cell outputs h_m in visit order
    p1: torch.Tensor    # (B, NS) the head's p(s_m = 1)


def replay_plain(weights: Weights, samples: torch.Tensor) -> Replay:
    """The plain replay: ``sweep_plain``'s teacher-forced history and log p,
    and the head's p(s = 1) on that history."""
    _, nx, ny = samples.shape
    _, lp, hist, _ = sweep_plain(weights, nx, ny, samples=samples)
    logits = hist @ weights[5] + weights[6]
    p1 = torch.exp(logp2(logits[..., 0], logits[..., 1], torch.ones_like(logits[..., 0])))
    return Replay(lp, hist, p1)


def log_prob_bwd_plain(weights: Weights, samples: torch.Tensor, g: torch.Tensor):
    """VJP of ``log_prob_plain`` for cotangent ``g`` (B,): autograd through
    the plain loop.  Returns the seven weight gradients."""
    with torch.enable_grad():
        ws = [w.detach().requires_grad_(True) for w in weights]
        lp = log_prob_plain(ws, samples)
        return torch.autograd.grad(lp, ws, grad_outputs=g)


def check_weights(weights: Weights) -> int:
    """Checks the MDRNN kernels' 7-tuple of weights; returns U."""
    u = weights[2].shape[0] if len(weights) > 2 else 0
    check_layout(weights, [(2, u), (2, u), (u, u), (u, u), (u,), (u, 2), (2,)])
    return u


def check_lattices(weights: Weights, samples: torch.Tensor):
    """The checks before a launch on (B, Nx, Ny) samples: (B, Nx, Ny, U)."""
    u = check_weights(weights)
    b, nx, ny = check_samples(samples, 3)
    check_supported(nx * ny, u, samples.device, MDRNN_FAMILY, nx=nx)
    return b, nx, ny, u


# ---------------------------------------------------------------------------
# B12 and B13 wrappers and the autograd Function (B12 forward, B14 backward)
# ---------------------------------------------------------------------------

def launch_replay(weights: Weights, samples: torch.Tensor) -> Replay:
    """Launches B12 storing B14's replay on CUDA tensors (the callers count
    the launch: B12's wrapper, or B14's as its stage 1)."""
    b, nx, ny, u = check_lattices(weights, samples)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                       device=samples.device)
    out = Replay(empty(b), empty(b, nx * ny, u), empty(b, nx * ny))
    launch("rnnwf_mdrnn_replay", samples.device, samples, *weights, out.hist, out.p1, out.lp,
           b, nx, ny, u)
    return out


@counts_launches()
def mdrnn_log_prob(weights: Weights, samples: torch.Tensor, store: bool = False):
    """B12: (B, Nx, Ny) int32 samples -> (B,) float32 joint log p (no
    gradient); with ``store``, the ``Replay`` that B14 starts from (its
    ``lp`` the same log p)."""
    if is_cpu_call(samples, *weights):
        return replay_plain(weights, samples) if store else log_prob_plain(weights, samples)
    if store:
        return launch_replay(weights, samples)
    b, nx, ny, u = check_lattices(weights, samples)
    out = torch.empty(b, dtype=torch.float32, device=samples.device)
    launch("rnnwf_mdrnn_log_prob", samples.device, samples, *weights, out, b, nx, ny, u)
    return out


@counts_launches()
def mdrnn_sample(weights: Weights, num_samples: int, nx: int, ny: int, seed: int,
                 offset: int):
    """B13: draw ``num_samples`` Nx x Ny lattices.  ``(seed, offset)`` (each
    in [0, 2^32)) keys the kernel's Philox generator with counter (sample,
    visit position), as B16's.  Returns (samples (B, Nx, Ny) int32, log p
    (B,))."""
    draw = begin_draw(weights, num_samples, (nx, ny), seed, offset, MDRNN_FAMILY, check_weights)
    if draw.uniforms is not None:
        return sample_plain(weights, draw.uniforms, nx, ny)
    lp = torch.empty(num_samples, dtype=torch.float32, device=draw.samples.device)
    launch("rnnwf_mdrnn_sample", lp.device, seed, offset, *weights, draw.samples, lp,
           num_samples, nx, ny, draw.u)
    return draw.samples, lp


class MDRNNLogProb(torch.autograd.Function):
    """log p(samples) with B12 forward and B14 backward (the counterpart of
    ``make_mdrnn_log_prob_fn``'s ``custom_vjp``).  On the card, when a
    weight needs its gradient, the forward is B12 storing B14's replay, and
    the backward starts from it (one forward sweep per step, not two)."""

    @staticmethod
    def forward(ctx, samples, *weights):
        ctx.save_for_backward(samples, *weights)
        ctx.replay = None
        if samples.is_cuda and any(ctx.needs_input_grad[1:]):
            replay = mdrnn_log_prob(weights, samples, store=True)
            ctx.replay = replay._replace(lp=None)  # ctx keeps no reference to its output
            return replay.lp
        return mdrnn_log_prob(weights, samples)

    @staticmethod
    def backward(ctx, g):
        from .fused_mdrnn_bwd import mdrnn_log_prob_bwd

        samples, *weights = ctx.saved_tensors
        grads = mdrnn_log_prob_bwd(tuple(weights), samples, g.contiguous(), replay=ctx.replay)
        return (None, *grads)


def log_prob(weights: Weights, samples: torch.Tensor) -> torch.Tensor:
    """Differentiable joint log p through the kernels."""
    return MDRNNLogProb.apply(samples, *weights)
