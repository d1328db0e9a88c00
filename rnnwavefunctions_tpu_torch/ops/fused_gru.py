"""K1: teacher-forced log-probability of a single-layer GRU, the
``autograd.Function`` whose forward is K1 and whose backward is K2, and B5,
the stand-alone sampler.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_gru.py`` (``_log_prob_pallas``,
``make_log_prob_fn`` and ``_sample_pallas``).  K1 and B5 are the base pass
of ``csrc/tfim_flip.cu`` without its history, teacher-forced (K1) or in
sample mode (B5, so it draws K3's spins); when a gradient follows, K1 runs
the same pass storing K2's forward replay (``Replay``), and K2
(``ops/fused_gru_bwd.py``) starts from it.  The plain PyTorch versions are
the same site loops written with tensor ops (B5's is K3's base pass
``base_pass_plain`` on ``launch.plain_uniforms``; the replay's is
``replay_plain``).

A kernel's weights travel as a 6-tuple in the JAX package's parameter layout:
``(wx (2, 3U), wh (U, 3U), bx (3U,), bh (3U,), head_w (U, 2), head_b (2,))``
with gates packed ``[r | z | c]``.  Samples are (B, N) int32 spins in {0, 1}.

Every wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors through ``ops/launch.py``; on any other input it raises.
Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .compsum import kadd, kfinal
from .launch import (
    GRU_FAMILY,
    Weights,
    begin_draw,
    check_chains,
    counts_launches,
    fits_shared_memory,
    is_cpu_call,
    launch,
)


def supports(n_sites: int, units: Sequence[int], device) -> bool:
    """True when the GRU kernels K1-K4 take this shape on ``device``."""
    return fits_shared_memory(GRU_FAMILY, n_sites, units, device)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def spin_input(wx: torch.Tensor, bx: torch.Tensor, x: torch.Tensor,
               x_scale: float) -> torch.Tensor:
    """The first layer's input gates for the previous spin ``x`` (B,) as
    float: the one-hot row of ``wx`` picked by x, times ``x_scale`` (0 at
    site 0, where the input is the zero vector), plus ``bx``."""
    x = x[:, None]
    return x_scale * ((1.0 - x) * wx[0] + x * wx[1]) + bx


def gru_gates(gx: torch.Tensor, h: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor):
    """The reset-after GRU's gates of a (B, U) state from its input gates
    ``gx`` (B, 3U), gates packed ``[r | z | c]``: (r, z, c, ghc) with ghc =
    (h W_h + b_h)_c, the reset gate's operand."""
    u = h.shape[-1]
    gh = h @ wh + bh
    r = torch.sigmoid(gx[:, :u] + gh[:, :u])
    z = torch.sigmoid(gx[:, u : 2 * u] + gh[:, u : 2 * u])
    ghc = gh[:, 2 * u :]
    c = torch.tanh(gx[:, 2 * u :] + r * ghc)
    return r, z, c, ghc


def gru_layer(gx: torch.Tensor, h: torch.Tensor, wh: torch.Tensor,
              bh: torch.Tensor) -> torch.Tensor:
    """The reset-after GRU update of a (B, U) state from its input gates
    ``gx`` (B, 3U), gates packed ``[r | z | c]``."""
    _, z, c, _ = gru_gates(gx, h, wh, bh)
    return z * h + (1.0 - z) * c


def site_step(weights: Weights, h: torch.Tensor, x: torch.Tensor, x_scale: float):
    """One GRU + head step on a (B, U) state; ``x`` is the previous spin
    (B,) as float and ``x_scale`` is 0 at site 0 (the zero input vector).
    Returns (h_new, logit_0, logit_1)."""
    wx, wh, bx, bh, hw, hb = weights
    h_new = gru_layer(spin_input(wx, bx, x, x_scale), h, wh, bh)
    logits = h_new @ hw + hb
    return h_new, logits[:, 0], logits[:, 1]


def logp2(l0: torch.Tensor, l1: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Stable log-softmax probability of target ``s`` in {0, 1}."""
    m = torch.maximum(l0, l1)
    lse = m + torch.log(torch.exp(l0 - m) + torch.exp(l1 - m))
    return torch.where(s > 0.5, l1, l0) - lse


def log_prob_plain(weights: Weights, samples: torch.Tensor) -> torch.Tensor:
    """(B, N) int samples -> (B,) joint log p, Kahan-summed over sites."""
    b, n = samples.shape
    u = weights[1].shape[0]
    s = samples.to(torch.float32)
    h = torch.zeros(b, u, dtype=torch.float32, device=samples.device)
    x = torch.zeros(b, dtype=torch.float32, device=samples.device)
    acc = torch.zeros_like(x)
    cmp = torch.zeros_like(x)
    for i in range(n):
        h, l0, l1 = site_step(weights, h, x, 1.0 if i > 0 else 0.0)
        acc, cmp = kadd(acc, cmp, logp2(l0, l1, s[:, i]))
        x = s[:, i]
    return kfinal(acc, cmp)


def base_pass_plain(weights: Weights, samples: Optional[torch.Tensor] = None,
                    uniforms: Optional[torch.Tensor] = None):
    """Teacher-forced (``samples`` given) or sampling (``uniforms`` (B, N)
    given: s = 1 iff u >= p0) base pass of K3's flip estimator, B5's plain
    sampler.  Returns (spins (B, N) float, lp (B,), hist (B, N, U), pfx
    (B, N), fl (B, N))."""
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


class Replay(NamedTuple):
    """K2's forward replay, K1 storing (stage a of ``csrc/fused_gru_bwd.cu``):
    the joint log p and, per (sample, site), what the reverse sweep and the
    weight cotangent read."""

    lp: torch.Tensor     # (B,)
    rows: torch.Tensor   # (B, N + 1, U + 3) K2's A: [h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}]
    gates: torch.Tensor  # (B, N, 4U) [r | z | c | ghc] of site n
    p1: torch.Tensor     # (B, N) the head's p(s_n = 1)

    @property
    def hist(self) -> torch.Tensor:
        """(B, N, U) the states h_n."""
        return self.rows[:, 1:, : self.gates.shape[2] // 4]


def a_rows(hist: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K2's A rows (B, N + 1, U + 3) ``[h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}]``
    from the states h_n ``hist`` (B, N, U) and the spins ``s`` (B, N) as
    float; row 0 is ``[0 | 1 | 0 | 0]``."""
    b, _, u = hist.shape
    row0 = torch.zeros(b, 1, u + 3, dtype=torch.float32, device=hist.device)
    row0[..., u] = 1.0
    sv = s[..., None]
    return torch.cat([row0, torch.cat([hist, torch.ones_like(sv), 1.0 - sv, sv], dim=2)], dim=1)


def replay_plain(weights: Weights, samples: torch.Tensor) -> Replay:
    """The plain replay: ``log_prob_plain``'s loop keeping its gates."""
    wx, wh, bx, bh, hw, hb = weights
    b, n = samples.shape
    u = wh.shape[0]
    s = samples.to(torch.float32)
    h = torch.zeros(b, u, dtype=torch.float32, device=samples.device)
    x = torch.zeros(b, dtype=torch.float32, device=samples.device)
    acc = torch.zeros_like(x)
    cmp = torch.zeros_like(x)
    hist, gates, p1 = [], [], []
    for i in range(n):
        r, z, c, ghc = gru_gates(spin_input(wx, bx, x, 1.0 if i > 0 else 0.0), h, wh, bh)
        h = z * h + (1.0 - z) * c
        logits = h @ hw + hb
        l0, l1 = logits[:, 0], logits[:, 1]
        acc, cmp = kadd(acc, cmp, logp2(l0, l1, s[:, i]))
        hist.append(h)
        gates.append(torch.cat([r, z, c, ghc], dim=1))
        p1.append(torch.exp(logp2(l0, l1, torch.ones_like(x))))
        x = s[:, i]
    return Replay(kfinal(acc, cmp), a_rows(torch.stack(hist, 1), s), torch.stack(gates, 1),
                  torch.stack(p1, 1))


def log_prob_bwd_plain(weights: Weights, samples: torch.Tensor, g: torch.Tensor):
    """VJP of ``log_prob_plain`` for cotangent ``g`` (B,): autograd through
    the plain loop.  Returns the six weight gradients."""
    with torch.enable_grad():
        ws = [w.detach().requires_grad_(True) for w in weights]
        lp = log_prob_plain(ws, samples)
        return torch.autograd.grad(lp, ws, grad_outputs=g)


# ---------------------------------------------------------------------------
# K1 wrapper and the autograd Function (K1 forward, K2 backward)
# ---------------------------------------------------------------------------

def launch_replay(weights: Weights, samples: torch.Tensor) -> Replay:
    """Launches K1's base pass storing K2's replay on CUDA tensors (the
    callers count the launch: K1's wrapper, or K2's as its stage a)."""
    b, n, u = check_chains(weights, samples)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                       device=samples.device)
    out = Replay(empty(b), empty(b, n + 1, u + 3), empty(b, n, 4 * u), empty(b, n))
    launch("rnnwf_gru_replay", samples.device, samples, *weights, out.rows, out.gates, out.p1,
           out.lp, b, n, u)
    return out


@counts_launches()
def gru_log_prob(weights: Weights, samples: torch.Tensor, store: bool = False):
    """(B, N) int32 samples -> (B,) float32 joint log p (no gradient); with
    ``store``, the ``Replay`` that K2 starts from (its ``lp`` the same log
    p)."""
    if is_cpu_call(samples, *weights):
        return replay_plain(weights, samples) if store else log_prob_plain(weights, samples)
    if store:
        return launch_replay(weights, samples)
    b, n, u = check_chains(weights, samples)
    out = torch.empty(b, dtype=torch.float32, device=samples.device)
    launch("rnnwf_gru_log_prob", samples.device, samples, *weights, out, b, n, u)
    return out


class GRULogProb(torch.autograd.Function):
    """log p(samples) with K1 forward and K2 backward (the counterpart of
    ``make_log_prob_fn``'s ``custom_vjp``).  On the card, when a weight
    needs its gradient, the forward is K1 storing K2's replay, and the
    backward starts from it (one forward sweep per step, not two)."""

    @staticmethod
    def forward(ctx, samples, *weights):
        ctx.save_for_backward(samples, *weights)
        ctx.replay = None
        if samples.is_cuda and any(ctx.needs_input_grad[1:]):
            replay = gru_log_prob(weights, samples, store=True)
            ctx.replay = replay._replace(lp=None)  # ctx keeps no reference to its output
            return replay.lp
        return gru_log_prob(weights, samples)

    @staticmethod
    def backward(ctx, g):
        from .fused_gru_bwd import gru_log_prob_bwd

        samples, *weights = ctx.saved_tensors
        grads = gru_log_prob_bwd(tuple(weights), samples, g.contiguous(), replay=ctx.replay)
        return (None, *grads)


def log_prob(weights: Weights, samples: torch.Tensor) -> torch.Tensor:
    """Differentiable joint log p through the kernels."""
    return GRULogProb.apply(samples, *weights)


# ---------------------------------------------------------------------------
# B5: the stand-alone sampler
# ---------------------------------------------------------------------------

@torch.no_grad()
def sample_plain(weights: Weights, uniforms: torch.Tensor):
    """The sampling base pass on given (B, N) uniforms (s = 1 iff u >= p0):
    (samples (B, N) int32, log p (B,))."""
    spins, lp, *_ = base_pass_plain(weights, uniforms=uniforms)
    return spins.to(torch.int32), lp


@counts_launches()
def gru_sample(weights: Weights, num_samples: int, n_sites: int, seed: int, offset: int):
    """B5: draw ``num_samples`` chains of ``n_sites`` spins and their joint
    log p.  ``(seed, offset)`` (each in [0, 2^32)) keys the kernel's Philox
    generator, whose draws are K3's for the same key.  Returns (samples
    (B, N) int32, log p (B,))."""
    draw = begin_draw(weights, num_samples, (n_sites,), seed, offset, GRU_FAMILY)
    if draw.uniforms is not None:
        return sample_plain(weights, draw.uniforms)
    lp = torch.empty(num_samples, dtype=torch.float32, device=draw.samples.device)
    launch("rnnwf_gru_sample", lp.device, seed, offset, *weights, draw.samples, lp,
           num_samples, n_sites, draw.u)
    return draw.samples, lp
