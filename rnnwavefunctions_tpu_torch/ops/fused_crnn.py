"""B7: teacher-forced (Re, Im) log psi of the complex U(1) cRNN, B9's
forward replay, the ``autograd.Function`` whose forward is B7 (or, when a
gradient follows on the card, the replay) and whose backward is B9, and
B8, the stand-alone U(1)-masked sampler.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_crnn.py``
(``crnn_log_amp_parts``, ``_crnn_site_rows``, ``make_log_amp_parts_fn`` and
``crnn_sample``).  All three run the base pass of ``csrc/j1j2_exchange.cu``:
B8 in sample mode without its history, so it draws B11's spins; B7
teacher-forced, storing nothing, so its (Re, Im) on B11's samples are B11's
bit for bit; B9's replay (``crnn_replay``) teacher-forced, storing what B9's
later stages read (``CReplay``).  The
plain PyTorch versions below are the same site loops written with tensor
ops, teacher-forced or on given uniforms.

Per site, in log space (no complex arithmetic): the reset-after GRU trunk,
the amplitude head ``lp0 = -softplus(-d)``, ``lp1 = -softplus(d)`` with
``d = l0 - l1`` (log of the softmax), and the phase head ``pi * softsign``.
Under the U(1) mask, sites with ``2n >= N`` keep only the classes that do
not push either spin count past ``N//2`` (heavyside with H(0)=1 on
``N//2 - 1 - count``) and renormalise with eps 1e-30; a forbidden target
gets the finite ``LOG_ZERO - log_norm2``.  ``Re log psi`` sums
``0.5 * lp_target`` and ``Im log psi`` the target's phase, both Kahan-summed.

A kernel's weights travel as an 8-tuple in the JAX package's layout:
``(wx (2, 3U), wh (U, 3U), bx (3U,), bh (3U,), ampl_w (U, 2), ampl_b (2,),
phase_w (U, 2), phase_b (2,))``.  The plain versions also take a uniform
stack: four tensors per GRU layer, then the two heads.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from .build import load_library
from .compsum import kadd, kfinal
from .fused_gru import a_rows, gru_gates, gru_layer, spin_input
from .launch import (
    CRNN_FAMILY,
    Weights,
    begin_draw,
    check_chains,
    check_weights,
    counts_launches,
    fits_shared_memory,
    is_cpu_call,
    launch,
)

LOG_ZERO = -1e9  # finite stand-in for log 0 of a masked class

# the cRNN kernels' weights: the GRU layer and the amplitude and phase heads
check_crnn_weights = functools.partial(check_weights, heads=2)


def supports(n_sites: int, units: Sequence[int], device) -> bool:
    """True when the cRNN kernels B7-B11 take this shape on ``device`` (one
    GRU layer whose kernels fit shared memory)."""
    return fits_shared_memory(CRNN_FAMILY, n_sites, units, device)


# the cRNN family's kernels in the order rnnwf_crnn_smem_bytes reports them
SMEM_KERNELS = ("the base pass of B7, B8, B10, B11 and B9's replay",
                "the suffix pass of B10 and B11", "the reverse sweep of B9 and B20", "B19")


def shared_memory_bytes(u: int) -> Dict[str, int]:
    """Each cRNN kernel's dynamic shared memory at width ``u`` (bytes), as
    its launch asks for it."""
    need = (ctypes.c_longlong * len(SMEM_KERNELS))()
    load_library().lib.rnnwf_crnn_smem_bytes(u, need)
    return dict(zip(SMEM_KERNELS, need))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def site_heads(top: torch.Tensor, heads: Weights, n: int, num_up: torch.Tensor,
               n_sites: int, u1: bool):
    """The two heads at site ``n`` on the trunk output ``top`` (B, U):
    (lp0, lp1, ph0, ph1), each (B,), where lp_i is the log of the masked,
    renormalised probability of class i and ph_i its phase (the counterpart
    of ``_crnn_site_rows``).  ``num_up`` (B,) counts the ups before n."""
    aw, ab, pw, pb = heads
    la = top @ aw + ab
    d = la[:, 0] - la[:, 1]
    lp0 = -_softplus(-d)
    lp1 = -_softplus(d)
    if u1 and 2 * n >= n_sites:
        baseline = n_sites // 2 - 1
        act_up = baseline - num_up >= 0  # heavyside, H(0) = 1
        act_down = baseline - (n - num_up) >= 0
        zero = torch.zeros_like(lp0)
        norm2 = torch.clamp_min(torch.where(act_down, torch.exp(lp0), zero)
                                + torch.where(act_up, torch.exp(lp1), zero), 1e-30)
        log_norm2 = torch.log(norm2)
        lp0 = torch.where(act_down, lp0, LOG_ZERO) - log_norm2
        lp1 = torch.where(act_up, lp1, LOG_ZERO) - log_norm2
    q = top @ pw + pb
    ph = math.pi * q / (1.0 + torch.abs(q))
    return lp0, lp1, ph[:, 0], ph[:, 1]


def trunk_step(weights: Weights, hs, x: torch.Tensor, x_scale: float):
    """One site of the GRU stack (four tensors per layer at the head of
    ``weights``); returns (top output, new per-layer states)."""
    new_hs, inp = [], None
    for layer, h in enumerate(hs):
        wx, wh, bx, bh = weights[4 * layer : 4 * layer + 4]
        gx = spin_input(wx, bx, x, x_scale) if layer == 0 else inp @ wx + bx
        inp = gru_layer(gx, h, wh, bh)
        new_hs.append(inp)
    return inp, new_hs


def base_pass_plain(weights: Weights, u1: bool, samples: Optional[torch.Tensor] = None,
                    uniforms: Optional[torch.Tensor] = None):
    """Teacher-forced (``samples`` given) or sampling (``uniforms`` (B, N)
    given: s = 1 iff u >= p0, clamped to the allowed class) site loop.
    Returns (spins (B, N) float, Re log psi (B,), Im log psi (B,))."""
    src = samples if samples is not None else uniforms
    b, n = src.shape
    u = weights[1].shape[0]
    dev = src.device
    hs = [torch.zeros(b, u, dtype=torch.float32, device=dev)] * ((len(weights) - 4) // 4)
    x = torch.zeros(b, dtype=torch.float32, device=dev)
    num_up = torch.zeros_like(x)
    re, rec, im, imc = (torch.zeros_like(x) for _ in range(4))
    spins = []
    for i in range(n):
        top, hs = trunk_step(weights, hs, x, 1.0 if i > 0 else 0.0)
        lp0, lp1, ph0, ph1 = site_heads(top, weights[-4:], i, num_up, n, u1)
        if samples is not None:
            s = samples[:, i].to(torch.float32)
        else:
            s = (uniforms[:, i] >= torch.exp(lp0)).to(torch.float32)
            # the exp/log round trip can leave a masked class a sliver of
            # probability: a forbidden draw is clamped to the allowed class
            s = torch.where(lp1 < 0.5 * LOG_ZERO, 0.0, s)
            s = torch.where(lp0 < 0.5 * LOG_ZERO, 1.0, s)
        re, rec = kadd(re, rec, 0.5 * torch.where(s > 0.5, lp1, lp0))
        im, imc = kadd(im, imc, torch.where(s > 0.5, ph1, ph0))
        spins.append(s)
        x = s
        num_up = num_up + s
    return torch.stack(spins, dim=1), kfinal(re, rec), kfinal(im, imc)


def log_amp_parts_plain(weights: Weights, samples: torch.Tensor, u1: bool):
    """(B, N) int samples -> (Re log psi, Im log psi), each (B,)."""
    return base_pass_plain(weights, u1, samples=samples)[1:]


class CReplay(NamedTuple):
    """B9's forward replay, B10's base pass storing (stage a of
    ``csrc/fused_crnn_bwd.cu``): (Re, Im) log psi and, per (sample, site),
    what the reverse sweep and the weight cotangent read."""

    re: torch.Tensor     # (B,)
    im: torch.Tensor     # (B,)
    rows: torch.Tensor   # (B, N + 1, U + 3) K2's A: [h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}]
    gates: torch.Tensor  # (B, N, 4U) [r | z | c | ghc] of site n
    seeds: torch.Tensor  # (B, N, 2) [a_n, q_n], the heads' seeds at g = 1

    @property
    def hist(self) -> torch.Tensor:
        """(B, N, U) the states h_n."""
        return self.rows[:, 1:, : self.gates.shape[2] // 4]


def head_seeds_plain(d: torch.Tensor, qs: torch.Tensor, s: torch.Tensor, n: int,
                     num_up: torch.Tensor, n_sites: int, u1: bool) -> torch.Tensor:
    """The replay's seeds at site ``n``, (B, 2) ``[a_n, q_n]``, from the
    amplitude logits' difference ``d = l0 - l1``, the target's phase logit
    ``qs``, the target ``s`` and the ups before n: a_n is d Re_n / d d of
    Re_n = 0.5 lp_s (unmasked, d lp0/dd = p1 and d lp1/dd = -p0; under the
    U(1) mask through the renormalisation, the gradient passing
    max(raw, 1e-30) only unclamped: fused_crnn_bwd.py:11-25 of the JAX
    package), q_n = pi / (1 + |qs|)^2 = d Im_n / d qs."""
    p0, p1 = torch.sigmoid(d), torch.sigmoid(-d)
    dlp0, dlp1 = 0.5 * (1.0 - s), 0.5 * s
    if u1 and 2 * n >= n_sites:
        baseline = n_sites // 2 - 1
        act_up = (baseline - num_up >= 0).to(torch.float32)  # heavyside, H(0) = 1
        act_down = (baseline - (n - num_up) >= 0).to(torch.float32)
        raw = act_down * p0 + act_up * p1
        gsum = torch.where(raw > 1e-30, (dlp0 + dlp1) / torch.clamp_min(raw, 1e-30), 0.0)
        dlp0, dlp1 = dlp0 * act_down - gsum * act_down * p0, dlp1 * act_up - gsum * act_up * p1
    return torch.stack([dlp0 * p1 - dlp1 * p0, math.pi / (1.0 + torch.abs(qs)) ** 2], dim=1)


def replay_plain(weights: Weights, samples: torch.Tensor, u1: bool) -> CReplay:
    """The plain replay: ``log_amp_parts_plain``'s loop keeping its gates,
    states and seeds."""
    wx, wh, bx, bh, aw, ab, pw, pb = weights
    b, n = samples.shape
    s = samples.to(torch.float32)
    h = torch.zeros(b, wh.shape[0], dtype=torch.float32, device=samples.device)
    x = torch.zeros(b, dtype=torch.float32, device=samples.device)
    num_up = torch.zeros_like(x)
    re, rec, im, imc = (torch.zeros_like(x) for _ in range(4))
    hist, gates, seeds = [], [], []
    for i in range(n):
        r, z, c, ghc = gru_gates(spin_input(wx, bx, x, 1.0 if i > 0 else 0.0), h, wh, bh)
        h = z * h + (1.0 - z) * c
        lp0, lp1, ph0, ph1 = site_heads(h, weights[4:], i, num_up, n, u1)
        one = s[:, i] > 0.5
        re, rec = kadd(re, rec, 0.5 * torch.where(one, lp1, lp0))
        im, imc = kadd(im, imc, torch.where(one, ph1, ph0))
        la, q = h @ aw + ab, h @ pw + pb
        seeds.append(head_seeds_plain(la[:, 0] - la[:, 1], torch.where(one, q[:, 1], q[:, 0]),
                                      s[:, i], i, num_up, n, u1))
        hist.append(h)
        gates.append(torch.cat([r, z, c, ghc], dim=1))
        x = s[:, i]
        num_up = num_up + x
    return CReplay(kfinal(re, rec), kfinal(im, imc), a_rows(torch.stack(hist, 1), s),
                   torch.stack(gates, 1), torch.stack(seeds, 1))


# ---------------------------------------------------------------------------
# B7 and B9's replay, and the autograd Function (B7 or the replay forward,
# B9 backward)
# ---------------------------------------------------------------------------

@counts_launches()
def crnn_log_amp_parts(weights: Weights, samples: torch.Tensor, u1: bool):
    """(B, N) int32 samples -> (Re, Im) log psi, each (B,) float32 (no
    gradient)."""
    if is_cpu_call(samples, *weights):
        return log_amp_parts_plain(weights, samples, u1)
    b, n, u = check_chains(weights, samples, CRNN_FAMILY, heads=2)
    re = torch.empty(b, dtype=torch.float32, device=samples.device)
    im = torch.empty_like(re)
    launch("rnnwf_crnn_log_amp_parts", samples.device, samples, *weights, re, im, b, n, u,
           int(u1))
    return re, im


def launch_replay(weights: Weights, samples: torch.Tensor, u1: bool) -> CReplay:
    """Launches B10's base pass storing B9's replay on CUDA tensors (the
    callers count the launch: ``crnn_replay``, or B9's wrapper as its stage
    a)."""
    b, n, u = check_chains(weights, samples, CRNN_FAMILY, heads=2)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                       device=samples.device)
    out = CReplay(empty(b), empty(b), empty(b, n + 1, u + 3), empty(b, n, 4 * u), empty(b, n, 2))
    launch("rnnwf_crnn_replay", samples.device, samples, *weights, out.rows, out.gates,
           out.seeds, out.re, out.im, b, n, u, int(u1))
    return out


@counts_launches()
def crnn_replay(weights: Weights, samples: torch.Tensor, u1: bool) -> CReplay:
    """B9's replay of (B, N) int32 samples (no gradient): ``CReplay``, whose
    (Re, Im) are B7's function."""
    if is_cpu_call(samples, *weights):
        return replay_plain(weights, samples, u1)
    return launch_replay(weights, samples, u1)


class CRNNLogAmpParts(torch.autograd.Function):
    """(Re, Im) log psi with B7 forward and B9 backward (the counterpart of
    ``make_log_amp_parts_fn``'s ``custom_vjp``).  On the card, when a weight
    needs its gradient, the forward is B9's replay (B10's base pass
    storing) in B7's place, and the backward starts from it; B7 serves the
    calls that no gradient follows.  Gradients are defined inside the U(1)
    sector only, where the sampler draws."""

    @staticmethod
    def forward(ctx, u1, samples, *weights):
        ctx.u1 = u1
        ctx.save_for_backward(samples, *weights)
        ctx.replay = None
        if samples.is_cuda and any(ctx.needs_input_grad[2:]):
            replay = crnn_replay(weights, samples, u1)
            # ctx keeps no reference to its outputs
            ctx.replay = replay._replace(re=None, im=None)
            return replay.re, replay.im
        return crnn_log_amp_parts(weights, samples, u1)

    @staticmethod
    def backward(ctx, g_re, g_im):
        from .fused_crnn_bwd import crnn_log_amp_bwd

        samples, *weights = ctx.saved_tensors
        grads = crnn_log_amp_bwd(tuple(weights), samples, g_re.contiguous(),
                                 g_im.contiguous(), ctx.u1, replay=ctx.replay)
        return (None, None, *grads)


def log_amp_parts(weights: Weights, samples: torch.Tensor, u1: bool):
    """Differentiable (Re, Im) log psi through the kernels; under
    ``torch.no_grad`` B7 alone (a Function's forward sees its inputs'
    ``requires_grad``, not the grad mode)."""
    if not torch.is_grad_enabled():
        return crnn_log_amp_parts(weights, samples, u1)
    return CRNNLogAmpParts.apply(u1, samples, *weights)


# ---------------------------------------------------------------------------
# B8: the stand-alone sampler
# ---------------------------------------------------------------------------

@torch.no_grad()
def sample_plain(weights: Weights, uniforms: torch.Tensor, u1: bool):
    """The sampling site loop on given (B, N) uniforms: (samples (B, N)
    int32, log |psi|^2 = 2 Re log psi (B,))."""
    spins, re, _ = base_pass_plain(weights, u1, uniforms=uniforms)
    return spins.to(torch.int32), 2.0 * re


@counts_launches()
def crnn_sample(weights: Weights, num_samples: int, n_sites: int, seed: int, offset: int,
                u1: bool):
    """B8: draw ``num_samples`` chains of ``n_sites`` spins from |psi|^2 (a
    masked class never drawn) and their log |psi|^2.  ``(seed, offset)``
    (each in [0, 2^32)) keys the kernel's Philox generator, whose draws are
    B11's for the same key.  Returns (samples (B, N) int32, log |psi|^2
    (B,))."""
    draw = begin_draw(weights, num_samples, (n_sites,), seed, offset, CRNN_FAMILY,
                      check_crnn_weights)
    if draw.uniforms is not None:
        return sample_plain(weights, draw.uniforms, u1)
    lp = torch.empty(num_samples, dtype=torch.float32, device=draw.samples.device)
    launch("rnnwf_crnn_sample", lp.device, seed, offset, *weights, draw.samples, lp,
           num_samples, n_sites, draw.u, int(u1))
    return draw.samples, lp
