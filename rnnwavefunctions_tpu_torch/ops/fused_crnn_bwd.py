"""B9: the VJP of sum_b (g_re[b] Re log psi_b + g_im[b] Im log psi_b) with
respect to the weights of the single-layer U(1) cRNN.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_crnn_bwd.py::crnn_log_amp_bwd``.
The CUDA kernel runs in K2's three stages (``csrc/fused_crnn_bwd.cu``): (a)
the forward replay, B10's base pass storing K2's A rows, the gates and the
two heads' seeds (``fused_crnn.CReplay``; skipped when the caller hands one
over, as ``CRNNLogAmpParts`` does); (b) K2's reverse sweep seeded by both
heads, one 3U x U product per site, writing the gate and head cotangents as
the rows of a matrix C (``CReverse``); (c) the weight cotangent A^T C over
the (sample, site) rows in chunks summed in chunk order.  The plain version
is autograd through the plain B7 loop (``log_amp_bwd_plain``);
``log_amp_bwd_staged_plain`` does the three stages with tensor ops in the
kernel's reduction order, for the checks of the stages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .build import load_library
from .fused_crnn import CReplay, launch_replay, log_amp_parts_plain, replay_plain
from .fused_gru_bwd import CHUNK_ROWS, chunked_product, sweep_plain, trunk_grads
from .launch import (
    CRNN_FAMILY,
    Weights,
    check_chains,
    check_float32,
    counts_launches,
    is_cpu_call,
    launch,
)


class CReverse(NamedTuple):
    """The reverse sweep's output (stage b): C's rows (B, N + 1, 4U + 3)
    ``[da_r | da_z | dac r | dac | dd | dq0 | dq1]``, the head columns in
    row n + 1: dd = g_re a_n, the cotangent of the amplitude logits'
    difference l0 - l1, and g_im q_n in the target's phase column; zero at
    n = N but the head columns, which are zero at n = 0."""

    cot: torch.Tensor

    @property
    def heads(self) -> torch.Tensor:
        """(B, N, 3) ``[dd | dq0 | dq1]`` of site n."""
        return self.cot[:, 1:, -3:]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def log_amp_bwd_plain(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor,
                      g_im: torch.Tensor, u1: bool):
    """Autograd through ``log_amp_parts_plain``; returns the weight
    gradients."""
    with torch.enable_grad():
        ws = [w.detach().requires_grad_(True) for w in weights]
        re, im = log_amp_parts_plain(ws, samples, u1)
        return torch.autograd.grad((re, im), ws, grad_outputs=(g_re, g_im))


def reverse_plain(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor,
                  g_im: torch.Tensor, replay: CReplay) -> CReverse:
    """Stage b: K2's ``sweep_plain`` seeded by both heads, dtop = (aw[:, 0]
    - aw[:, 1]) g_re a_n + pw[:, s_n] g_im q_n, and C's rows around it."""
    wh, aw, pw = weights[1], weights[4], weights[6]
    b, n, u = replay.hist.shape
    one = samples[..., None] > 0
    dd = g_re[:, None] * replay.seeds[..., 0]
    dq = g_im[:, None] * replay.seeds[..., 1]
    top = ((aw[:, 0] - aw[:, 1]) * dd[..., None]
           + torch.where(one, pw[:, 1], pw[:, 0]) * dq[..., None])
    cot = torch.zeros(b, n + 1, 4 * u + 3, dtype=torch.float32, device=samples.device)
    cot[:, :n, : 4 * u] = sweep_plain(wh, replay.gates, replay.rows[:, :n, :u], top)
    zero = torch.zeros_like(dq)
    cot[:, 1:, 4 * u :] = torch.stack([dd, torch.where(one[..., 0], zero, dq),
                                       torch.where(one[..., 0], dq, zero)], dim=-1)
    return CReverse(cot)


def weight_cotangent_plain(replay: CReplay, rev: CReverse,
                           chunk_rows: int = CHUNK_ROWS) -> Tuple[torch.Tensor, ...]:
    """Stage c: G = A^T C summed over chunks of ``chunk_rows`` rows in chunk
    order; returns the eight weight gradients read off G (the amplitude
    head against (dd, -dd), the phase head against (dq0, dq1))."""
    u = replay.gates.shape[2] // 4
    g_sum = chunked_product(replay.rows, rev.cot, chunk_rows)
    dd, dq = g_sum[: u + 1, 4 * u], g_sum[: u + 1, 4 * u + 1 :]
    return (*trunk_grads(g_sum, u), torch.stack([dd[:u], -dd[:u]], dim=1),
            torch.stack([dd[u], -dd[u]]), dq[:u], dq[u])


def log_amp_bwd_stages_plain(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor,
                             g_im: torch.Tensor, u1: bool):
    """The three stages with tensor ops: (gradients, CReplay, CReverse)."""
    replay = replay_plain(weights, samples, u1)
    rev = reverse_plain(weights, samples, g_re, g_im, replay)
    return weight_cotangent_plain(replay, rev), replay, rev


def log_amp_bwd_staged_plain(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor,
                             g_im: torch.Tensor, u1: bool) -> Tuple[torch.Tensor, ...]:
    """The VJP by the kernel's three stages, in its reduction order."""
    return log_amp_bwd_stages_plain(weights, samples, g_re, g_im, u1)[0]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@counts_launches()
def crnn_log_amp_bwd(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor,
                     g_im: torch.Tensor, u1: bool,
                     replay: Optional[CReplay] = None) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(g_re * Re + g_im * Im) for the eight weights, in
    their shapes.  ``replay``: B9's replay of these weights and samples
    (``fused_crnn.crnn_replay``), which saves stage a."""
    if is_cpu_call(samples, g_re, g_im, *weights):
        return tuple(log_amp_bwd_plain(weights, samples, g_re, g_im, u1))
    return _launch(weights, samples, g_re, g_im, u1, replay)[0]


@counts_launches(crnn_log_amp_bwd)
def crnn_log_amp_bwd_stages(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor,
                            g_im: torch.Tensor, u1: bool):
    """B9 with its stages' outputs, for the checks: (gradients, CReplay,
    CReverse); on CPU tensors the staged plain version's."""
    if is_cpu_call(samples, g_re, g_im, *weights):
        return log_amp_bwd_stages_plain(weights, samples, g_re, g_im, u1)
    return _launch(weights, samples, g_re, g_im, u1, None)


def _launch(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor, g_im: torch.Tensor,
            u1: bool, replay: Optional[CReplay]):
    b, n, u = check_chains(weights, samples, CRNN_FAMILY, heads=2)
    dev = samples.device
    check_float32("cotangent", (g_re, g_im), ((b,), (b,)), dev)
    if replay is None:
        replay = launch_replay(weights, samples, u1)
    else:
        check_float32("B9's replay tensor", (replay.rows, replay.gates, replay.seeds),
                      ((b, n + 1, u + 3), (b, n, 4 * u), (b, n, 2)), dev)
    sizes = [w.numel() for w in weights]
    rev = CReverse(torch.empty(b, n + 1, 4 * u + 3, dtype=torch.float32, device=dev))
    partial = torch.empty(load_library().lib.rnnwf_crnn_bwd_partial_floats(b, n, u),
                          dtype=torch.float32, device=dev)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    launch("rnnwf_crnn_log_amp_bwd", dev, samples, g_re, g_im, weights[1], weights[4],
           weights[6], replay.rows, replay.gates, replay.seeds, rev.cot, partial, flat, b, n, u)
    grads = tuple(part.view(w.shape) for part, w in zip(torch.split(flat, sizes), weights))
    return grads, replay, rev
