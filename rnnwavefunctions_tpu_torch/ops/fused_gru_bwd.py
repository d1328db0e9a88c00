"""K2: the VJP of sum_b g_b log p(sigma_b) with respect to the GRU weights.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_gru_bwd.py::gru_log_prob_bwd``.
The CUDA kernel runs in three stages (``csrc/fused_gru_bwd.cu``): (a) the
forward replay, K1's base pass storing the states and inputs as the rows
of a matrix A, the gates and the head's probabilities (``fused_gru.Replay``;
skipped when the caller hands one over, as ``GRULogProb`` does); (b) the
reverse sweep, one 3U x U product per site, writing the gate and head
cotangents as the rows of a matrix C (``Reverse``); (c) the weight
cotangent as the one product A^T C over the (sample, site) rows, in
chunks of ``CHUNK_ROWS`` rows summed in chunk order.  The
plain version is autograd through the plain K1 loop
(``fused_gru.log_prob_bwd_plain``); ``log_prob_bwd_staged_plain`` does the
three stages with tensor ops in the kernel's reduction order, for the
checks of the stages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .build import load_library
from .fused_gru import Replay, launch_replay, log_prob_bwd_plain, replay_plain
from .launch import (
    Weights,
    check_chains,
    check_float32,
    counts_launches,
    is_cpu_call,
    launch,
)

# rows of the weight-cotangent product per block of stage c (kChunkRows in
# csrc/fused_gru_bwd.cu), and the k-slices of the reverse sweep's product
# (kSlices in csrc/gru_common.cuh)
CHUNK_ROWS = 512
SLICES = 4


class Reverse(NamedTuple):
    """The reverse sweep's output (stage b): C's rows of the weight
    cotangent, (B, N + 1, 4U + 1) [dgh_n | dac_n | dl1_{n-1}] with dgh =
    [da_r | da_z | dac r] and dl1 = g (s - p1), the cotangent of logit 1;
    zero at n = N but dl1, and dl1 zero at n = 0."""

    cot: torch.Tensor

    @property
    def da(self) -> torch.Tensor:
        """(B, N, 3U) [da_r | da_z | dac], the input gates' cotangent."""
        u = (self.cot.shape[2] - 1) // 4
        return torch.cat([self.cot[:, :-1, : 2 * u], self.cot[:, :-1, 3 * u : 4 * u]], dim=2)

    @property
    def dl1(self) -> torch.Tensor:
        """(B, N) g (s_n - p1_n)."""
        return self.cot[:, 1:, -1]


# ---------------------------------------------------------------------------
# the staged plain version
# ---------------------------------------------------------------------------

def sweep_plain(wh: torch.Tensor, gates: torch.Tensor, hp: torch.Tensor,
                top: torch.Tensor) -> torch.Tensor:
    """Stage b's recursion for T trajectories, in the kernel's order: per
    site from the last, the gate cotangents from the stored gates (T, N, 4U)
    ``[r | z | c | ghc]``, the states h_{n-1} ``hp`` (T, N, U) and the
    heads' (or given) cotangent on h_n ``top`` (T, N, U) (math in
    fused_gru_bwd.py:29-39 of the JAX package); then dh_{n-1} = dht z +
    W_h dgh with the sum split as the kernel's threads split it: slice k
    takes the k-th of SLICES quarters of each gate's U columns, adds the r,
    z and c parts in that order, and the slices are added in order.  Returns
    C's gate columns (T, N, 4U) ``[da_r | da_z | dac r | dac]``."""
    t, n, u = hp.shape
    wht = wh.T
    kc = -(-u // SLICES)
    quarters = [slice(k * kc, min(u, (k + 1) * kc)) for k in range(SLICES)]

    def part(dgh, k):
        gates = [slice(g * u + quarters[k].start, g * u + quarters[k].stop) for g in range(3)]
        return (dgh[:, gates[0]] @ wht[gates[0]] + dgh[:, gates[1]] @ wht[gates[1]]
                + dgh[:, gates[2]] @ wht[gates[2]])

    dh = torch.zeros(t, u, dtype=torch.float32, device=hp.device)
    out = torch.empty(t, n, 4 * u, dtype=torch.float32, device=hp.device)
    for i in reversed(range(n)):
        r, z, c, ghc = gates[:, i].split(u, dim=1)
        dht = dh + top[:, i]
        dz = dht * (hp[:, i] - c)
        dc = dht * (1.0 - z)
        dac = dc * (1.0 - c * c)
        dr = dac * ghc
        dar = dr * r * (1.0 - r)
        daz = dz * z * (1.0 - z)
        dgh = torch.cat([dar, daz, dac * r], dim=1)
        out[:, i] = torch.cat([dgh, dac], dim=1)
        if i > 0:
            acc = part(dgh, 0)
            for k in range(1, SLICES):
                acc = acc + part(dgh, k)
            dh = dht * z + acc
    return out


def reverse_plain(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
                  replay: Replay) -> Reverse:
    """Stage b: ``sweep_plain`` seeded by the head, dl1 = g (s - p1) through
    ``hw[:, 1] - hw[:, 0]``, and C's rows around it."""
    wh, hw = weights[1], weights[4]
    b, n, u = replay.hist.shape
    d1 = g[:, None] * (samples.to(torch.float32) - replay.p1)
    top = (hw[:, 1] - hw[:, 0]) * d1[..., None]
    cot = torch.zeros(b, n + 1, 4 * u + 1, dtype=torch.float32, device=samples.device)
    cot[:, :n, : 4 * u] = sweep_plain(wh, replay.gates, replay.rows[:, :n, :u], top)
    cot[:, 1:, 4 * u] = d1
    return Reverse(cot)


def weight_cotangent_plain(replay: Replay, rev: Reverse,
                           chunk_rows: int = CHUNK_ROWS) -> Tuple[torch.Tensor, ...]:
    """Stage c: G = A^T C over the B (N + 1) rows (b, n), n = 0..N, of
    ``replay.rows`` (A) and ``rev.cot`` (C), summed over chunks of
    ``chunk_rows`` rows in chunk order; returns the six weight gradients
    read off G."""
    u = replay.gates.shape[2] // 4
    g_sum = chunked_product(replay.rows, rev.cot, chunk_rows)
    head = g_sum[: u + 1, 4 * u]
    dhw = torch.stack([-head[:u], head[:u]], dim=1)
    dhb = torch.stack([-head[u], head[u]])
    return (*trunk_grads(g_sum, u), dhw, dhb)


def chunked_product(rows: torch.Tensor, cot: torch.Tensor,
                    chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """G = A^T C over the (sample, site) rows of A ``rows`` (B, N + 1, U + 3)
    and C ``cot`` (B, N + 1, columns), summed over chunks of ``chunk_rows``
    rows in chunk order, as stage c sums it."""
    a = rows.reshape(-1, rows.shape[-1])
    c = cot.reshape(-1, cot.shape[-1])
    g_sum = torch.zeros(a.shape[1], c.shape[1], dtype=torch.float32, device=a.device)
    for start in range(0, a.shape[0], chunk_rows):
        g_sum = g_sum + a[start : start + chunk_rows].T @ c[start : start + chunk_rows]
    return g_sum


def trunk_grads(g_sum: torch.Tensor, u: int) -> Tuple[torch.Tensor, ...]:
    """The GRU layer's (dwx, dwh, dbx, dbh) read off G: rows h and 1
    against ``[da_r | da_z | dac r]`` give W_h and b_h, rows 1, 1 - s and s
    against ``[da_r | da_z | dac]`` give b_x and W_x."""
    dwh, dbh = g_sum[:u, : 3 * u], g_sum[u, : 3 * u]
    dbx = torch.cat([g_sum[u, : 2 * u], g_sum[u, 3 * u : 4 * u]])
    dwx = torch.cat([g_sum[u + 1 :, : 2 * u], g_sum[u + 1 :, 3 * u : 4 * u]], dim=1)
    return dwx, dwh, dbx, dbh


def log_prob_bwd_stages_plain(weights: Weights, samples: torch.Tensor, g: torch.Tensor):
    """The three stages with tensor ops: (gradients, Replay, Reverse)."""
    replay = replay_plain(weights, samples)
    rev = reverse_plain(weights, samples, g, replay)
    return weight_cotangent_plain(replay, rev), replay, rev


def log_prob_bwd_staged_plain(weights: Weights, samples: torch.Tensor,
                              g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The VJP by the kernel's three stages, in its reduction order."""
    return log_prob_bwd_stages_plain(weights, samples, g)[0]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@counts_launches()
def gru_log_prob_bwd(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
                     replay: Optional[Replay] = None) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(g * log p(samples)) for the six weights, in their
    shapes.  ``replay``: K1's stored replay of these weights and samples
    (``fused_gru.gru_log_prob(..., store=True)``), which saves stage a."""
    if is_cpu_call(samples, g, *weights):
        return tuple(log_prob_bwd_plain(weights, samples, g))
    return _launch(weights, samples, g, replay)[0]


@counts_launches(gru_log_prob_bwd)
def gru_log_prob_bwd_stages(weights: Weights, samples: torch.Tensor, g: torch.Tensor):
    """K2 with its stages' outputs, for the checks: (gradients, Replay,
    Reverse); on CPU tensors the staged plain version's."""
    if is_cpu_call(samples, g, *weights):
        return log_prob_bwd_stages_plain(weights, samples, g)
    return _launch(weights, samples, g, None)


def _checked(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
             replay: Optional[Replay]) -> Tuple[int, int, int, Replay]:
    """(B, N, U, replay) after the argument checks of stages b and c; runs
    stage a when no replay is handed over."""
    b, n, u = check_chains(weights, samples)
    check_float32("cotangent", (g,), ((b,),), samples.device)
    if replay is None:
        return b, n, u, launch_replay(weights, samples)
    check_float32("K2's replay tensor", (replay.rows, replay.gates, replay.p1),
                  ((b, n + 1, u + 3), (b, n, 4 * u), (b, n)), samples.device)
    return b, n, u, replay


def launch_reverse(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
                   replay: Optional[Replay] = None) -> Tuple[Replay, Reverse]:
    """Stages a (unless ``replay`` is given) and b alone on CUDA tensors:
    (Replay, Reverse).  B17 runs it with g = 1 (``fused_jac.jac_sweep``;
    the caller counts the launch)."""
    b, n, u, replay = _checked(weights, samples, g, replay)
    rev = Reverse(torch.empty(b, n + 1, 4 * u + 1, dtype=torch.float32, device=samples.device))
    launch("rnnwf_gru_bwd_sweep", samples.device, samples, g, weights[1], weights[4],
           replay.rows, replay.gates, replay.p1, rev.cot, b, n, u)
    return replay, rev


def _launch(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
            replay: Optional[Replay]):
    b, n, u, replay = _checked(weights, samples, g, replay)
    dev = samples.device
    sizes = [w.numel() for w in weights]
    rev = Reverse(torch.empty(b, n + 1, 4 * u + 1, dtype=torch.float32, device=dev))
    partial = torch.empty(load_library().lib.rnnwf_gru_bwd_partial_floats(b, n, u),
                          dtype=torch.float32, device=dev)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    launch("rnnwf_gru_log_prob_bwd", dev, samples, g, weights[1], weights[4], replay.rows,
           replay.gates, replay.p1, rev.cot, partial, flat, b, n, u)
    grads = tuple(part.view(w.shape) for part, w in zip(torch.split(flat, sizes), weights))
    return grads, replay, rev
