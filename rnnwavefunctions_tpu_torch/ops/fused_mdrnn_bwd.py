"""B14: the VJP of sum_b g_b log p(sigma_b) with respect to the MDRNN's cell
and head weights.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_mdrnn_bwd.py::mdrnn_log_prob_bwd``.
The CUDA kernel runs in K2's three stages (``csrc/fused_mdrnn_bwd.cu``): (1)
the replay, B12 storing the cell-output history and the head's p(s = 1)
(``fused_mdrnn.Replay``; skipped when the caller hands one over, as
``MDRNNLogProb`` does); (2) the reverse sweep, the two recurrent products of
each site split over four k-slices, writing the rows C = [dpre | dl1];
(3) the weight cotangent as one product A^T C over the
(sample, site) rows, A = [h_h | h_v | sh onehot(x_h) | sv onehot(x_v) | 1]
gathered from the history, plus the head's h^T dl1, in chunks of
``CHUNK_ROWS`` rows summed in chunk order.  The plain version is autograd
through the plain sweep (``fused_mdrnn.log_prob_bwd_plain``);
``log_prob_bwd_staged_plain`` does the three stages with tensor ops in the
kernel's reduction order, for the checks of the stages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import load_library
from .fused_mdrnn import (
    Replay,
    check_lattices,
    launch_replay,
    log_prob_bwd_plain,
    replay_plain,
    visit_order,
)
from .launch import Weights, check_float32, counts_launches, is_cpu_call, launch

# rows of the weight-cotangent product per block of stage 3 (kMChunkRows in
# csrc/fused_mdrnn_bwd.cu), and the k-slices of the reverse sweep's products
# (kSlices in csrc/gru_common.cuh)
CHUNK_ROWS = 512
SLICES = 4


# ---------------------------------------------------------------------------
# the staged plain version
# ---------------------------------------------------------------------------

def _sliced(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(W d)[j] = sum_i W[j, i] d[i] for each row of d (B, U), the sum split
    as the kernel's threads split it: slice k takes the k-th of SLICES
    quarters of i, and the slices are added in order."""
    u = w.shape[0]
    kc = -(-u // SLICES)
    acc = None
    for k in range(SLICES):
        q = slice(k * kc, min(u, (k + 1) * kc))
        part = d[:, q] @ w[:, q].T
        acc = part if acc is None else acc + part
    return acc


def reverse_plain(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
                  replay: Replay) -> torch.Tensor:
    """Stage 2: C's rows, (B, NS, U + 1) [dpre_m | dl1_m] in visit order.
    Per visit position from the last (math in fused_mdrnn_bwd.py:12-20 of
    the JAX package), dl1 = g (s - p1), dh = (hw[:,1] - hw[:,0]) dl1 + the
    horizontal carry + the column buffer, dpre = dh elu'(h); then the carry
    to m-1, Wh dpre (k > 0), and the column buffer for the site above, Wv
    dpre (y > 0)."""
    _, _, wh, wv, _, hw, _ = weights
    b, nx, ny = samples.shape
    u, dev = wh.shape[0], samples.device
    xx, yy = visit_order(nx, ny)
    spins_v = samples[:, xx, yy].to(torch.float32)
    hwd = hw[:, 1] - hw[:, 0]
    dhc = torch.zeros(b, u, dtype=torch.float32, device=dev)
    col = torch.zeros(b, nx, u, dtype=torch.float32, device=dev)
    cot = torch.zeros(b, nx * ny, u + 1, dtype=torch.float32, device=dev)
    for m in reversed(range(nx * ny)):
        y, k, x = m // nx, m % nx, int(xx[m])
        h = replay.hist[:, m]
        dl1 = g * (spins_v[:, m] - replay.p1[:, m])
        dh = hwd * dl1[:, None]
        if k < nx - 1:
            dh = dh + dhc
        if y < ny - 1:
            dh = dh + col[:, x]
        dp = dh * torch.where(h > 0, 1.0, h + 1.0)
        cot[:, m, :u] = dp
        cot[:, m, u] = dl1
        dhc = _sliced(wh, dp) if k > 0 else torch.zeros_like(dhc)
        if y > 0:
            col[:, x] = _sliced(wv, dp)
    return cot


def a_rows_plain(samples: torch.Tensor, replay: Replay) -> torch.Tensor:
    """(B, NS, 2U + 5) the rows of A the weight cotangent gathers, in visit
    order: [h_h | h_v | sh (1 - x_h) | sh x_h | sv (1 - x_v) | sv x_v | 1],
    with h_h = h_{m-1} and x_h its spin where k > 0 (sh = 1), h_v =
    h_{m-2k-1} and x_v its spin where y > 0 (sv = 1), zeros elsewhere."""
    b, nx, ny = samples.shape
    ns = nx * ny
    u = replay.hist.shape[2]
    xx, yy = visit_order(nx, ny)
    spins_v = samples[:, xx, yy].to(torch.float32)
    a = torch.zeros(b, ns, 2 * u + 5, dtype=torch.float32, device=samples.device)
    for m in range(ns):
        y, k = m // nx, m % nx
        if k > 0:
            a[:, m, :u] = replay.hist[:, m - 1]
            a[:, m, 2 * u] = 1.0 - spins_v[:, m - 1]
            a[:, m, 2 * u + 1] = spins_v[:, m - 1]
        if y > 0:
            a[:, m, u:2 * u] = replay.hist[:, m - 2 * k - 1]
            a[:, m, 2 * u + 2] = 1.0 - spins_v[:, m - 2 * k - 1]
            a[:, m, 2 * u + 3] = spins_v[:, m - 2 * k - 1]
    a[:, :, 2 * u + 4] = 1.0
    return a


def weight_cotangent_plain(samples: torch.Tensor, replay: Replay, cot: torch.Tensor,
                           chunk_rows: int = CHUNK_ROWS) -> Tuple[torch.Tensor, ...]:
    """Stage 3: G = A^T C and the head's h^T dl1 over the B NS rows (b, m),
    summed over chunks of ``chunk_rows`` rows in chunk order; returns the
    seven weight gradients read off them."""
    u = replay.hist.shape[2]
    a = a_rows_plain(samples, replay).reshape(-1, 2 * u + 5)
    c = cot.reshape(-1, u + 1)
    h = replay.hist.reshape(-1, u)
    g_sum = torch.zeros(2 * u + 5, u + 1, dtype=torch.float32, device=a.device)
    head = torch.zeros(u, dtype=torch.float32, device=a.device)
    for start in range(0, a.shape[0], chunk_rows):
        rows = slice(start, start + chunk_rows)
        g_sum = g_sum + a[rows].T @ c[rows]
        head = head + h[rows].T @ c[rows, u]
    duh, duv = g_sum[2 * u:2 * u + 2, :u], g_sum[2 * u + 2:2 * u + 4, :u]
    dwh, dwv, db = g_sum[:u, :u], g_sum[u:2 * u, :u], g_sum[2 * u + 4, :u]
    dhw = torch.stack([-head, head], dim=1)
    dhb = torch.stack([-g_sum[2 * u + 4, u], g_sum[2 * u + 4, u]])
    return duh, duv, dwh, dwv, db, dhw, dhb


def log_prob_bwd_stages_plain(weights: Weights, samples: torch.Tensor, g: torch.Tensor):
    """The three stages with tensor ops: (gradients, Replay, C)."""
    replay = replay_plain(weights, samples)
    cot = reverse_plain(weights, samples, g, replay)
    return weight_cotangent_plain(samples, replay, cot), replay, cot


def log_prob_bwd_staged_plain(weights: Weights, samples: torch.Tensor,
                              g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The VJP by the kernel's three stages, in its reduction order."""
    return log_prob_bwd_stages_plain(weights, samples, g)[0]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@counts_launches()
def mdrnn_log_prob_bwd(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
                       replay: Optional[Replay] = None) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(g * log p(samples)) for the seven weights (uh, uv,
    wh, wv, b, head w, head b), in their shapes (the JAX layout).
    ``replay``: B12's stored replay of these weights and samples
    (``fused_mdrnn.mdrnn_log_prob(..., store=True)``), which saves stage 1."""
    if is_cpu_call(samples, g, *weights):
        return tuple(log_prob_bwd_plain(weights, samples, g))
    return _launch(weights, samples, g, replay)[0]


@counts_launches(mdrnn_log_prob_bwd)
def mdrnn_log_prob_bwd_stages(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
                              replay: Optional[Replay] = None):
    """B14 with its stages' outputs (gradients, Replay, C), for the stage
    checks alone, as ``fused_gru_bwd.gru_log_prob_bwd_stages`` is for K2; the
    main path calls ``mdrnn_log_prob_bwd``.  On CPU tensors the staged plain
    version's."""
    if is_cpu_call(samples, g, *weights):
        return log_prob_bwd_stages_plain(weights, samples, g)
    return _launch(weights, samples, g, replay)


def _checked(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
             replay: Optional[Replay]) -> Tuple[int, int, int, int, Replay]:
    """(B, Nx, Ny, U, replay) after the argument checks of stages 2 and 3;
    runs stage 1 when no replay is handed over."""
    b, nx, ny, u = check_lattices(weights, samples)
    check_float32("cotangent", (g,), ((b,),), samples.device)
    if replay is None:
        return b, nx, ny, u, launch_replay(weights, samples)
    check_float32("B14's replay tensor", (replay.hist, replay.p1),
                  ((b, nx * ny, u), (b, nx * ny)), samples.device)
    return b, nx, ny, u, replay


def _launch(weights: Weights, samples: torch.Tensor, g: torch.Tensor,
            replay: Optional[Replay]):
    b, nx, ny, u, replay = _checked(weights, samples, g, replay)
    dev = samples.device
    sizes = [w.numel() for w in weights]
    cot = torch.empty(b, nx * ny, u + 1, dtype=torch.float32, device=dev)
    partial = torch.empty(load_library().lib.rnnwf_mdrnn_bwd_partial_floats(b, nx * ny, u),
                          dtype=torch.float32, device=dev)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    launch("rnnwf_mdrnn_log_prob_bwd", dev, samples, g, weights[2], weights[3], weights[5],
           replay.hist, replay.p1, cot, partial, flat, b, nx, ny, u)
    grads = tuple(part.view(w.shape) for part, w in zip(torch.split(flat, sizes), weights))
    return grads, replay, cot
