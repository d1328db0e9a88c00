"""B17, B19, B20: the per-sample jacobian sweeps of minSR, and the
contractions that turn their outputs into per-sample weight rows.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_jac.py`` for one GRU layer:

* B17 ``jac_sweep`` (the JAX ``jac_sweep`` and its spill variant B18, which
  differ only in where the TPU kernel kept its outputs) runs K2's replay and
  reverse sweep (``csrc/tfim_flip.cu``, ``csrc/fused_gru_bwd.cu``) with the
  cotangent g = 1 for every sample and without K2's sum over samples; it
  returns ``JacSweep``: log p and the per-(sample, site) rows of K2's
  matrices A and C, from which the JAX outputs ``(hist, dg, dl1)`` are
  read column for column;
* B19 ``rollout_hist``: the cRNN's forward replay alone, ``hist`` and,
  storing, each site's gates;
* B20 ``sweep_dgates``: K2's reverse sweep seeded by P cotangent sets on the
  hidden states (the cRNN's Re and Im parts) from B19's stored gates,
  ``dg`` per part, one launch (``csrc/fused_gru_bwd.cu``, two parts of one
  sample a block).
  B19 is in ``csrc/fused_jac.cu``, with B20's entry point.

Layouts are sample-major: ``hist`` (S, N, U) holds the post-step state h_n,
``dg`` (S, N, 4U) the gate cotangents ``[da_r | da_z | da_c | dgh_c]`` (the
input pre-activations' ``da`` and, sharing its first 2U entries, the
recurrent ones ``[da_r | da_z | dgh_c]``), ``dl1`` (S, N) the head's
``s_n - sigmoid(l1 - l0)``.  Each per-sample weight row is then one batched
matrix product with the sample as the batch (``prnn1d_rows``: A_s^T C_s;
``trunk_rows_from_sweep`` for the cRNN), left to the library as the JAX
package leaves them to XLA.

Every wrapper runs its plain version for CPU tensors and launches its
kernels for CUDA tensors, counting calls in ``launches``.  The plain
versions are the same site loops written with tensor ops (B17's are K2's
staged plain stages a and b).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fused_gru import gru_gates, replay_plain, spin_input
from .fused_gru_bwd import launch_reverse, reverse_plain, sweep_plain
from .launch import (
    CRNN_FAMILY,
    Weights,
    check_chains,
    check_float32,
    counts_launches,
    is_cpu_call,
    launch,
)


class JacSweep(NamedTuple):
    """B17's output: the joint log p and K2's rows per (sample, site) with
    g = 1, A (B, N + 1, U + 3) ``[h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}]`` and
    C (B, N + 1, 4U + 1) ``[da_r | da_z | dac r | dac | dl1_{n-1}]``
    (``fused_gru.Replay``, ``fused_gru_bwd.Reverse``)."""

    lp: torch.Tensor
    rows: torch.Tensor
    cot: torch.Tensor

    @property
    def hist(self) -> torch.Tensor:
        """(B, N, U) the states h_n."""
        return self.rows[:, 1:, : self.rows.shape[2] - 3]

    @property
    def dg(self) -> torch.Tensor:
        """(B, N, 4U) ``[da_r | da_z | da_c | dgh_c]``, the JAX kernel's order."""
        u = self.rows.shape[2] - 3
        c = self.cot[:, :-1]
        return torch.cat([c[..., : 2 * u], c[..., 3 * u : 4 * u], c[..., 2 * u : 3 * u]], dim=-1)

    @property
    def dl1(self) -> torch.Tensor:
        """(B, N) s_n - p(s_n = 1)."""
        return self.cot[:, 1:, -1]

# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def rollout_hist_plain(trunk: Weights, samples: torch.Tensor, store: bool = False):
    """Teacher-forced GRU rollout of (B, N) spins from the zero state:
    ``hist`` (B, N, U), the state after each site; with ``store``, ``(hist,
    gates)``, gates (B, N, 4U) ``[r | z | c | ghc]`` of each site."""
    wx, wh, bx, bh = trunk
    b, n = samples.shape
    s = samples.to(torch.float32)
    h = torch.zeros(b, wh.shape[0], dtype=torch.float32, device=samples.device)
    x = torch.zeros(b, dtype=torch.float32, device=samples.device)
    hist, gates = [], []
    for i in range(n):
        r, z, c, ghc = gru_gates(spin_input(wx, bx, x, 1.0 if i > 0 else 0.0), h, wh, bh)
        h = z * h + (1.0 - z) * c
        hist.append(h)
        gates.append(torch.cat([r, z, c, ghc], dim=1))
        x = s[:, i]
    if store:
        return torch.stack(hist, dim=1), torch.stack(gates, dim=1)
    return torch.stack(hist, dim=1)


def sweep_dgates_plain(trunk: Weights, samples: torch.Tensor, hist: torch.Tensor,
                       douts: torch.Tensor) -> torch.Tensor:
    """The reverse sweep for P cotangent sets ``douts`` (P, B, N, U) on the
    hidden states: ``dg`` (P, B, N, 4U), per site ``[da_r | da_z | da_c |
    dgh_c]``, with the gates recomputed from ``hist``."""
    wx, wh, bx, bh = trunk
    parts, b, n, u = douts.shape
    s = samples.to(torch.float32)
    zero_h = torch.zeros(b, u, dtype=torch.float32, device=samples.device)
    dh = torch.zeros(parts, b, u, dtype=torch.float32, device=samples.device)
    out = [None] * n
    for i in reversed(range(n)):
        hp = hist[:, i - 1] if i > 0 else zero_h
        x = s[:, i - 1] if i > 0 else zero_h[:, 0]
        gx = spin_input(wx, bx, x, 1.0 if i > 0 else 0.0)
        gh = hp @ wh + bh
        ghc = gh[:, 2 * u:]
        r = torch.sigmoid(gx[:, :u] + gh[:, :u])
        z = torch.sigmoid(gx[:, u:2 * u] + gh[:, u:2 * u])
        c = torch.tanh(gx[:, 2 * u:] + r * ghc)
        dht = dh + douts[:, :, i]
        dz = dht * (hp - c)
        dc = dht * (1.0 - z)
        dac = dc * (1.0 - c * c)
        dar = dac * ghc * r * (1.0 - r)
        daz = dz * z * (1.0 - z)
        dghc = dac * r
        out[i] = torch.cat([dar, daz, dac, dghc], dim=-1)
        dh = dht * z + torch.cat([dar, daz, dghc], dim=-1) @ wh.T
    return torch.stack(out, dim=2)


def sweep_stored_plain(trunk: Weights, hist: torch.Tensor, gates: torch.Tensor,
                       douts: torch.Tensor) -> torch.Tensor:
    """B20's route with tensor ops: K2's ``sweep_plain`` from the stored
    ``gates`` (B, N, 4U) and ``hist`` for each of the P cotangent sets
    ``douts`` (P, B, N, U), in the kernel's order: ``dg`` (P, B, N, 4U)
    ``[da_r | da_z | da_c | dgh_c]``."""
    parts, b, n, u = douts.shape
    hp = torch.cat([torch.zeros_like(hist[:, :1]), hist[:, :-1]], dim=1)
    cot = sweep_plain(trunk[1], gates.repeat(parts, 1, 1), hp.repeat(parts, 1, 1),
                      douts.reshape(parts * b, n, u)).view(parts, b, n, 4 * u)
    return torch.cat([cot[..., : 2 * u], cot[..., 3 * u :], cot[..., 2 * u : 3 * u]], dim=-1)


def jac_sweep_plain(weights: Weights, samples: torch.Tensor) -> JacSweep:
    """B17's function, K2's plain stages a and b with g = 1: the head's
    d log p_n / d l1 = s_n - sigmoid(l1 - l0) = -d log p_n / d l0 seeds the
    reverse sweep through ``hw[:, 1] - hw[:, 0]``."""
    replay = replay_plain(weights, samples)
    g = torch.ones(samples.shape[0], dtype=torch.float32, device=samples.device)
    return JacSweep(replay.lp, replay.rows, reverse_plain(weights, samples, g, replay).cot)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@counts_launches()
def jac_sweep(weights: Weights, samples: torch.Tensor) -> JacSweep:
    """B17: ``JacSweep`` of the pRNN's log p for (B, N) int32 samples and
    the 6-tuple of kernel weights: K2's replay, then its reverse sweep with
    g = 1."""
    if is_cpu_call(samples, *weights):
        return jac_sweep_plain(weights, samples)
    g = torch.ones(samples.shape[0], dtype=torch.float32, device=samples.device)
    replay, rev = launch_reverse(weights, samples, g)
    return JacSweep(replay.lp, replay.rows, rev.cot)


def _launch_rollout(trunk: Weights, samples: torch.Tensor, store: bool):
    """B19 on CUDA tensors (the callers count the launch): ``hist``, or with
    ``store`` ``(hist, gates)``."""
    b, n, u = check_chains(trunk, samples, CRNN_FAMILY, heads=0)
    hist = torch.empty(b, n, u, dtype=torch.float32, device=samples.device)
    gates = torch.empty(b, n, 4 * u, dtype=torch.float32, device=samples.device) if store else None
    launch("rnnwf_rollout_hist", samples.device, samples, *trunk, hist, gates, b, n, u)
    return (hist, gates) if store else hist


@counts_launches()
def rollout_hist(trunk: Weights, samples: torch.Tensor, store: bool = False):
    """B19: ``hist`` (B, N, U) for (B, N) int32 samples and the trunk
    (wx, wh, bx, bh); with ``store``, ``(hist, gates)``, the gates (B, N,
    4U) ``[r | z | c | ghc]`` that B20 starts from."""
    if is_cpu_call(samples, *trunk):
        return rollout_hist_plain(trunk, samples, store)
    return _launch_rollout(trunk, samples, store)


@counts_launches()
def sweep_dgates(trunk: Weights, samples: torch.Tensor, hist: torch.Tensor,
                 douts: torch.Tensor, gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B20: ``dg`` (P, B, N, 4U) for the cotangent sets ``douts`` (P, B, N, U)
    on the states ``hist`` (B, N, U), all parts in one launch.  ``gates``:
    B19's stored gates of these samples (``rollout_hist(..., store=True)``);
    without them B19 runs storing first."""
    tensors = (samples, hist, douts, *trunk) + (() if gates is None else (gates,))
    if is_cpu_call(*tensors):
        if gates is None:
            return sweep_dgates_plain(trunk, samples, hist, douts)
        return sweep_stored_plain(trunk, hist, gates, douts)
    b, n, u = check_chains(trunk, samples, CRNN_FAMILY, heads=0)
    parts = douts.shape[0] if douts.dim() == 4 else 0
    check_float32("B20's hist and douts", (hist, douts), ((b, n, u), (parts, b, n, u)),
                  samples.device)
    if parts < 1:
        raise ValueError("douts needs at least one part")
    if gates is None:
        _, gates = _launch_rollout(trunk, samples, True)
    else:
        check_float32("B20's replay tensor", (gates,), ((b, n, 4 * u),), samples.device)
    dg = torch.empty(parts, b, n, 4 * u, dtype=torch.float32, device=samples.device)
    launch("rnnwf_sweep_dgates", samples.device, samples, trunk[1], hist, gates, douts, dg,
           b, parts, n, u)
    return dg


# ---------------------------------------------------------------------------
# contractions: sweep outputs -> per-sample rows (library matrix products)
# ---------------------------------------------------------------------------


def input_onehot_rows(samples: torch.Tensor) -> torch.Tensor:
    """The layer's inputs (B, N, 2): the one-hot of the previous spin, zeros
    at site 0."""
    prev = samples[:, :-1].to(torch.float32)
    onehot = torch.stack([1.0 - prev, prev], dim=-1)
    return torch.cat([onehot.new_zeros(samples.shape[0], 1, 2), onehot], dim=1)


def trunk_rows_from_sweep(hist: torch.Tensor, dg: torch.Tensor, x0: torch.Tensor):
    """Per-sample rows of the GRU layer's weights from one sweep's ``hist``
    (B, N, U), ``dg`` (B, N, 4U) and inputs ``x0`` (B, N, 2), in the layout
    of the JAX package's ``{"wx", "wh", "bx", "bh"}``.  The recurrent
    weights see h_{n-1}, which is zero at site 0, so their products run over
    sites 1..N-1 of views, with no shifted copy."""
    u = hist.shape[-1]
    da, dghc = dg[..., :3 * u], dg[..., 3 * u:]
    hp = hist[:, :-1].transpose(1, 2)  # (B, U, N-1)
    return {
        "wx": x0.transpose(1, 2) @ da,
        "wh": torch.cat([hp @ da[:, 1:, :2 * u], hp @ dghc[:, 1:]], dim=-1),
        "bx": da.sum(dim=1),
        "bh": torch.cat([da[..., :2 * u].sum(dim=1), dghc.sum(dim=1)], dim=-1),
    }


def prnn1d_rows(weights: Weights, samples: torch.Tensor):
    """The single-layer pRNN's ``(log p (B,), per-sample rows of log p)``
    through one B17 call, the rows a tree ``{"rnn": [layer], "head": {"w",
    "b"}}`` of (B, ...) leaves (the JAX package's ``fused_jac.prnn1d_rows``).
    Each sample's rows are one product G_s = A_s^T C_s (U + 3, 4U + 1), read
    as K2's stage c reads its sum over samples: rows h and 1 against
    ``[da_r | da_z | dac r]`` give W_h and b_h, rows 1, 1 - s and s against
    ``[da_r | da_z | dac]`` give b_x and W_x, rows h and 1 against dl1 the
    head's second column (its first is the negative)."""
    sweep = jac_sweep(weights, samples)
    u = sweep.rows.shape[2] - 3
    gm = sweep.rows.transpose(1, 2) @ sweep.cot  # (B, U + 3, 4U + 1)
    dgh, dl1 = gm[..., : 3 * u], gm[..., 4 * u]
    da = torch.cat([dgh[..., : 2 * u], gm[..., 3 * u : 4 * u]], dim=-1)
    rows = {
        "rnn": [{"wx": da[:, u + 1 :], "wh": dgh[:, :u], "bx": da[:, u], "bh": dgh[:, u]}],
        "head": {"w": torch.stack([-dl1[:, :u], dl1[:, :u]], dim=-1),
                 "b": torch.stack([-dl1[:, u], dl1[:, u]], dim=-1)},
    }
    return sweep.lp, rows
