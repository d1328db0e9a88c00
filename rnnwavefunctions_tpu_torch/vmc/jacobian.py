"""Per-sample log-derivative rows (the minSR ``O`` matrix).

Counterpart of ``rnnwavefunctions_tpu/vmc/jacobian.py`` for GRU stacks (the
port has no LSTM yet).  A recurrent layer's per-sample weight rows
factorize through its per-step gate cotangents,

    O_Wx[s] = sum_t x_t[s] (x) dgx_t[s],    O_Wh[s] = sum_t h_{t-1}[s] (x) dgh_t[s],

so a forward rollout stashes every pre-step state, a reverse sweep emits
the gate cotangents (its carry is the (S, U) recurrence cotangent), and one
batched contraction per weight gives the rows.  Rows come back as trees in
the JAX package's parameter layout (``interop.py``) with (S, ...) leaves.

The plain rows below differentiate the cell's nonlinear step with
``torch.func.vjp``, as the JAX package does with ``jax.vjp``; they are the
oracle of the kernels.  When the ansatz runs its kernels (``resolve_impl``),
a single-layer pRNN takes B17 (``ops/fused_jac.prnn1d_rows``) and the cRNN
B19 and B20 (``_crnn_rows_fused``); the MDRNN's rows are plain PyTorch on
every device, as in the JAX package, which has no MDRNN jacobian kernel.
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

import torch
from torch import nn

from ..interop import tree_map
from ..ops import fused_jac

Layer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# the GRU stack: rollout, reverse sweep, contraction
# ---------------------------------------------------------------------------


def _gru_f(gx: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The reset-after GRU update with its two matmul pre-activations
    factored out."""
    u = h.shape[-1]
    r = torch.sigmoid(gx[..., :u] + gh[..., :u])
    z = torch.sigmoid(gx[..., u:2 * u] + gh[..., u:2 * u])
    c = torch.tanh(gx[..., 2 * u:] + r * gh[..., 2 * u:])
    return z * h + (1.0 - z) * c


def _layers(ansatz: Any) -> List[Layer]:
    return [tuple(getattr(layer, k).detach() for k in ("wx", "wh", "bx", "bh"))
            for layer in ansatz.rnn]


def _rollout(layers: Sequence[Layer], inputs: torch.Tensor):
    """Teacher-forced stack rollout over ``inputs`` (N, S, d).  Returns
    ``(prevs, finals, top_out)``: per layer the PRE-step state at every step
    (N, S, U), per layer the state after the last step, and the top layer's
    outputs (N, S, U)."""
    n, s = inputs.shape[:2]
    hs = [inputs.new_zeros(s, wh.shape[0]) for _, wh, _, _ in layers]
    prevs = [[] for _ in layers]
    top = []
    for t in range(n):
        inp = inputs[t]
        for l, (wx, wh, bx, bh) in enumerate(layers):
            prevs[l].append(hs[l])
            inp = _gru_f(inp @ wx + bx, hs[l] @ wh + bh, hs[l])
            hs[l] = inp
        top.append(inp)
    return [torch.stack(p) for p in prevs], hs, torch.stack(top)


def _layer_inputs(inputs: torch.Tensor, prevs, finals) -> List[torch.Tensor]:
    """Per-layer input sequences: the one-hot feed for layer 0, the layer
    below's POST-step output for l > 0 (its pre-step states shifted one
    step, closed with its final state)."""
    return [inputs] + [torch.cat([prev[1:], fin[None]]) for prev, fin in
                       zip(prevs[:-1], finals[:-1])]


def _bptt(layers: Sequence[Layer], xs, prevs, dout: torch.Tensor):
    """Reverse-time sweep producing per layer the gate cotangents
    ``(dgx, dgh)``, each (P, N, S, 3U), for the P cotangent sets ``dout``
    (P, N, S, U_top) on the top outputs that share one linearization."""
    parts, n = dout.shape[:2]
    carry = [dout.new_zeros(parts, dout.shape[2], wh.shape[0]) for _, wh, _, _ in layers]
    emitted = [[None] * n for _ in layers]
    for t in reversed(range(n)):
        d_above = dout[:, t]
        for l in reversed(range(len(layers))):
            wx, wh, bx, bh = layers[l]
            h_prev = prevs[l][t]
            _, vjp = torch.func.vjp(_gru_f, xs[l][t] @ wx + bx, h_prev @ wh + bh, h_prev)
            dgx, dgh, dh_direct = (torch.stack(g) for g in zip(*(
                vjp(d) for d in d_above + carry[l])))
            carry[l] = dh_direct + dgh @ wh.T
            emitted[l][t] = (dgx, dgh)
            if l:
                d_above = dgx @ wx.T
    return [tuple(torch.stack(g, dim=1) for g in zip(*per_t)) for per_t in emitted]


def _contract_layer(x: torch.Tensor, prev: torch.Tensor, dgx: torch.Tensor,
                    dgh: torch.Tensor):
    return {
        "wx": torch.einsum("tsi,tsg->sig", x, dgx),
        "wh": torch.einsum("tsu,tsg->sug", prev, dgh),
        "bx": dgx.sum(dim=0),
        "bh": dgh.sum(dim=0),
    }


def _head_rows(top: torch.Tensor, dlogits: torch.Tensor):
    return {"w": torch.einsum("tsu,tsd->sud", top, dlogits), "b": dlogits.sum(dim=0)}


def _chain_inputs(samples: torch.Tensor, d: int):
    """Site-major one-hots (N, S, d) of the targets and the inputs (zeros at
    site 0, then the previous one-hot)."""
    onehot = nn.functional.one_hot(samples.T.long(), d).to(torch.float32)
    return onehot, torch.cat([torch.zeros_like(onehot[:1]), onehot[:-1]])


# ---------------------------------------------------------------------------
# PRNN1D (plain, parity-symmetrized, snake-2D): rows of log p, then log psi
# ---------------------------------------------------------------------------


def _prnn1d_log_prob_rows(ansatz: Any, samples: torch.Tensor):
    """(log p (S,), per-sample rows of log p) of the plain autoregressive
    density; B17 when the ansatz runs its kernels."""
    if ansatz._use_kernels():
        return fused_jac.prnn1d_rows(tuple(w.detach() for w in ansatz.weights()), samples)
    layers = _layers(ansatz)
    hw, hb = ansatz.head.w.detach(), ansatz.head.b.detach()
    onehot, inputs = _chain_inputs(samples, ansatz.local_dim)
    prevs, finals, top = _rollout(layers, inputs)
    xs = _layer_inputs(inputs, prevs, finals)
    logp_site = torch.log_softmax(top @ hw + hb, dim=-1)
    log_prob = (onehot * logp_site).sum(dim=-1).sum(dim=0)
    # d site_logp / d logits = onehot(target) - softmax(logits)
    dlogits = onehot - torch.exp(logp_site)
    dgates = _bptt(layers, xs, prevs, (dlogits @ hw.T)[None])
    rows = {
        "rnn": [_contract_layer(x, pv, dgx[0], dgh[0])
                for x, pv, (dgx, dgh) in zip(xs, prevs, dgates)],
        "head": _head_rows(top, dlogits),
    }
    return log_prob, rows


def prnn1d_log_amp_rows(ansatz: Any, samples: torch.Tensor):
    """Per-sample rows of log psi = 0.5 log p for a PRNN1D (plain, parity or
    snake-2D).  For parity, d log((p + p_rev) / 2) = w d log p + (1 - w)
    d log p_rev with w = sigmoid(lp - lp_rev)."""
    lp1, g1 = _prnn1d_log_prob_rows(ansatz, samples)
    if not ansatz.parity:
        return tree_map(lambda g: 0.5 * g, g1)
    lp2, g2 = _prnn1d_log_prob_rows(ansatz, samples.flip(1).contiguous())
    w = torch.sigmoid(lp1 - lp2)

    def mix(a, b):
        wv = w.reshape((-1,) + (1,) * (a.dim() - 1))
        return 0.5 * (wv * a + (1.0 - wv) * b)

    return tree_map(mix, g1, g2)


# ---------------------------------------------------------------------------
# MDRNN2D: rows of log psi through the reverse boustrophedon sweep
# ---------------------------------------------------------------------------


def mdrnn2d_log_amp_rows(ansatz: Any, samples: torch.Tensor):
    """Per-sample rows of log psi = 0.5 log p for an MDRNN2D, samples
    (S, Nx, Ny).  The cell is linear + elu, so the rows factorize through the
    per-site pre-activation cotangent ``dacc``; the backward runs the
    boustrophedon in reverse: within a row the cotangent flows to the visit
    predecessor through Wh, across rows to the same column through Wv, and
    elu' comes from the stashed state (1 for h > 0, else h + 1)."""
    cell = ansatz.cell
    uh, uv, wh, wv, b = (getattr(cell, k).detach() for k in ("uh", "uv", "wh", "wv", "b"))
    hw, hb = ansatz.head.w.detach(), ansatz.head.b.detach()
    nx, ny, d = ansatz.nx, ansatz.ny, ansatz.local_dim
    s = samples.shape[0]
    onehot = nn.functional.one_hot(samples.permute(2, 1, 0).long(), d).to(torch.float32)
    zero_h, zero_x = uh.new_zeros(s, uh.shape[1]), uh.new_zeros(s, d)

    def cols(y):  # visit order of row y
        return range(nx) if y % 2 == 0 else range(nx - 1, -1, -1)

    h = [[None] * nx for _ in range(ny)]
    for y in range(ny):
        hh, xh = zero_h, zero_x
        for x in cols(y):
            hv, xv = (h[y - 1][x], onehot[y - 1, x]) if y > 0 else (zero_h, zero_x)
            h[y][x] = nn.functional.elu(xh @ uh + xv @ uv + hh @ wh + hv @ wv + b)
            hh, xh = h[y][x], onehot[y, x]
    h_all = torch.stack([torch.stack(row) for row in h])  # (Ny, Nx, S, U)

    dlogits = onehot - torch.softmax(h_all @ hw + hb, dim=-1)
    dhead = dlogits @ hw.T
    dacc = [[None] * nx for _ in range(ny)]
    dvert = [zero_h] * nx
    for y in reversed(range(ny)):
        carry = zero_h
        for x in reversed(list(cols(y))):
            hv = h_all[y, x]
            dacc[y][x] = (dhead[y, x] + dvert[x] + carry) * torch.where(hv > 0, 1.0, hv + 1.0)
            carry = dacc[y][x] @ wh.T
        dvert = [dacc[y][x] @ wv.T for x in range(nx)]
    dacc = torch.stack([torch.stack(row) for row in dacc])

    def shift_h(a):  # horizontal visit predecessor, lattice order (zeros at a row's start)
        out = torch.zeros_like(a)
        out[0::2, 1:] = a[0::2, :-1]
        out[1::2, :-1] = a[1::2, 1:]
        return out

    def shift_v(a):  # the row above, same column
        return torch.cat([torch.zeros_like(a[:1]), a[:-1]])

    def con(a, dg):
        return torch.einsum("yxsi,yxsg->sig", a, dg)

    rows = {
        "cell": {
            "uh": con(shift_h(onehot), dacc),
            "uv": con(shift_v(onehot), dacc),
            "wh": con(shift_h(h_all), dacc),
            "wv": con(shift_v(h_all), dacc),
            "b": dacc.sum(dim=(0, 1)),
        },
        "head": {"w": torch.einsum("yxsu,yxsd->sud", h_all, dlogits),
                 "b": dlogits.sum(dim=(0, 1))},
    }
    return tree_map(lambda g: 0.5 * g, rows)


# ---------------------------------------------------------------------------
# CRNNU1: rows of (Re, Im) log psi
# ---------------------------------------------------------------------------


def crnn_head_seeds(ansatz: Any, top: torch.Tensor, targets: torch.Tensor,
                    num_up: torch.Tensor, sites: torch.Tensor):
    """Per-site logit cotangents ``(dlogits_a, dlogits_p)`` of Re and Im
    log psi with respect to the amplitude head's and the phase head's
    logits, for trunk outputs ``top`` (..., U), spins ``targets`` (...), the
    ups before each site ``num_up`` (...) and the site indices ``sites``
    (broadcastable).  Re_n = 0.5 log q_n(target) with q the U(1)-masked,
    renormalized softmax, so d Re_n / d la = 0.5 (onehot - q); Im_n =
    pi softsign(lp_target), whose derivative is pi / (1 + |lp|)^2 on the
    target's logit.  Valid inside the sector, where the sampler draws."""
    aw, ab = ansatz.head_ampl.w.detach(), ansatz.head_ampl.b.detach()
    pw, pb = ansatz.head_phase.w.detach(), ansatz.head_phase.b.detach()
    onehot = nn.functional.one_hot(targets.long(), 2).to(torch.float32)
    q = torch.softmax(top @ aw + ab, dim=-1)
    if ansatz.u1:
        n_sites = ansatz.num_sites
        baseline = n_sites // 2 - 1
        act_up = baseline - num_up >= 0  # heavyside, H(0) = 1
        act_down = baseline - (sites - num_up) >= 0
        act = torch.stack([act_down, act_up], dim=-1).to(q.dtype)
        masked = q * act
        masked = masked / torch.clamp_min(masked.sum(dim=-1, keepdim=True), 1e-30)
        q = torch.where((2 * sites >= n_sites)[..., None], masked, q)
    lp = top @ pw + pb
    dlogits_a = 0.5 * (onehot - q)
    dlogits_p = onehot * (math.pi / (1.0 + lp.abs()) ** 2)
    return dlogits_a, dlogits_p


def _crnn_zero_head_rows(head: nn.Module, s: int):
    return {"w": head.w.new_zeros((s,) + tuple(head.w.shape)),
            "b": head.b.new_zeros((s,) + tuple(head.b.shape))}


def _crnn_rows(ansatz: Any, rnn_re, rnn_im, head_re, head_im, s: int):
    rows_re = {"rnn": rnn_re, "head_ampl": head_re,
               "head_phase": _crnn_zero_head_rows(ansatz.head_phase, s)}
    rows_im = {"rnn": rnn_im, "head_ampl": _crnn_zero_head_rows(ansatz.head_ampl, s),
               "head_phase": head_im}
    return rows_re, rows_im


def _crnn_rows_fused(ansatz: Any, samples: torch.Tensor):
    """The kernel path: one B19 launch storing the trunk's history and
    gates, the head seeds (closed form, above), then one B20 launch for both
    parts from the stored gates and the batched contractions
    (``ops/fused_jac.py``)."""
    s, n = samples.shape
    trunk = tuple(w.detach() for w in ansatz.weights()[:4])
    cum_up = torch.cumsum(samples, dim=1) - samples
    hist, gates = fused_jac.rollout_hist(trunk, samples, store=True)  # (S, N, U), (S, N, 4U)
    sites = torch.arange(n, device=samples.device)
    dla, dlp = crnn_head_seeds(ansatz, hist, samples, cum_up, sites)
    douts = torch.stack([dla @ ansatz.head_ampl.w.detach().T,
                         dlp @ ansatz.head_phase.w.detach().T])
    dg_a, dg_p = fused_jac.sweep_dgates(trunk, samples, hist, douts, gates=gates)
    x0 = fused_jac.input_onehot_rows(samples)

    def head(dlogits):
        return {"w": hist.transpose(1, 2) @ dlogits, "b": dlogits.sum(dim=1)}

    return _crnn_rows(ansatz, [fused_jac.trunk_rows_from_sweep(hist, dg_a, x0)],
                      [fused_jac.trunk_rows_from_sweep(hist, dg_p, x0)], head(dla), head(dlp),
                      s)


def crnn_log_amp_rows(ansatz: Any, samples: torch.Tensor):
    """Per-sample rows of (Re log psi, Im log psi) for a CRNNU1, two trees
    of (S, ...) leaves.  Re flows only through the amplitude head and Im only
    through the phase head, so each part seeds its own trunk sweep; both
    share the rollout and run in one sweep."""
    if ansatz._use_kernels():
        return _crnn_rows_fused(ansatz, samples)
    s = samples.shape[0]
    layers = _layers(ansatz)
    onehot, inputs = _chain_inputs(samples, ansatz.local_dim)
    targets = samples.T
    cum_up = torch.cumsum(targets, dim=0) - targets
    prevs, finals, top = _rollout(layers, inputs)
    xs = _layer_inputs(inputs, prevs, finals)
    sites = torch.arange(targets.shape[0], device=samples.device)[:, None]
    dla, dlp = crnn_head_seeds(ansatz, top, targets, cum_up, sites)
    dout = torch.stack([dla @ ansatz.head_ampl.w.detach().T,
                        dlp @ ansatz.head_phase.w.detach().T])
    dgates = _bptt(layers, xs, prevs, dout)

    def part(idx):
        return [_contract_layer(x, pv, dgx[idx], dgh[idx])
                for x, pv, (dgx, dgh) in zip(xs, prevs, dgates)]

    return _crnn_rows(ansatz, part(0), part(1), _head_rows(top, dla), _head_rows(top, dlp), s)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def log_amp_rows(ansatz: Any, samples: torch.Tensor):
    """Per-sample rows of (real) log psi for a supported real ansatz."""
    from ..models.mdrnn2d import MDRNN2D

    if isinstance(ansatz, MDRNN2D):
        return mdrnn2d_log_amp_rows(ansatz, samples)
    return prnn1d_log_amp_rows(ansatz, samples)


def supports(ansatz: Any) -> bool:
    """The built-in ansatze with local_dim=2: PRNN1D (plain, parity,
    snake-2D, GRU stacks), CRNNU1 and MDRNN2D.  Anything else takes the
    generic rows of ``vmc/minsr.py``."""
    from ..models.crnn_u1 import CRNNU1
    from ..models.mdrnn2d import MDRNN2D
    from ..models.prnn1d import PRNN1D

    return isinstance(ansatz, (PRNN1D, CRNNU1, MDRNN2D)) and ansatz.local_dim == 2
