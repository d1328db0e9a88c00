"""PyTorch port: the arithmetic of the redesigned CUDA kernels, emulated on
the CPU and held against the JAX package, so that the chosen numerics are
known to meet the tolerances before any card runs them.

* K3/K4/B6's suffix pass multiplies on the tensor cores in TF32 made
  float32-accurate by the 3xTF32 split (``csrc/tfim_flip.cu``): each operand
  x = hi + lo, hi = x with the low 13 mantissa bits cleared, lo = (x - hi)
  cleared the same way; per k-step of 8 units the accumulators (starting
  from b_h) take h_hi.W_lo, then h_lo.W_hi, then h_hi.W_hi in float32 (the
  states are the product's A operand, W_h its B; past U=56, W_h^T and the
  states, the same three terms in the same order).  The emulation below
  runs that scheme for all flips of B=16 chains of N=100 sites at U=50,
  from its own emulation of the base pass, against ``tfim_flip_log_probs``
  of the JAX package (its Pallas kernel in interpret mode, as
  tests/test_torch_parity.py runs it).  A second test lays the states and
  W_h out as that suffix pass does, in wgmma's fragments, and checks that
  the product is the gates and that each thread's accumulators hold the
  gates of the units its A fragment holds.
* B19 and the base pass split each site's product over four slices of k,
  each summed in order with fused multiply-adds, the slices then added in
  order (``slice_product``/``slice_update`` in ``csrc/gru_common.cuh``); the
  emulation runs that order for the cRNN trunk against the JAX
  ``rollout_hist`` in interpret mode (as tests/test_torch_jacobian.py runs
  it).

Both kernels compute the logistic function as 0.5 tanh(x/2) + 0.5.
Tolerances are chip_smoke.py's: log p 1e-5 per site, ratio sums and the
history 1e-4 of the largest entry.  The helpers live here and nothing on
the port's path imports them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.models.crnn_u1 import CRNNU1 as JCRNNU1
from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.ops import fused_jac as jfused_jac
from rnnwavefunctions_tpu.ops.tfim_flip_kernel import tfim_flip_log_probs as jflip_log_probs
from rnnwavefunctions_tpu_torch import CRNNU1, PRNN1D, interop
from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk
from rnnwavefunctions_tpu_torch.ops.compsum import kadd, kfinal
from rnnwavefunctions_tpu_torch.ops.fused_gru import logp2

torch.set_num_threads(1)

N, U, B = 100, 50, 16
SLICES = 4  # kSlices of csrc/gru_common.cuh


def _pair(jans, model, seed):
    """JAX params (Glorot plus seeded noise, so no bias is zero) and the
    port's model holding the same values."""
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return params, tuple(w.detach() for w in model.weights())


def _chains(b, n, seed):
    return np.random.default_rng(seed).integers(0, 2, (b, n)).astype(np.int32)


def _sigmoid(x):
    return 0.5 * torch.tanh(0.5 * x) + 0.5


def _fma(a, b, c):
    """float32 fused multiply-add: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _input_gates(wx, bx, samples, i):
    """(B, 3U) input gates at site i: wx[s_{i-1}] + b_x, or b_x alone at
    site 0, where the input is the zero vector."""
    if i == 0:
        return bx.expand(samples.shape[0], -1)
    return wx[samples[:, i - 1].long()] + bx


def _gru_update(gx, a, h, bh, u):
    """The reset-after update from the recurrent sums a (B, 3U) (b_h not
    added yet), as slice_update adds them."""
    r = _sigmoid(gx[:, :u] + (a[:, :u] + bh[:u]))
    z = _sigmoid(gx[:, u:2 * u] + (a[:, u:2 * u] + bh[u:2 * u]))
    c = torch.tanh(gx[:, 2 * u:] + r * (a[:, 2 * u:] + bh[2 * u:]))
    return z * h + (1.0 - z) * c


def _sliced_sums(h, wh):
    """h (B, U) @ wh (U, 3U) as the latency kernels sum it: slice ks of
    ceil(U/4) k's in order by fused multiply-adds, the slices added in
    order."""
    u = h.shape[1]
    kc = -(-u // SLICES)
    total = None
    for ks in range(SLICES):
        part = torch.zeros(h.shape[0], wh.shape[1])
        for k in range(ks * kc, min(u, (ks + 1) * kc)):
            part = _fma(h[:, k:k + 1], wh[k], part)
        total = part if total is None else total + part
    return total


def _sliced_rollout(trunk, samples):
    """B19's history (B, N, U) in its summation order."""
    wx, wh, bx, bh = trunk
    b, n = samples.shape
    u = wh.shape[0]
    h, hist = torch.zeros(b, u), []
    for i in range(n):
        gx = _input_gates(wx, bx, samples, i)
        h = _gru_update(gx, _sliced_sums(h, wh), h, bh, u)
        hist.append(h)
    return torch.stack(hist, dim=1)


def _tf32(x):
    """x cut to TF32: the low 13 of float32's 23 mantissa bits cleared."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _split_nearest(x):
    """B10/B11's split: hi is x rounded to TF32 to nearest (ties away from
    zero), lo the exact remainder, of which the tensor cores read the TF32
    part."""
    hi = ((x.view(torch.int32) + 4096) & -8192).view(torch.float32)
    return hi, _tf32(x - hi)


def _pad_gates(m, u, up):
    """(..., 3U) -> (..., 3Up): each gate's columns padded with zeros."""
    out = torch.zeros(*m.shape[:-1], 3 * up)
    for q in range(3):
        out[..., q * up:q * up + u] = m[..., q * u:(q + 1) * u]
    return out


def _tensor_core_sums(h, wh_pad, bh_pad, up, split=_split):
    """The suffix pass's gate accumulators: b_h, then per k-step of 8 the
    three 3xTF32 products W_lo.h_hi, W_hi.h_lo, W_hi.h_hi in float32, both
    operands split by ``split``."""
    hp = torch.zeros(h.shape[0], up)
    hp[:, :h.shape[1]] = h
    acc = bh_pad.expand(h.shape[0], -1).clone()
    for k0 in range(0, up, 8):
        h_hi, h_lo = split(hp[:, k0:k0 + 8])
        w_hi, w_lo = split(wh_pad[k0:k0 + 8])
        acc = acc + h_hi @ w_lo
        acc = acc + h_lo @ w_hi
        acc = acc + h_hi @ w_hi
    return acc


def _emulated_flip_log_probs(weights, samples):
    """(lpf (B, N), lp (B,)) as K3/K4/B6 compute them: the base pass in the
    sliced order, the flip suffixes in the 3xTF32 scheme."""
    wx, wh, bx, bh, hw, hb = weights
    b, n = samples.shape
    u = wh.shape[0]
    up = -(-u // 8) * 8
    s = samples.to(torch.float32)
    # base pass: history, prefixes and flipped-site log-probs
    h = torch.zeros(b, u)
    acc, cmp = torch.zeros(b), torch.zeros(b)
    hist, pfx, fl = [], [], []
    for i in range(n):
        gx = _input_gates(wx, bx, samples, i)
        h = _gru_update(gx, _sliced_sums(h, wh), h, bh, u)
        logits = h @ hw + hb
        acc, cmp = kadd(acc, cmp, logp2(logits[:, 0], logits[:, 1], s[:, i]))
        hist.append(h)
        pfx.append(kfinal(acc, cmp))
        fl.append(logp2(logits[:, 0], logits[:, 1], 1.0 - s[:, i]))
    lp = kfinal(acc, cmp)
    hist, pfx, fl = (torch.stack(t, dim=1) for t in (hist, pfx, fl))
    # suffixes: at site i the flips f < i advance, from h_f and input 1 - s_f
    wh_pad = torch.zeros(up, 3 * up)
    wh_pad[:u] = _pad_gates(wh, u, up)
    bh_pad = _pad_gates(bh, u, up)
    h = hist.clone()
    x = 1.0 - s
    acc = torch.cat([torch.zeros(b, 1), pfx[:, :-1]], dim=1) + fl
    cmp = torch.zeros_like(acc)
    for i in range(1, n):
        tgt = s[:, i:i + 1].expand(b, i).reshape(-1)
        hf = h[:, :i].reshape(-1, u)
        sums = _tensor_core_sums(hf, wh_pad, bh_pad, up)
        sums = torch.cat([sums[:, q * up:q * up + u] for q in range(3)], dim=1)
        gx = wx[x[:, :i].reshape(-1).long()] + bx
        r = _sigmoid(gx[:, :u] + sums[:, :u])
        z = _sigmoid(gx[:, u:2 * u] + sums[:, u:2 * u])
        c = torch.tanh(gx[:, 2 * u:] + r * sums[:, 2 * u:])
        h_new = z * hf + (1.0 - z) * c
        logits = h_new @ hw + hb
        a, cm = kadd(acc[:, :i].reshape(-1), cmp[:, :i].reshape(-1),
                     logp2(logits[:, 0], logits[:, 1], tgt))
        h[:, :i] = h_new.view(b, i, u)
        acc[:, :i] = a.view(b, i)
        cmp[:, :i] = cm.view(b, i)
        x[:, :i] = tgt.view(b, i)
    return kfinal(acc, cmp), lp


def test_tensor_core_flip_scheme_matches_jax():
    """The suffix pass's 3xTF32 products and the base pass's sliced sums
    give the per-flip log p and base log p of the JAX kernel within 1e-5
    per site, and its ratio sums within 1e-4."""
    params, weights = _pair(JPRNN1D(num_sites=N, units=(U,), impl="jnp"),
                            PRNN1D(N, (U,), device="cpu"), seed=21)
    s = _chains(B, N, seed=22)
    with pltpu.force_tpu_interpret_mode():
        j_lpf, j_lp = jflip_log_probs(params, jnp.asarray(s))
    lpf, lp = _emulated_flip_log_probs(weights, torch.from_numpy(s))
    np.testing.assert_allclose(lpf.numpy(), np.asarray(j_lpf), atol=1e-5 * N, rtol=0)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5 * N, rtol=0)
    ratio = tk.ratio_sum(lpf, lp)
    want = tk.ratio_sum(torch.from_numpy(np.array(j_lpf)), torch.from_numpy(np.array(j_lp)))
    np.testing.assert_allclose(ratio.numpy(), want.numpy(),
                               atol=1e-4 * max(1.0, float(want.abs().max())), rtol=0)
    # the scheme is not a no-op: TF32 alone is ~3 digits, far from float32
    hi = _tf32(weights[1])
    assert float((hi - weights[1]).abs().max()) > 1e-5


def _rs_table(wh, ks):
    """W_h as the turned-around suffix pass's B operand (Kp x 24 KS):
    table entry i of ``flip_suffix_rs_kernel`` is (column n, row k) of
    ``state_at(n, k, Kp)``; column n is gate (n / 8) % 3 of unit
    8 (n / 24) + n % 8, row k unit 8 (k / 8) + 2 (k % 4) + (k / 4) % 2."""
    u, kp = wh.shape[0], 8 * ks
    b = torch.zeros(kp, 24 * ks, dtype=torch.float64)
    for i in range(24 * ks * kp):
        grp, rem = divmod(i, kp * 8)
        k = 4 * (rem >> 5) + (rem & 3)
        n = 8 * grp + ((rem >> 2) & 7)
        un = 8 * (grp // 3) + (n & 7)
        uk = 8 * (k >> 3) + 2 * (k & 3) + ((k >> 2) & 1)
        assert (grp * kp * 8 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3)) == i  # state_at
        if uk < u and un < u:
            b[k, n] = float(wh[uk, (grp % 3) * u + un])
    return b


@pytest.mark.parametrize("u", [7, 16, 41, 50, 56])
def test_turned_around_tile_holds_each_state_in_its_thread(u):
    """The states of 64 trajectories as wgmma's A fragments (thread (w, g,
    t) holds rows 16 w + g (+8) and, for k-step j, columns t and t + 4,
    the units 8 j + 2 t and 8 j + 2 t + 1) times the table give the gates
    H W_h, and accumulator 4 (3 j + gate) + 2 rh + v of that thread (row
    16 w + g + 8 rh, column 8 (3 j + gate) + 2 t + v) is that gate of unit
    8 j + 2 t + v: the unit whose state its A fragment holds as element
    2 v + rh."""
    ks = -(-u // 8)
    kp = 8 * ks
    gen = torch.Generator().manual_seed(u)
    wh = torch.randn(u, 3 * u, generator=gen, dtype=torch.float64)
    h = torch.randn(64, u, generator=gen, dtype=torch.float64)
    a = torch.full((64, kp), float("nan"), dtype=torch.float64)
    held = {}  # (row, unit) -> (thread, element) of the A fragments
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for j in range(ks):
                    for e in range(4):
                        rh, v = e & 1, e >> 1
                        row, col, unit = 16 * w + g + 8 * rh, 8 * j + t + 4 * v, 8 * j + 2 * t + v
                        a[row, col] = h[row, unit] if unit < u else 0.0
                        held[(row, unit)] = ((w, g, t), (j, e))
    assert not bool(a.isnan().any())
    d = a @ _rs_table(wh, ks)
    gates = h @ wh
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for cb in range(3 * ks):
                    j, gate = divmod(cb, 3)
                    for rh in range(2):
                        for v in range(2):
                            row, unit = 16 * w + g + 8 * rh, 8 * j + 2 * t + v
                            got = d[row, 8 * cb + 2 * t + v]
                            if unit >= u:
                                assert got == 0.0
                                continue
                            assert held[(row, unit)] == ((w, g, t), (j, 2 * v + rh))
                            torch.testing.assert_close(got, gates[row, gate * u + unit])


def test_sliced_rollout_matches_jax():
    """B19's sliced summation order gives the JAX rollout's history within
    1e-4 of its largest entry."""
    params, weights = _pair(JCRNNU1(num_sites=N, units=(U,)), CRNNU1(N, (U,), device="cpu"),
                            seed=23)
    s = _chains(B, N, seed=24)
    with pltpu.force_tpu_interpret_mode():
        want = np.transpose(np.asarray(jfused_jac.rollout_hist(params, jnp.asarray(s))),
                            (2, 0, 1))
    got = _sliced_rollout(weights[:4], torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())), rtol=0)
