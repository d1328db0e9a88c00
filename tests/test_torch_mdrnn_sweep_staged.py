"""PyTorch port: the arithmetic of the MDRNN's sliced sweep (``csrc/
fused_mdrnn.cu``, which B12, B13, B14's replay and B15/B16's base pass run),
emulated on the CPU and held against the JAX package's ``mdrnn_log_prob``
(its Pallas kernel in interpret mode, as tests/test_torch_mdrnn.py runs it,
and the jnp path), so that the chosen summation order is known to meet the
tolerances before any card runs it.

Per site, thread (ks, j) of the kernel sums unit j's terms over the ks-th
quarter of U (ceil(U / 4) rows of W_h and W_v each): the horizontal half
as one multiply-add chain in k order, then the vertical half the same way,
the half of an absent neighbour skipped, and the slice's sum is the two
added.  The update adds the four slices' sums in slice order, then the
input terms b + uh[x_h] + uv[x_v] (an absent neighbour's term skipped),
and applies the ELU.  The books warp forms each logit as a multiply-add
chain per lane over units lane, lane + 32, ..., then a butterfly over the
32 lanes, adds the head's bias, and Kahan-adds log p in visit order; p1 is
exp(l1 - lse).  The emulation below does the same, each multiply-add
rounded once (in float64, then to float32).

Lattices 3x4 and 4x3, U=50 and U=20 (not a multiple of 32); inputs drawn
with numpy from a seed.  Tolerances: log p 1e-5 per site, the replay's
history and p1 1e-5 of the largest entry.  The helpers live here and
nothing on the port's path imports them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.models.mdrnn2d import MDRNN2D as JMDRNN2D
from rnnwavefunctions_tpu.ops import fused_mdrnn as jfused_mdrnn
from rnnwavefunctions_tpu_torch import MDRNN2D, interop
from rnnwavefunctions_tpu_torch.ops import fused_mdrnn
from rnnwavefunctions_tpu_torch.ops.compsum import kadd, kfinal

torch.set_num_threads(1)

B = 16
SLICES = 4
CASES = [(3, 4, 50), (4, 3, 50), (3, 4, 20), (4, 3, 20)]
IDS = ["3x4-U50", "4x3-U50", "3x4-U20", "4x3-U20"]


def _case(nx, ny, u, seed=0):
    """JAX params (Glorot plus seeded noise, so no bias is zero), the port's
    weights holding the same values, and (B, Nx, Ny) samples."""
    jans = JMDRNN2D(nx=nx, ny=ny, units=u, impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(100 * nx + 10 * ny + u)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    model = MDRNN2D(nx, ny, u, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    samples = rng.integers(0, 2, (B, nx, ny)).astype(np.int32)
    return jans, params, tuple(w.detach() for w in model.weights()), samples


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(v):
    """The xor butterfly over the last axis (32 lanes) in float32; every
    lane ends with the same bits."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _slice_sum(h, w, k0, k1):
    """One slice's chain over k in [k0, k1): sum_k h[:, k] w[k, :] for every
    unit, multiply-adds in k order."""
    acc = torch.zeros(h.shape[0], w.shape[1])
    for k in range(k0, k1):
        acc = _fma(h[:, k:k + 1], w[k][None, :], acc)
    return acc


def _head_logit(h, col, bias):
    """A logit as the books warp forms it: per lane a chain over units
    lane + 32 q, then the butterfly, then the bias."""
    b, u = h.shape
    lanes = torch.zeros(b, 32)
    for q in range(-(-u // 32)):
        for lane in range(32):
            j = lane + 32 * q
            if j < u:
                lanes[:, lane] = _fma(h[:, j], col[j], lanes[:, lane])
    return _butterfly(lanes) + bias


def sliced_sweep(weights, samples=None, uniforms=None, nx=None, ny=None):
    """The kernel's sweep, teacher-forced (``samples`` (B, Nx, Ny)) or
    drawing with the (B, NS) visit-order ``uniforms``.  Returns (spins
    (B, NS), lp (B,), hist (B, NS, U), p1 (B, NS), pfx (B, NS))."""
    uh, uv, wh, wv, bias, hw, hb = weights
    u = wh.shape[0]
    if samples is not None:
        b, nx, ny = samples.shape
    else:
        b = uniforms.shape[0]
    kc = -(-u // SLICES)
    xx, yy = fused_mdrnn.visit_order(nx, ny)
    row = torch.zeros(nx, b, u)   # the row buffer: each column's last state
    srow = torch.zeros(nx, b)     # and its spin
    acc, cmp = torch.zeros(b), torch.zeros(b)
    spins, hist, p1s, pfx = [], [], [], []
    for m in range(nx * ny):
        y, k, x = m // nx, m % nx, int(xx[m])
        x_prev = int(xx[m - 1]) if k > 0 else 0
        parts = []
        for ks in range(SLICES):
            k0, k1 = min(u, ks * kc), min(u, (ks + 1) * kc)
            ah = _slice_sum(row[x_prev], wh, k0, k1) if k > 0 else torch.zeros(b, u)
            av = _slice_sum(row[x], wv, k0, k1) if y > 0 else torch.zeros(b, u)
            parts.append(ah + av)
        a = parts[0]
        for part in parts[1:]:
            a = a + part
        inp = bias.expand(b, u)
        if k > 0:
            inp = inp + torch.where(srow[x_prev][:, None] > 0.5, uh[1], uh[0])
        if y > 0:
            inp = inp + torch.where(srow[x][:, None] > 0.5, uv[1], uv[0])
        pre = a + inp
        h = torch.where(pre > 0, pre, torch.exp(torch.clamp(pre, max=0.0)) - 1.0)
        l0, l1 = _head_logit(h, hw[:, 0], hb[0]), _head_logit(h, hw[:, 1], hb[1])
        if samples is not None:
            s = samples[:, x, y].float()
        else:
            s = (uniforms[:, m] >= 1.0 / (1.0 + torch.exp(-(l0 - l1)))).float()
        mx = torch.maximum(l0, l1)
        lse = mx + torch.log(torch.exp(l0 - mx) + torch.exp(l1 - mx))
        acc, cmp = kadd(acc, cmp, torch.where(s > 0.5, l1, l0) - lse)
        row[x], srow[x] = h, s
        spins.append(s)
        hist.append(h)
        p1s.append(torch.exp(l1 - lse))
        pfx.append(kfinal(acc, cmp))
    st = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    return st(spins), kfinal(acc, cmp), st(hist), st(p1s), st(pfx)


def test_slices_cover_each_row_once():
    """The kernel's slices of U (ceil(U / 4) rows each, the last ones
    shorter or empty) cover every row of W_h and W_v exactly once."""
    for u in range(1, 129):
        kc = -(-u // SLICES)
        rows = [k for ks in range(SLICES) for k in range(min(u, ks * kc), min(u, (ks + 1) * kc))]
        assert rows == list(range(u)) and kc <= 32


@pytest.mark.parametrize("nx,ny,u", CASES, ids=IDS)
def test_sliced_sweep_matches_jax(nx, ny, u):
    jans, params, weights, samples = _case(nx, ny, u)
    _, lp, _, _, _ = sliced_sweep(weights, samples=torch.from_numpy(samples))
    tol = 1e-5 * nx * ny
    want = np.asarray(jans._log_prob_jnp(params, jnp.asarray(samples)))
    np.testing.assert_allclose(lp.numpy(), want, atol=tol, rtol=0)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jfused_mdrnn.mdrnn_log_prob(params, jnp.asarray(samples), nx, ny))
    np.testing.assert_allclose(lp.numpy(), pallas, atol=tol, rtol=0)


@pytest.mark.parametrize("nx,ny,u", CASES, ids=IDS)
def test_sliced_replay_matches_plain_replay(nx, ny, u):
    """B14's replay as the sliced sweep stores it (the history in visit
    order and p1) against the plain replay, and B15/B16's prefixes against
    the plain base pass's."""
    _, _, weights, samples = _case(nx, ny, u)
    s = torch.from_numpy(samples)
    _, lp, hist, p1, pfx = sliced_sweep(weights, samples=s)
    want = fused_mdrnn.replay_plain(weights, s)
    tol = 1e-5 * nx * ny
    torch.testing.assert_close(lp, want.lp, atol=tol, rtol=0)
    torch.testing.assert_close(hist, want.hist,
                               atol=1e-5 * max(1.0, float(want.hist.abs().max())), rtol=0)
    torch.testing.assert_close(p1, want.p1, atol=1e-5, rtol=0)
    _, _, _, want_pfx = fused_mdrnn.sweep_plain(weights, nx, ny, samples=s)
    torch.testing.assert_close(pfx, want_pfx, atol=tol, rtol=0)


@pytest.mark.parametrize("nx,ny,u", CASES[2:], ids=IDS[2:])
def test_sliced_sampler_draws_the_plain_samplers_lattices(nx, ny, u):
    """In sample mode, with the uniforms the plain sampler takes, the
    sliced sweep draws its lattices, and its log p is the teacher-forced
    log p of the JAX package on them."""
    jans, params, weights, _ = _case(nx, ny, u)
    uni = torch.from_numpy(np.random.default_rng(7).random((B, nx * ny)).astype(np.float32))
    spins, lp, _, _, _ = sliced_sweep(weights, uniforms=uni, nx=nx, ny=ny)
    want_s, want_lp = fused_mdrnn.sample_plain(weights, uni, nx, ny)
    got_s = fused_mdrnn.to_lattice(spins, nx, ny)
    assert torch.equal(got_s, want_s)
    torch.testing.assert_close(lp, want_lp, atol=1e-5 * nx * ny, rtol=0)
    jax_lp = np.asarray(jans._log_prob_jnp(params, jnp.asarray(got_s.numpy())))
    np.testing.assert_allclose(lp.numpy(), jax_lp, atol=1e-5 * nx * ny, rtol=0)
