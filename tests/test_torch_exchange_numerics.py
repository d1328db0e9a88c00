"""PyTorch port: the arithmetic of B10/B11's kernels (``csrc/j1j2_exchange.cu``),
emulated on the CPU and held against the JAX package's exchange kernel in
interpret mode, so that the chosen numerics are known to meet the
tolerances before any card runs them.

* The base pass splits each site's 3U x U product over four slices of k,
  each summed in order with fused multiply-adds, the slices then added in
  order (``slice_product``/``slice_update``), and stores per site the
  history, the Kahan-corrected prefixes of Re and Im log psi, the
  up-counts and the site's amplitude and phase terms with the target
  flipped.
* The suffix pass starts each exchanged trajectory of start site a at site
  a+1 from h[a] with input 1 - s_a, up-count cup[a] + 1 - s_a and the sums
  pfx[a-1] + fl[a], and multiplies on the tensor cores in TF32 made
  float32-accurate by the 3xTF32 split, each operand rounded to TF32 to
  nearest with its exact remainder; each trajectory keeps its own second
  flip site, up-count and U(1) mask.  Two layouts: to pad8(U) = 56 the
  turned-around pass packs 64 consecutive terms of all start sites' lists
  into a tile (``test_torch_exchange_packing.suffix_tiles``), and a row whose
  start lies past the tile's first start idles until it joins at its
  start; past it the first design takes the trajectories of one start
  site (its NN and NNN bonds, and at a = 0, 1 the wraps, in one list) in
  tiles of 32 columns.  Padding rows repeat the last listed term.  A
  further test lays the heads out as the turned-around pass does and
  checks that a thread's partial logits, summed over its quad, are the
  four logits of its rows.

The JAX kernel recomputes site a from h[a-1]; the emulation takes site a's
terms from its base pass, as the CUDA kernel does.  Tolerances are
chip_smoke.py's: log psi 1e-5 per site, the exchange sums 1e-4 of the
largest entry.  The helpers live here and nothing on the port's path
imports them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.ops.j1j2_exchange_kernel import (
    j1j2_exchange_offdiag as jj1j2_exchange_offdiag,
)
from rnnwavefunctions_tpu_torch import J1J2
from rnnwavefunctions_tpu_torch.ops import fused_crnn
from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk
from rnnwavefunctions_tpu_torch.ops.compsum import kadd, kfinal
from test_torch_crnn import _pair, sector_samples
from test_torch_exchange_packing import suffix_tiles
from test_torch_flip_numerics import (
    _gru_update,
    _input_gates,
    _pad_gates,
    _sigmoid,
    _sliced_sums,
    _split_nearest,
    _tensor_core_sums,
)

torch.set_num_threads(1)

N, U, B = 16, 50, 16
TILE = 32  # trajectories per tile of the first design (kExTraj)


def _bonds(n, has_nnn, periodic):
    """(a, b, NNN?) of every bond in the kernels' summation order."""
    bonds = [(k, k + 1, False) for k in range(n - 1)]
    if has_nnn:
        bonds += [(k, k + 2, True) for k in range(n - 2)]
    if periodic:
        bonds += [(0, n - 1, False)] + ([(0, n - 2, True), (1, n - 1, True)] if has_nnn else [])
    return bonds


def _emulated_base(weights, samples, u1):
    """The base pass in the sliced order: (hist, pfx_re, pfx_im, cup, fl_re,
    fl_im), each (B, N[, U]), and (lp_re, lp_im)."""
    wx, wh, bx, bh = weights[:4]
    b, n = samples.shape
    u = wh.shape[0]
    s = samples.to(torch.float32)
    h, up = torch.zeros(b, u), torch.zeros(b)
    re, rec, im, imc = (torch.zeros(b) for _ in range(4))
    keep = {k: [] for k in ("hist", "pfx_re", "pfx_im", "cup", "fl_re", "fl_im")}
    for i in range(n):
        h = _gru_update(_input_gates(wx, bx, samples, i), _sliced_sums(h, wh), h, bh, u)
        lp0, lp1, ph0, ph1 = fused_crnn.site_heads(h, weights[4:], i, up, n, u1)
        one = s[:, i] > 0.5
        re, rec = kadd(re, rec, 0.5 * torch.where(one, lp1, lp0))
        im, imc = kadd(im, imc, torch.where(one, ph1, ph0))
        for key, value in (("hist", h), ("pfx_re", kfinal(re, rec)), ("pfx_im", kfinal(im, imc)),
                           ("cup", up), ("fl_re", 0.5 * torch.where(one, lp0, lp1)),
                           ("fl_im", torch.where(one, ph0, ph1))):
            keep[key].append(value)
        up = up + s[:, i]
    return {k: torch.stack(v, dim=1) for k, v in keep.items()}, kfinal(re, rec), kfinal(im, imc)


def _lists(samples, bonds, el_nn, el_nnn):
    """Each start site's list of exchanged (bond, sample) terms, by bond then
    sample, as the list launch forms it: {a: [(bond, sample)]}."""
    s = samples.numpy()
    return {a: [(k, b) for k, (ka, kb, nnn) in enumerate(bonds) if ka == a
                and (el_nnn if nnn else el_nn) != 0.0 for b in range(s.shape[0])
                if s[b, ka] != s[b, kb]] for a in range(s.shape[1])}


def _tiles(lists, layout):
    """The suffix pass's tiles, each a list of rows (start site, bond,
    sample, listed?): "packed" (the turned-around pass, 64 consecutive terms
    of all lists) or "per_start" (the first design, TILE terms of one list);
    padding rows repeat the last term, unlisted."""
    if layout == "packed":
        counts = [len(lists[a]) for a in sorted(lists)]
        return [[(a, *lists[a][i], listed) for a, i, listed in tile]
                for tile in suffix_tiles(counts)]
    tiles = []
    for a, listed in lists.items():
        for t0 in range(0, len(listed), TILE):
            tile = [(a, *term, True) for term in listed[t0:t0 + TILE]]
            tiles.append(tile + [(a, *listed[-1], False)] * (TILE - len(tile)))
    return tiles


def _emulated_exchange(weights, samples, u1, el_nn, el_nnn, has_nnn, periodic, layout):
    """(eoff_re, eoff_im, lp_re, lp_im) as B10 computes them, and the tiles."""
    wx, wh, bx, bh = weights[:4]
    b, n = samples.shape
    u = wh.shape[0]
    kp = -(-u // 8) * 8
    s = samples.to(torch.float32)
    base, lp_re, lp_im = _emulated_base(weights, samples, u1)
    bonds = _bonds(n, has_nnn, periodic)
    wh_pad = torch.zeros(kp, 3 * kp)
    wh_pad[:u] = _pad_gates(wh, u, kp)
    bh_pad = _pad_gates(bh, u, kp)
    terms_re, terms_im = torch.zeros(len(bonds), b), torch.zeros(len(bonds), b)
    tiles = _tiles(_lists(samples, bonds, el_nn, el_nnn), layout)
    for rows in tiles:
        at = torch.tensor([a for a, _, _, _ in rows])
        ks = torch.tensor([k for _, k, _, _ in rows])
        bs = torch.tensor([bi for _, _, bi, _ in rows])
        second = torch.tensor([bonds[k][1] for k in ks.tolist()])
        h = torch.zeros(len(rows), u)
        x = torch.zeros(len(rows))
        up = base["cup"][bs, at] + 1.0 - s[bs, at]
        before = torch.where(at > 0, at - 1, 0)
        re = base["fl_re"][bs, at] + torch.where(at > 0, base["pfx_re"][bs, before], 0.0)
        im = base["fl_im"][bs, at] + torch.where(at > 0, base["pfx_im"][bs, before], 0.0)
        rec, imc = torch.zeros_like(re), torch.zeros_like(im)
        for i in range(int(at.min()) + 1, n):
            # rows of start i - 1 join from h[i-1] with input 1 - s_{i-1};
            # rows of a later start idle and add nothing
            join = at == i - 1
            h = torch.where(join[:, None], base["hist"][bs, i - 1], h)
            x = torch.where(join, 1.0 - s[bs, i - 1], x)
            live = at < i
            sums = _tensor_core_sums(h, wh_pad, bh_pad, kp, _split_nearest)
            sums = torch.cat([sums[:, q * kp:q * kp + u] for q in range(3)], dim=1)
            gx = wx[x.long()] + bx
            r = _sigmoid(gx[:, :u] + sums[:, :u])
            z = _sigmoid(gx[:, u:2 * u] + sums[:, u:2 * u])
            c = torch.tanh(gx[:, 2 * u:] + r * sums[:, 2 * u:])
            h = z * h + (1.0 - z) * c
            lp0, lp1, ph0, ph1 = fused_crnn.site_heads(h, weights[4:], i, up, n, u1)
            tgt = torch.where(second == i, 1.0 - s[bs, i], s[bs, i])
            one = tgt > 0.5
            re_n, rec_n = kadd(re, rec, 0.5 * torch.where(one, lp1, lp0))
            im_n, imc_n = kadd(im, imc, torch.where(one, ph1, ph0))
            re, rec = torch.where(live, re_n, re), torch.where(live, rec_n, rec)
            im, imc = torch.where(live, im_n, im), torch.where(live, imc_n, imc)
            x, up = tgt, torch.where(live, up + tgt, up)
        d_re = kfinal(re, rec) - lp_re[bs]
        d_im = kfinal(im, imc) - lp_im[bs]
        el = torch.tensor([el_nnn if bonds[k][2] else el_nn for k in ks.tolist()])
        mag = el * torch.exp(d_re)
        for row, (_, k, bi, listed) in enumerate(rows):
            if listed:
                terms_re[k, bi] = mag[row] * torch.cos(d_im[row])
                terms_im[k, bi] = mag[row] * torch.sin(d_im[row])
    # the per-sample sum in bond order
    eoff_re, eoff_im = torch.zeros(b), torch.zeros(b)
    for k in range(len(bonds)):
        eoff_re = eoff_re + terms_re[k]
        eoff_im = eoff_im + terms_im[k]
    return (eoff_re, eoff_im, lp_re, lp_im), tiles, bonds


@pytest.mark.parametrize("layout,u", [("packed", U), ("per_start", 64)],
                         ids=["packed_u50", "per_start_u64"])
@pytest.mark.parametrize("periodic,j2", [(False, 0.0), (False, 0.2), (True, 0.0), (True, 0.2)],
                         ids=["obc_j2_0", "obc_j2_0.2", "pbc_j2_0", "pbc_j2_0.2"])
def test_tensor_core_exchange_scheme_matches_jax(periodic, j2, layout, u):
    """The suffix pass's 3xTF32 products with per-trajectory masks, in
    either layout (packed tiles of 64 whose rows join at their start, at
    U = 50; tiles of 32 of one start site, the first design's, past
    pad8(U) = 56), and the base pass's sliced sums, give the JAX kernel's
    exchange sums within 1e-4 of their largest entry and its log psi within
    1e-5 per site."""
    _, params, model = _pair(N, units=(u,), seed=31)
    weights = tuple(w.detach() for w in model.weights())
    samples = sector_samples(B, N, seed=32)
    info = J1J2(N, j2=j2, periodic=periodic, marshall_sign=periodic).exchange_kernel_info
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(t) for t in jj1j2_exchange_offdiag(
            params, jnp.asarray(samples), u1=True, **info)]
    got, tiles, bonds = _emulated_exchange(weights, torch.from_numpy(samples), True, **info,
                                           layout=layout)
    for a, ref in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())))
    for a, ref in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-5 * N)
    # the port's plain B10 (every exchanged configuration in full) agrees too
    plain = jk.exchange_offdiag_plain(weights, torch.from_numpy(samples), u1=True, **info)
    for a, ref in zip(got[:2], plain[:2]):
        np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * max(1.0, float(ref.abs().max())))
    # the tiles are what the test claims: packed tiles span several start
    # sites (so rows join late), the first design's hold one; with J2 != 0 a
    # tile holds NN and NNN trajectories, and the wraps sit with site 0's
    starts = [{a for a, _, _, _ in rows} for rows in tiles]
    if layout == "packed":
        assert any(len(a) > 1 for a in starts)
    else:
        assert all(len(a) == 1 for a in starts)
    kinds = [{bonds[k][2] for _, k, _, _ in rows} for rows in tiles]
    assert any(len(kind) == 2 for kind in kinds) == (j2 != 0.0)
    if periodic:
        assert any(a == 0 and bonds[k][1] == N - 1 for rows in tiles for a, k, _, _ in rows)


def _rs_heads(aw, pw, ks):
    """The heads as the turned-around suffix pass's table: entry
    ((j 4 + t) 2 + head) 4 + 2 v + l is logit l of head (amplitude, phase)
    on unit 8 j + 2 t + v, zero past U."""
    u = aw.shape[0]
    table = torch.zeros(32 * ks, dtype=aw.dtype)
    for i in range(32 * ks):
        unit = 8 * (i >> 5) + 2 * ((i >> 3) & 3) + ((i >> 1) & 1)
        if unit < u:
            table[i] = (pw if (i >> 2) & 1 else aw)[unit, i & 1]
    return table


@pytest.mark.parametrize("u", [7, 16, 41, 50, 56])
def test_turned_around_heads_sum_within_the_quad(u):
    """Thread (w, g, t) of the turned-around pass holds the states of rows
    16 w + g (+8) at units 8 j + 2 t + v; it sums hv . [amplitude | phase]
    over those units in order from the head table, and two shuffles within
    the quad (lane ^ 1, then lane ^ 2) give every lane of the quad both rows'
    four logits: h . [aw | pw]."""
    ks = -(-u // 8)
    gen = torch.Generator().manual_seed(u)
    aw, pw = torch.randn(2, u, 2, generator=gen, dtype=torch.float64)
    h = torch.randn(64, u, generator=gen, dtype=torch.float64)
    table = _rs_heads(aw, pw, ks).view(ks, 4, 2, 2, 2)  # [j][t][head][v][l]
    want = h @ torch.cat([aw, pw], dim=1)
    for w in range(4):
        for g in range(8):
            part = torch.zeros(4, 2, 4, dtype=torch.float64)  # [t][rh][logit]
            for t in range(4):
                for j in range(ks):
                    for v in range(2):
                        unit = 8 * j + 2 * t + v
                        if unit >= u:
                            assert float(table[j, t, :, v].abs().sum()) == 0.0
                            continue
                        for rh in range(2):
                            hv = h[16 * w + g + 8 * rh, unit]
                            part[t, rh] += hv * table[j, t, :, v].reshape(4)
            once = part + part[[1, 0, 3, 2]]
            quad = once + once[[2, 3, 0, 1]]
            for t in range(4):
                assert torch.equal(quad[t], quad[0])
                for rh in range(2):
                    torch.testing.assert_close(quad[t, rh], want[16 * w + g + 8 * rh])


def test_emulated_base_pass_matches_jax_log_amp():
    """The sliced base pass alone (B8's and B11's, teacher-forced here) gives
    the JAX model's (Re, Im) log psi within 1e-5 per site: with the mask on
    zero-magnetisation samples, and with it off on random samples at an even
    and an odd N."""
    rng = np.random.default_rng(34)
    for n, u1 in ((N, True), (N, False), (N - 1, False)):
        jans, params, model = _pair(n, units=(U,), u1=u1, seed=33)
        weights = tuple(w.detach() for w in model.weights())
        samples = (sector_samples(B, n, seed=35) if u1
                   else rng.integers(0, 2, (B, n)).astype(np.int32))
        _, re, im = _emulated_base(weights, torch.from_numpy(samples), u1)
        want_re, want_im = jans.log_amp_parts(params, jnp.asarray(samples))
        np.testing.assert_allclose(re.numpy(), np.asarray(want_re), rtol=0, atol=1e-5 * n)
        np.testing.assert_allclose(im.numpy(), np.asarray(want_im), rtol=0, atol=1e-5 * n)
