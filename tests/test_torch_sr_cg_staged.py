"""PyTorch port: the arithmetic of B21's block and cluster paths
(``csrc/sr_cg.cu::cg_cluster_kernel``), emulated on the CPU and held against
the JAX package's ``cg_solve_jnp`` and its Pallas kernel in interpret mode,
so that the kernel's order of summation is known to meet the tolerance
before any card runs it.

Every warp keeps p and r in registers, lane l holding entries l + 32 q (q
below S / 32 rounded up to a power of two, the padding zero).  A dot
product is a multiply-add chain per lane in q order, then the xor
butterfly over the 32 lanes; a row of T p is the same chain over the row's
entries.  The rows are split as ``cg_plan`` splits them: one block up to
S = 64, else a cluster of n = 4 blocks up to S = 256 and of 8 up to 512,
each block owning pad4(ceil(S / n)) rows (at most 64) and the last the
rest; entry k of x belongs to warp (k / 32) mod 16 of the block that owns
row k.  One step:
T p; alpha = r.r / max(p.Tp, 1e-30); x += alpha p; r -= alpha T p; beta =
r.r (new) / max(r.r (old), 1e-30); p = beta p + r; each multiply-add
rounded once (in float64, then to float32).  The row split changes who
computes a row, not its value: the emulation checks that the split covers
every row and entry of x once, and over every S a cluster takes that each
block owns at least one row.

Systems: S=64 and S=8 on one block, S=100 on a cluster of 4 (28 rows a
block, the last 16) and S=260 on a cluster of 8 (36 rows a block, the last
8), seeded with numpy; the exact convergence guard.  Tolerance:
tests/test_torch_sr_cg.py's, 1e-5 of the solution's norm plus 1e-6
absolute.  The helpers live here and nothing on the port's path imports
them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu.ops import sr_cg as jsr_cg

torch.set_num_threads(1)

WARPS = 16  # warps of a block (512 threads)


def _spd(s, seed, cond_boost=0.0):
    """An SR-Gram-like SPD system from a numpy seed: A A^T / (2S) + 1e-2 I,
    optionally with one dominant direction, and a right-hand side."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((s, 2 * s))
    t = a @ a.T / (2 * s) + 1e-2 * np.eye(s)
    if cond_boost:
        v = rng.standard_normal((s, 1))
        v /= np.linalg.norm(v)
        t += cond_boost * (v @ v.T)
    return t.astype(np.float32), rng.standard_normal(s).astype(np.float32)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(v):
    """The xor butterfly over the last axis (32 lanes) in float32."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _lanes(v, kmax):
    """(S,) -> the register layout (32, kmax): entry lane + 32 q, zero-padded."""
    out = torch.zeros(32 * kmax)
    out[: v.shape[0]] = v
    return out.reshape(kmax, 32).T.contiguous()


def _dot(a, b):
    """A warp's dot product of two (32, kmax) register copies."""
    v = torch.zeros(32)
    for q in range(a.shape[1]):
        v = _fma(a[:, q], b[:, q], v)
    return _butterfly(v)


def _pad4(n):
    return (n + 3) & ~3


def split(s):
    """(blocks, rows a block) as cg_plan chooses them: one block up to 64
    rows, else a cluster of 4 up to 4 x 64 rows, else of 8."""
    if s <= 64:
        return 1, s
    assert s <= 512, "past S = 512 the grid path runs"
    n = 4 if s <= 256 else 8
    return n, _pad4(-(-s // n))


def _owners(s, ctas, rows_per_cta, kmax):
    """How often the split assigns each row of T p and each entry of x, and
    the rows of each block: rows [rank * rows_per_cta, ...) to block rank
    (cta_rows), and entry k = lane + 32 q of x to warp q mod 16 of the
    block that owns row k."""
    rows, xs = torch.zeros(s, dtype=torch.int64), torch.zeros(32 * kmax, dtype=torch.int64)
    k = torch.arange(32 * kmax).reshape(kmax, 32)
    q = torch.arange(kmax)[:, None].expand(kmax, 32)
    owned = []
    for rank in range(ctas):
        row0 = rank * rows_per_cta
        n_rows = min(max(s - row0, 0), rows_per_cta)
        owned.append(n_rows)
        rows[row0:row0 + n_rows] += 1
        for warp in range(WARPS):
            mine = (q % WARPS == warp) & (k >= row0) & (k < row0 + n_rows)
            xs += mine.reshape(-1).long()
    return rows, xs[:s], owned


def cluster_cg(t, c, iters):
    """The block or cluster path's CG, split as cg_plan splits S; returns
    x (S,)."""
    s = c.shape[0]
    kmax = 1 << max(1, (-(-s // 32) - 1).bit_length())  # the kernel's KMAX
    rows, xs, _ = _owners(s, *split(s), kmax)
    assert torch.equal(rows, torch.ones(s, dtype=torch.int64))
    assert torch.equal(xs, torch.ones(s, dtype=torch.int64))
    t_lanes = torch.stack([_lanes(t[i], kmax) for i in range(s)])  # (S, 32, kmax)
    r = _lanes(c, kmax)
    p = r.clone()
    x = torch.zeros(32, kmax)
    rs = _dot(r, r)
    for _ in range(iters):
        acc = torch.zeros(s, 32)
        for q in range(kmax):
            acc = _fma(t_lanes[:, :, q], p[:, q], acc)
        tp = _lanes(_butterfly(acc), kmax)
        alpha = rs / torch.clamp_min(_dot(p, tp), 1e-30)
        x = _fma(alpha, p, x)  # each entry by its one owner thread
        r = _fma(-alpha, tp, r)
        rs_new = _dot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = _fma(beta, p, r)
        rs = rs_new
    return x.T.reshape(-1)[:s]


def _assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.linalg.norm(want) + 1e-6)


def test_split_covers_every_row_once():
    """Over every S a cluster takes (65 to 512), each row of T p and each
    entry of x has one owner and no block of the cluster owns no rows; the
    systems below split as stated."""
    for s in range(65, 513):
        ctas, rows_per_cta = split(s)
        kmax = 1 << max(1, (-(-s // 32) - 1).bit_length())
        rows, xs, owned = _owners(s, ctas, rows_per_cta, kmax)
        assert ctas in (4, 8) and rows_per_cta % 4 == 0 and rows_per_cta <= 64
        assert torch.equal(rows, torch.ones(s, dtype=torch.int64))
        assert torch.equal(xs, torch.ones(s, dtype=torch.int64))
        assert min(owned) >= 1, (s, owned)
    assert split(64) == (1, 64) and split(65) == (4, 20) and split(256) == (4, 64)
    assert split(257) == (8, 36)
    assert _owners(100, *split(100), 4)[2] == [28, 28, 28, 16]
    assert _owners(260, *split(260), 16)[2] == [36] * 7 + [8]


@pytest.mark.parametrize("s", [64, 100, 260, 8],
                         ids=["S64-block", "S100-cluster4", "S260-cluster8", "S8-block"])
def test_cluster_cg_matches_jax(s):
    t, c = _spd(s, 3, cond_boost=10.0)
    got = cluster_cg(torch.from_numpy(t), torch.from_numpy(c), 48).numpy()
    _assert_close(got, jsr_cg.cg_solve_jnp(jnp.asarray(t), jnp.asarray(c), iters=48))
    _assert_close(got, jsr_cg.sr_cg_solve(jnp.asarray(t), jnp.asarray(c), iters=48,
                                          interpret=True))


@pytest.mark.parametrize("s", [8, 100, 260])
def test_cluster_cg_exact_convergence_guard(s):
    """2 I x = 1 converges in one step; the 1e-30 guards then freeze the
    iterate instead of dividing 0 by 0, on one block and over clusters of
    4 and 8."""
    t, c = 2.0 * np.eye(s, dtype=np.float32), np.ones(s, dtype=np.float32)
    want = np.asarray(jsr_cg.sr_cg_solve(jnp.asarray(t), jnp.asarray(c), iters=64,
                                         interpret=True))
    got = cluster_cg(torch.from_numpy(t), torch.from_numpy(c), 64).numpy()
    np.testing.assert_array_equal(got, np.full(s, 0.5, np.float32))
    np.testing.assert_array_equal(got, want)
