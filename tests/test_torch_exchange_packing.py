"""PyTorch port: how B10/B11's turned-around suffix pass packs the bond lists
into tiles (``suffix_tiles`` below; ``ops/j1j2_exchange_kernel.py``:
``list_lengths``, ``suffix_occupancy``; the kernel is
``csrc/j1j2_exchange.cu::exchange_suffix_rs_kernel``).  A tile is 64
consecutive terms of all start sites' lists taken in start-site order; a
row whose start lies past the tile's first start idles until it joins, so
the share of issued row-sites that carry a live trajectory is the pass's
occupancy.  Pure functions on the CPU; no JAX.
"""

import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu_torch import J1J2
from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk

ROWS = jk.SUFFIX_ROWS


def suffix_tiles(counts):
    """The tiles of the packed suffix pass: consecutive runs of ROWS terms of
    all start sites' lists, taken in start-site order, each row (start site,
    index in its list, listed?); padding rows repeat the last term,
    unlisted."""
    flat = [(a, i) for a, c in enumerate(int(c) for c in counts) for i in range(c)]
    tiles = []
    for p0 in range(0, len(flat), ROWS):
        tile = [(*flat[p], True) for p in range(p0, min(p0 + ROWS, len(flat)))]
        tiles.append(tile + [(*flat[-1], False)] * (ROWS - len(tile)))
    return tiles


def _zero_magnetisation(b, n, nn_share, nnn_share, seed):
    """(b, n) chains with N/2 ups whose NN and NNN anti-aligned shares are
    about nn_share and nnn_share: a spin flips against its left neighbour
    with a probability that depends on whether that neighbour flipped (a
    stationary second-order chain), kept where the magnetisation is zero."""
    rng = np.random.default_rng(seed)
    keep_after_flip = 1.0 - nnn_share / (2.0 * nn_share)   # P(flip | flip)
    after_stay = nn_share * (1.0 - keep_after_flip) / (1.0 - nn_share)  # P(flip | no flip)
    got = []
    while sum(len(c) for c in got) < b:
        u = rng.random((4096, n - 1))
        flip = np.empty((4096, n - 1), dtype=np.int64)
        prev = rng.random(4096) < nn_share
        for i in range(n - 1):
            prev = u[:, i] < np.where(prev, keep_after_flip, after_stay)
            flip[:, i] = prev
        s0 = rng.integers(0, 2, (4096, 1))
        chains = np.concatenate([s0, (s0 + np.cumsum(flip, axis=1)) % 2], axis=1)
        got.append(chains[chains.sum(axis=1) == n // 2])
    return torch.from_numpy(np.concatenate(got)[:b].astype(np.int32))


def _per_start_occupancy(counts, rows):
    """The first design's packing: each start site's list in tiles of its own."""
    n = len(counts)
    live = sum(int(c) * (n - 1 - a) for a, c in enumerate(counts))
    issued = sum(-(-int(c) // rows) * rows * (n - 1 - a) for a, c in enumerate(counts))
    return live / issued


@pytest.mark.parametrize("counts", [[3, 0, 70, 64, 1, 0, 129, 5, 0], [64] * 7 + [0],
                                    [0, 0, 1, 0], [200, 0, 0, 0, 0, 0]])
def test_suffix_tiles_hold_every_listed_term_once_in_start_order(counts):
    tiles = suffix_tiles(counts)
    rows = [row for tile in tiles for row in tile]
    assert all(len(tile) == ROWS for tile in tiles)
    listed = [(a, i) for a, i, live in rows if live]
    assert sorted(listed) == [(a, i) for a, c in enumerate(counts) for i in range(c)]
    assert listed == sorted(listed)  # in start-site order, each list in its own order
    assert all(not live for _, _, live in rows[len(listed):])  # only the last tile pads
    assert all((a, i) == listed[-1] for a, i, live in rows if not live)


@pytest.mark.parametrize("counts", [[3, 0, 70, 64, 1, 0, 129, 5, 0], [64] * 7 + [0],
                                    [0, 0, 1, 0]])
def test_suffix_occupancy_counts_the_tiles_row_sites(counts):
    """Live trajectory-sites over issued row-sites, counted row by row from
    the tiles: every row of a tile runs from its first start site on."""
    n = len(counts)
    tiles = suffix_tiles(counts)
    live = sum(n - 1 - a for tile in tiles for a, _, on in tile if on)
    issued = sum(ROWS * (n - 1 - tile[0][0]) for tile in tiles)
    assert jk.suffix_occupancy(counts) == pytest.approx(live / issued, rel=1e-12)
    assert jk.suffix_occupancy(torch.tensor(counts)) == jk.suffix_occupancy(counts)


def test_suffix_occupancy_of_an_empty_list_and_of_one_term():
    assert suffix_tiles([0, 0, 0]) == []
    assert jk.suffix_occupancy([0, 0, 0]) == 1.0
    tiles = suffix_tiles([0, 1, 0, 0])
    assert len(tiles) == 1 and tiles[0][0] == (1, 0, True)
    assert tiles[0][1:] == [(1, 0, False)] * (ROWS - 1)
    assert jk.suffix_occupancy([0, 1, 0, 0]) == pytest.approx(1.0 / ROWS)


@pytest.mark.parametrize("nn_share,nnn_share", [(0.5, 0.5), (0.79, 0.39)],
                         ids=["window_start", "after_a_window"])
def test_packed_tiles_fill_the_rows_at_the_cell(nn_share, nnn_share):
    """At the J1-J2 cell's N=1000, S=64 (open chain, J2 = 0.2) the packed
    tiles keep at least 0.97 of their row-sites live, with the anti-aligned
    shares of a window's start (random zero-magnetisation chains, 0.5 and
    0.5) and of its end (0.79 NN, 0.39 NNN); one start site's tiles of 32
    would keep ~0.8 and of 64 under 0.7."""
    n, s = 1000, 64
    if nn_share == 0.5:
        gen = torch.Generator().manual_seed(8)
        samples = (torch.rand(s, n, generator=gen).argsort(dim=1) < n // 2).to(torch.int32)
    else:
        samples = _zero_magnetisation(s, n, nn_share, nnn_share, seed=9)
    assert bool((samples.sum(dim=1) == n // 2).all())
    f = samples.to(torch.float64)
    assert float((f[:, 1:] != f[:, :-1]).double().mean()) == pytest.approx(nn_share, abs=0.02)
    assert float((f[:, 2:] != f[:, :-2]).double().mean()) == pytest.approx(nnn_share, abs=0.02)
    counts = jk.list_lengths(samples, **J1J2(n, j2=0.2).exchange_kernel_info)
    assert jk.suffix_occupancy(counts) >= 0.97
    assert _per_start_occupancy(counts.tolist(), 32) < 0.85
    assert _per_start_occupancy(counts.tolist(), 64) < 0.7


@pytest.mark.parametrize("periodic,j2", [(False, 0.0), (False, 0.2), (True, 0.0), (True, 0.2)])
def test_list_lengths_count_each_start_sites_exchanged_bonds(periodic, j2):
    """Against the Hamiltonian's own exchanges: a term per anti-aligned
    bond (i, i + gap mod N) with a nonzero element, at its lower site."""
    n = 9
    gen = torch.Generator().manual_seed(4)
    samples = (torch.rand(20, n, generator=gen) < 0.5).to(torch.int32)
    ham = J1J2(n, j2=j2, periodic=periodic)
    mask = ham.connected(samples)[3]
    want = torch.zeros(n, dtype=torch.int64)
    for col in range(2 * n):
        gap, i = divmod(col, n)
        want[min(i, (i + gap + 1) % n)] += int(mask[:, col].sum())
    assert torch.equal(jk.list_lengths(samples, **ham.exchange_kernel_info), want)
