"""The work of one VMC step of the complex U(1) cRNN on the open J1-J2
chain (``reference/crnn_chain.py``, ``reference/j1j2.py``), counted as
``roofline.py`` counts the GRU chain: from shapes, for what the algorithm
needs.

A cRNN site is the GRU site's product and gate arithmetic, then two heads
(amplitude and phase, U x 2 each), the amplitude's log-softmax, the U(1)
mask and renormalisation, and the phase's softsign.

The estimator's suffix work depends on the samples: exchanging the
anti-aligned pair (a, b) recomputes the sites after a, N - 1 - a site steps,
and an aligned pair costs nothing.  It is counted at the U(1) sector's
uniform expectation: a pair of distinct sites is anti-aligned with
probability N / (2 (N - 1)), about half, so of the N - 1 NN and N - 2 NNN
pairs about N - 1/2 are exchanged a sample, each suffix weighted alike.  A
Néel-like chain (every NN pair anti-aligned, no NNN pair) needs the same
suffix steps to within 1/N.  On the way between the two, training passes
through chains with more exchanged pairs than either: on the benchmark's
J1-J2 cell the NN share reaches ~0.79 and the NNN share ~0.39 within one
35-s window, ~18% more suffix work than counted here, so late in a window
the estimator's roofline share reads low by up to that much; in the first
steps the shares lie within ~3% of the uniform one.
"""

from __future__ import annotations

from typing import Dict

from ..roofline import F32, Work, optimizer_work, scaled


def crnn_params(u: int) -> int:
    """wx (2, 3U), wh (U, 3U), bx, bh (3U), and two heads of w (U, 2) and
    b (2)."""
    return 3 * u * u + 16 * u + 4


def crnn_site(u: int) -> Work:
    """One cRNN site step of one trajectory: the 3U x U recurrent product,
    about ten operations per gate entry, the two heads' U x 2 products, and
    about thirty for the log-softmax, the mask, the renormalisation and the
    softsign."""
    return Work(6 * u * u, 30 * u + 8 * u + 30)


def crnn_vjp_site(u: int) -> Work:
    """One site of the (Re, Im) log psi VJP after the forward step: the
    transposed product for the recurrent cotangent and the outer product
    for the weight cotangent (two 3U x U products), the gates' elementwise
    chains, and both heads' transposed and outer products."""
    return Work(12 * u * u, 30 * u + 16 * u + 20)


def anti_aligned_share(n: int) -> float:
    """The probability that two distinct sites of a uniformly drawn
    zero-magnetisation chain of even length n differ."""
    return n / (2.0 * (n - 1))


def expected_anti_aligned(n: int) -> float:
    """The expected anti-aligned NN and NNN pairs of such a chain."""
    return (2 * n - 3) * anti_aligned_share(n)


def expected_suffix_sites(n: int) -> float:
    """The expected suffix site steps of one sample: N - 1 - a for each
    anti-aligned pair starting at a, over the N - 1 NN and N - 2 NNN pairs."""
    nn = n * (n - 1) // 2          # sum over a < N - 1 of N - 1 - a
    nnn = nn - 1                   # sum over a < N - 2 of N - 1 - a
    return (nn + nnn) * anti_aligned_share(n)


def step_work(lattice: Dict, traffic: Dict, units: int) -> Dict[str, Work]:
    """Per layer, the work of one Adam step of the cRNN on the J1-J2 chain."""
    n, s, u = lattice["num_sites"], traffic["num_samples"], units
    p = crnn_params(u)
    if traffic["optimizer"] != "adam":
        raise ValueError("the cRNN's work is counted for Adam steps")
    return {
        # S N base site steps, then the exchanged pairs' suffixes; reads the
        # weights, writes the samples and each sample's complex E_loc and
        # log psi
        "estimator": scaled(crnn_site(u), s * n + s * expected_suffix_sites(n))
        + Work(0, 0, F32 * (s * n + p + 4 * s)),
        "gradient": scaled(crnn_site(u) + crnn_vjp_site(u), s * n)
        + Work(0, 0, F32 * (s * n + 2 * s + 2 * p)),
        "optimizer": optimizer_work("adam", p),
    }
