"""The least time of a VMC step's work on one H100: the yardstick of every
roofline share and of ``step_mfu_pct``.

Work is counted from shapes, for what the algorithm needs, never for what a
kernel happens to do (a replay stored and read back, a product issued three
times by a 3xTF32 split).  Each layer's work is three numbers:

* ``tc_flops``: the operations of matrix products (the recurrent products,
  the weight-cotangent outer products, the jacobian rows' contraction, the
  Gram and the back-contraction), at the TF32 tensor-core peak, since a
  kernel may move any of them onto the tensor cores;
* ``fp32_flops``: every other operation (input gates, activations, the
  update, the heads and their log-softmax, the CG solve, the optimizer), at
  the FP32 peak outside the tensor cores;
* ``nbytes``: each input read once and each output written once.

A layer's least time is its operations' time, or its bytes' time where that
is longer.  No kernel can beat it, so a share of it cannot pass 100%.

The site counts follow ``chip_smoke.py`` (``site_flops``,
``bwd_site_flops``, ``mdrnn_site_flops``, ``mdrnn_bwd_site_flops``,
``jac_sweep_site_flops``, ``tc_bound``, ``mdrnn_tc_bound``), frozen here;
its FP32-only ``bound`` is not used, since a tensor-core kernel beats it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4  # bytes of a float32 or an int32


@dataclasses.dataclass(frozen=True)
class Work:
    tc_flops: float = 0.0
    fp32_flops: float = 0.0
    nbytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.tc_flops + other.tc_flops, self.fp32_flops + other.fp32_flops,
                    self.nbytes + other.nbytes)

    def least_s(self) -> float:
        """The least time in seconds: operations at their peaks, or bytes at
        the memory rate where that is longer."""
        ops = self.tc_flops / TF32_FLOPS + self.fp32_flops / FP32_FLOPS
        return max(ops, self.nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# the GRU chain (PRNN1D, one GRU layer, one 2-logit head)
# ---------------------------------------------------------------------------

def gru_params(u: int) -> int:
    """wx (2, 3U), wh (U, 3U), bx, bh (3U), head w (U, 2), head b (2)."""
    return 3 * u * u + 14 * u + 2


def gru_site(u: int) -> Work:
    """One GRU site step of one trajectory: the 3U x U recurrent product,
    then about ten operations per gate entry (input gates, activations,
    update) and the head's U x 2 product and log-softmax."""
    return Work(6 * u * u, 30 * u + 4 * u + 10)


def gru_vjp_site(u: int) -> Work:
    """One site of the log p VJP after the forward step: the transposed
    product for the recurrent cotangent and the outer product for the
    weight cotangent (two 3U x U products), and the elementwise chains."""
    return Work(12 * u * u, 30 * u + 8 * u + 10)


def gru_reverse_site(u: int) -> Work:
    """One reverse site of the jacobian sweep: the recurrent cotangent's
    3U x U product and its elementwise chain."""
    return Work(6 * u * u, 30 * u)


def scaled(w: Work, n: float) -> Work:
    return Work(w.tc_flops * n, w.fp32_flops * n, w.nbytes * n)


def optimizer_work(optimizer: str, p: int) -> Work:
    """Adam: about twelve operations a parameter, reading p, g, m, v and
    writing p, m, v; SGD: two, reading p, g and writing p."""
    if optimizer == "adam":
        return Work(0, 12 * p, 7 * F32 * p)
    return Work(0, 2 * p, 3 * F32 * p)


def minsr_work(s: int, p: int, rows: Work, cg_iters: int) -> Work:
    """The minSR direction after its per-sample rows: centring (S, P), the
    Gram (S, S) and the back-contraction (P,) as products, the CG solve of
    ``cg_iters`` steps of 2S^2 + 10S."""
    return rows + Work(2 * s * s * p + 2 * s * p,
                       2 * s * p + cg_iters * (2 * s * s + 10 * s))


def gru_chain_step_work(lattice: Dict, traffic: Dict, units: int) -> Dict[str, Work]:
    """Per layer, the work of one VMC step of the GRU chain on the TFIM."""
    n, s, u = lattice["num_sites"], traffic["num_samples"], units
    p = gru_params(u)
    io = Work(0, 0, F32 * (s * n + p))  # the samples and the weights
    work = {
        # S N base site steps, then per sample N (N - 1) / 2 suffix steps
        "estimator": scaled(gru_site(u), s * n + s * n * (n - 1) // 2)
        + Work(0, 0, F32 * (s * n + p + 2 * s)),
        "optimizer": optimizer_work(traffic["optimizer"], p),
    }
    if traffic["optimizer"] == "minsr":
        sweep = scaled(gru_site(u) + gru_reverse_site(u), s * n)
        # the rows: per sample [h_{n-1} | 1 | 1 - s | s] (N + 1, U + 3)
        # against the gate cotangents (N + 1, 3U), and the head's h (x) dl
        contract = Work(s * (2 * (n + 1) * (u + 3) * 3 * u + 4 * u * n))
        work["minsr"] = minsr_work(s, p, sweep + contract, traffic["sr_cg_iters"]) \
            + io + Work(0, 0, F32 * (s + p))
    else:
        work["gradient"] = scaled(gru_site(u) + gru_vjp_site(u), s * n) + io \
            + Work(0, 0, F32 * (s + p))
    return work


# ---------------------------------------------------------------------------
# the MDRNN lattice (MDRNN2D, one cell, one 2-logit head)
# ---------------------------------------------------------------------------

def mdrnn_params(u: int) -> int:
    """uh, uv (2, U), wh, wv (U, U), b (U), head w (U, 2), head b (2)."""
    return 2 * u * u + 7 * u + 2


def mdrnn_site(u: int) -> Work:
    """One MDRNN site step of one trajectory: the two U x U products, then
    about twelve operations a unit (input terms, activation, the head) and
    the log-softmax."""
    return Work(4 * u * u, 12 * u + 10)


def mdrnn_vjp_site(u: int) -> Work:
    """One site of the MDRNN log p VJP after the forward step: the two
    transposed products for the cotangents along both links and the two
    outer products for the weight cotangents, and the elementwise chains."""
    return Work(8 * u * u, 28 * u + 10)


def mdrnn_lattice_step_work(lattice: Dict, traffic: Dict, units: int) -> Dict[str, Work]:
    """Per layer, the work of one VMC step of the MDRNN on the grid TFIM."""
    ns, s, u = lattice["nx"] * lattice["ny"], traffic["num_samples"], units
    p = mdrnn_params(u)
    if traffic["optimizer"] != "adam":
        raise ValueError("the MDRNN's work is counted for Adam steps")
    return {
        # S NS base site steps, then per sample NS (NS - 1) / 2 suffix steps:
        # h_f does not depend on the spin at f, so a flip at f recomputes
        # the sites after f alone, as on the chain
        "estimator": scaled(mdrnn_site(u), s * ns + s * ns * (ns - 1) // 2)
        + Work(0, 0, F32 * (s * ns + p + 2 * s)),
        "gradient": scaled(mdrnn_site(u) + mdrnn_vjp_site(u), s * ns)
        + Work(0, 0, F32 * (s * ns + s + 2 * p)),
        "optimizer": optimizer_work("adam", p),
    }


STEP_WORK = {"gru_chain": gru_chain_step_work, "mdrnn_lattice": mdrnn_lattice_step_work}


def step_work(config: Dict, traffic: Dict) -> Dict[str, Work]:
    """The work of one step of the configuration ``config`` under
    ``traffic``, per layer.  An architecture not counted here is counted by
    ``step_work`` in ``benchmark/work/<architecture>.py``."""
    arch = config["reference"]["model"]
    fn = STEP_WORK.get(arch)
    if fn is None:
        fn = importlib.import_module(f"benchmark.work.{arch}").step_work
    return fn(traffic["lattice"], traffic, config["units"])


def least_s(work: Dict[str, Work]) -> Dict[str, float]:
    return {layer: w.least_s() for layer, w in work.items()}
