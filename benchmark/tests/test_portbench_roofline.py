"""The frozen least-time arithmetic: exact operation and byte counts of
each cell's step, and each recurrent product counted once at the TF32
peak, so that no kernel can read over 100%."""

import json

import pytest

from benchmark import roofline
from benchmark.spec import ROOT, load_cell

U = 50
P_GRU = 3 * U * U + 14 * U + 2        # 8202
P_MDRNN = 2 * U * U + 7 * U + 2       # 5352

# cell, or a mix no cell runs yet -> layer -> (tc_flops, fp32_flops, bytes),
# written out from the shapes
EXPECTED = {
    "tfim1d_n100_s500_adam": {
        # 500 * 100 base + 500 * 100 * 99 / 2 suffix site steps
        "estimator": (2_525_000 * 6 * U * U, 2_525_000 * (34 * U + 10),
                      4 * (500 * 100 + P_GRU + 2 * 500)),
        # 500 * 100 (sample, site) pairs: replay 6U^2 + VJP 12U^2
        "gradient": (50_000 * 18 * U * U, 50_000 * (72 * U + 20),
                     4 * (500 * 100 + P_GRU) + 4 * (500 + P_GRU)),
        "optimizer": (0, 12 * P_GRU, 28 * P_GRU),
    },
    "mdrnn_16x16_adam": {
        # 500 * 256 base + 500 * 256 * 255 / 2 suffix site steps
        "estimator": (16_448_000 * 4 * U * U, 16_448_000 * (12 * U + 10),
                      4 * (500 * 256 + P_MDRNN + 2 * 500)),
        "gradient": (128_000 * 12 * U * U, 128_000 * (40 * U + 20),
                     4 * (500 * 256 + 500 + 2 * P_MDRNN)),
        "optimizer": (0, 12 * P_MDRNN, 28 * P_MDRNN),
    },
    "tfim1d_n1000_minsr": {
        "estimator": (32_032_000 * 6 * U * U, 32_032_000 * (34 * U + 10),
                      4 * (64 * 1000 + P_GRU + 2 * 64)),
        # jacobian sweep 12U^2 per (sample, site), rows 2 (N+1)(U+3) 3U + 4UN
        # per sample, Gram 2 S^2 P and back-contraction 2 S P; elementwise
        # forward 34U + 10 and reverse 30U, centring 2SP, 64 CG steps
        "minsr": (64_000 * 12 * U * U + 64 * (2 * 1001 * 53 * 150 + 4 * U * 1000)
                  + 2 * 64 * 64 * P_GRU + 2 * 64 * P_GRU,
                  64_000 * (64 * U + 10) + 2 * 64 * P_GRU + 64 * (2 * 64 * 64 + 640),
                  4 * (64 * 1000 + P_GRU) + 4 * (64 + P_GRU)),
        "optimizer": (0, 2 * P_GRU, 12 * P_GRU),
    },
}

# the flagship chain at S=500, which no cell runs yet (PERF.md, open
# questions): its counts are frozen with the rest
FLAGSHIP = {"lattice": {"num_sites": 100}, "num_samples": 500, "optimizer": "adam",
            "learning_rate": 0.005, "log_every": 10, "warmup_blocks": 1, "check_steps": 3}


def _work(name):
    if name == "tfim1d_n100_s500_adam":
        config = json.loads((ROOT / "benchmark/configs/prnn1d_gru50_tfim1d.json").read_text())
        return roofline.step_work(config, FLAGSHIP)
    c = load_cell(name)
    return roofline.step_work(c.config, c.traffic)


@pytest.mark.parametrize("cell", sorted(EXPECTED))
def test_counts_of_each_cell_are_exact(cell):
    work = _work(cell)
    assert sorted(work) == sorted(EXPECTED[cell])
    for layer, (tc, fp32, nbytes) in EXPECTED[cell].items():
        w = work[layer]
        assert (w.tc_flops, w.fp32_flops, w.nbytes) == (tc, fp32, nbytes), layer


@pytest.mark.parametrize("cell", sorted(EXPECTED))
def test_products_count_once_at_the_tf32_peak(cell):
    """Every layer is bound by its operations, at TF32 for the products and
    FP32 for the rest: below a kernel that ran its products once on the
    tensor cores and everything else at the FP32 peak, and below the
    FP32-only bound that a tensor-core kernel beats."""
    for layer, w in _work(cell).items():
        ops = w.tc_flops / roofline.TF32_FLOPS + w.fp32_flops / roofline.FP32_FLOPS
        assert w.least_s() == pytest.approx(max(ops, w.nbytes / roofline.HBM_BYTES_PER_S))
        fp32_only = (w.tc_flops + w.fp32_flops) / roofline.FP32_FLOPS
        if w.tc_flops:
            assert w.least_s() < fp32_only


def test_estimator_least_times_of_the_cells():
    """The estimator's least time per step, the number its roofline share
    divides: TC products at 495 TFLOP/s, the rest at 67 TFLOP/s."""
    got = {cell: _work(cell)["estimator"].least_s() for cell in EXPECTED}
    steps = {"tfim1d_n100_s500_adam": 2_525_000, "tfim1d_n1000_minsr": 32_032_000}
    for cell, n in steps.items():
        assert got[cell] == pytest.approx(n * (6 * U * U / 495e12 + (34 * U + 10) / 67e12))
    assert got["mdrnn_16x16_adam"] == pytest.approx(
        16_448_000 * (4 * U * U / 495e12 + (12 * U + 10) / 67e12))
