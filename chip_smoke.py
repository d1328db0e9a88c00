"""Drives the PyTorch port's main path on one CUDA card and checks it.

    python3 chip_smoke.py

Phases (each prints its time; any failure raises and exits non-zero):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the CUDA kernels from ``rnnwavefunctions_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card at the flagship
   shapes (N=100, U=50, B=500; parameters drawn from a seeded generator),
   every max error printed beside its tolerance; the K3 sampler's
   frequencies at N=3 against the exact density; K4 and B6a at the suffix
   pass's edges (B = 1, 64, 65 and the N=1000 chain's S=64; U = 56, the
   turned-around pass's widest, 57 and 120 on the first suffix pass), each
   also on its rows permuted, which must give each sample the same bits;
   K3 and B6b at N=1000, S=64 (B6b K3's draws, and B6a's lpf on them).
3. Each kernel and its plain version timed with CUDA events; K3's three
   launches (base pass, suffix pass, ratio sum; at N=100 and at N=1000,
   S=64, where the suffix pass must be ``flip_suffix_rs_kernel``) and K2's
   four (the replay, the reverse sweep, the weight cotangent, the chunk sum)
   timed apart by ``torch.profiler``, beside their FP32 and (K3)
   tensor-core bounds; K2 from K1's stored replay, as the training step
   runs it.
4. VMC training of the 1D TFIM at N=10 (300 steps, impl "auto") against
   exact diagonalization; all four kernels must have launched.
5. 50 steps of the flagship (N=100, one GRU layer of 50 units, S=500, Adam
   at lr 5e-3): steps/s and the first and last energies, which must be
   finite and falling.
6. The J1-J2 kernels B7 (mask on and off, also at the cRNN family's widest
   U), B9 (alone and from its replay, which the step
   runs as its forward; the same bits twice and from the replay; the
   replay's outputs against its plain twin), B10 and B11 against their
   plain versions at the J1-J2 flagship shapes (N=100, U=50, B=500,
   perturbed weights) for (open, no Marshall sign, J2=0.2), (periodic,
   Marshall sign, J2=0.2) and (open, J2=0); B11's samples in the
   zero-magnetisation sector, its (Re, Im) log psi equal to B7's on them
   bit for bit (one base pass, teacher-forced or drawing), and its
   energies to B10's on its own samples, its draws a function of (seed,
   offset), and its frequencies at N=4 over 20k draws against the exact
   |psi|^2; B10 and B11 with the mask off, and B7, B9, B10 and B11 at the
   cRNN family's widest U on the card (two 64-row tiles per gate in the
   suffix pass).
7. The J1-J2 kernels and their plain versions timed with CUDA events, B9's
   replay and B9 from it beside them; B9's four launches (the replay, the
   reverse sweep, the weight cotangent, the chunk sum) and B10's and B11's
   four (base pass, bond lists, the tensor-core suffix pass, sum; also B11
   at N=1000, S=64, where the suffix pass must be
   ``exchange_suffix_rs_kernel``, as at N=100, and the packed tiles'
   occupancy is printed) timed apart by ``torch.profiler``; their FP32 and
   (B10, B11) tensor-core bounds.
8. VMC training of J1-J2 at N=10, J2=0.2, Marshall sign on (500 steps)
   against exact diagonalization; every J1-J2 kernel must have launched
   (B7 by the evaluation of log psi after training, under no_grad).
9. 50 steps of the J1-J2 flagship (the complex U(1) cRNN, one GRU layer of
   50 units, on J1J2(N=100, J2=0.2), open chain, S=500, Adam at lr 5e-3):
   steps/s and the first and last energies beside the DMRG energy, which
   must be finite and falling; the steps launch B9's replay and B9 from it
   once each, B7 only the evaluation after them; and, by ``torch.profiler``
   over 5 more steps, each step's launches by kernel name.
10. The 2D MDRNN kernels B12-B16 against their plain versions at the
   flagship shapes (16x16, U=50, B=500, perturbed weights) and on the
   non-square 5x3 and 3x6 lattices: B12 log p, B12 storing B14's replay
   (log p, history, p1) against the plain replay, both the same bits twice,
   B14 per tensor alone and from that replay, the same bits twice, B15 ratio
   and log p, B16 against B12 and B15 on its own samples, B13's draws equal
   to B16's for the same (seed, offset), the same bits twice and a function
   of the key, the sampler's frequencies at 2x2 over 20k draws against
   the exact density, and B15's ratio sums against the float64 plain
   version on Nx x 2 lattices up to the family's widest at U=50 (their
   float32 rounding grows with the sites).
11. The five MDRNN kernels and their plain versions timed with CUDA events,
   B12 storing and B14 from its replay beside them; B16's three launches
   (base pass, suffix pass, ratio sum) and B14's (replay, reverse sweep,
   weight cotangent, chunk sum) timed apart by ``torch.profiler``; their
   FP32 and (B15, B16) tensor-core bounds; the lattice widths and unit
   counts the MDRNN kernels cover.
12. VMC training of the 2D TFIM at 3x3, Bx=3 (MDRNN2D, U=50) against exact
   diagonalization; every MDRNN kernel must have launched.
13. 50 steps of the 2D flagship (MDRNN2D 16x16, U=50, on
   TFIM2D(16, 16, Bx=3, grid), S=500, Adam at lr 5e-3): steps/s and the
   first and last energies, which must be finite and falling.
14. The stand-alone samplers B5 (GRU) and B8 (U(1) cRNN) and the per-flip
   log p B6 (teacher-forced and in sample mode) against their plain
   versions at N=100, U=50, B=500: B5's draws and log p equal to K3's for
   one key, B6's sample mode equal to its teacher-forced mode on its own
   samples, the flip-order sum of B6's terms against K4's ratio, B8's draws
   equal to B11's (in the zero-magnetisation sector), its log |psi|^2 to
   2 Re log psi of B11 and B7's (Re, Im) on them to B11's, bit for bit,
   and the frequencies of B5 at N=3 and B8 at
   N=4 over 20k draws against the exact densities.
15. The four new kernels and their plain versions timed with CUDA events,
   their bounds, and the widths their kernel families cover at N=100.
16. Parity VMC at N=10 (TFIM, Bx=1) and snake-ordered VMC at 3x3, Bx=3
   (PRNNSnake2D on the flat TFIM2D) against exact diagonalization; every
   B5, B6 and K1/K2 counter must move.
17. 50 steps each of the parity flagship (PRNN1D(100, (50,), parity=True) on
   TFIM1D(100, Bx=1), S=500, Adam at lr 5e-3) and the snake flagship
   (PRNNSnake2D(10, 10, (50,)) on TFIM2D(10, 10, Bx=3, flat), S=500, Adam
   at lr 5e-3), after 3 warm-up steps: steps/s and the first and last
   energies, which must be finite and falling; then one sample of each
   model and of CRNNU1(100, (50,)), which run B5 and B8 and not K3 or B11.
18. The minSR kernels against their plain versions on the card: the
   jacobian sweep B17 (K2's replay and reverse sweep with g = 1) at N=100,
   U=50, B=500 (history, gate cotangents, dl1, read from its A and C rows,
   then the per-sample rows and log p against the plain rows) and at
   N=1000, S=64 (where the TPU kernel takes its spill variant B18); B19
   storing the gates and B20 (both parts) from them, and B20 alone, on
   B11's in-sector samples of the J1-J2 flagship model, and its rows
   against the plain rows; the CG solve B21 on the TFIM
   flagship's (S, S) Gram and the J1-J2 flagship's (2S, 2S) Gram against
   the plain CG, with its relative residual beside the Cholesky solve's,
   and on each of its paths, chosen by S (one block at S=64, clusters of 4
   blocks at S=230 and of 8 at S=500, the cooperative grid at 2S=1000 and
   S=3000), against the plain CG and Cholesky on SR-Gram-like systems, the
   same bits twice.
19. The minSR kernels, their plain versions and their library yardsticks
   (``torch.nn.GRU``, i.e. cuDNN, beside B19 not storing, which computes the
   same history; Cholesky for B21) timed with CUDA events, B19 storing the
   gates as the step runs it, B20 from the stored gates and alone, B21 on
   the TFIM and J1-J2 Grams and the N=1000 chain's S=64; B17's and B18's two
   launches (the replay, the reverse sweep) timed apart by
   ``torch.profiler``; their bounds, and the widths their kernel families
   cover.
20. minSR accuracy: TFIM N=20 (PRNN1D(20, (50,)), S=500, lr 5e-2) in 50-step
   blocks until within 1e-3 of the DMRG energy, at most 600 steps; J1-J2
   N=8 (CRNNU1(8, (12,)), J1J2(8, J2=0.2), S=256, lr 5e-2, seed 7) after 80
   steps, within 3e-2 of exact diagonalization.  Every minSR kernel must
   launch.
21. minSR flagships: 50 steps each of the TFIM flagship and the J1-J2
   flagship (S=500, minSR at lr 5e-2, the CG solve) after 3 warm-up steps,
   and 10 steps of the N=1000, S=64 chain: steps/s and the first and last
   energies, which must be finite and falling.
22. The 1D-TFIM entry points on the card at the flagship's width: the CLI
   (``cli/run_1dtfim.main``, N=100, U=50, S=500, a staged schedule halving
   the rate at step 50) for 100 steps, then resumed to 200: 101 and 201
   finite entries, falling energies, the first run's entries kept, the
   final checkpoints after loop steps 100 and 200 (saved under their update
   counts 101 and 201), the staged rate in the saved Adam state, K1, K2 and
   K3 launched once per update and the generic sampler and estimator not
   at all; the loop's steps/s beside phase 5's, and against ``run_steps``
   in alternating turns; then
   ``compat.run_1DTFIM(numsteps=20, systemsize=100)``.

The second-last line is a JSON object with one entry per kernel (B9's
replay, launched apart as the J1-J2 step's forward, has its own): its
launches on its main path (phase 5 for K1-K4, phase 9 for B7-B11, phase 13
for B12-B16, phase 17's parity run for B5, B6 and B8, phase 21's TFIM
flagship for B17 and B21, its J1-J2 flagship for B19 and B20, its N=1000
chain for B18), its largest error against its plain version, its time and
its plain version's, its library yardstick's where one exists,
``bound_ms``, the least time the card could take for the work on this run's
inputs in FP32, and ``tc_bound_ms``, that least time with the recurrent
products on the tensor cores, for the kernels that run them there (K3, K4,
B6a, B6b, B10, B11, B15, B16; null for the others).  The last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FLAG, U_FLAG, S_FLAG = 100, 50, 500
SOURCES = {
    "K1 gru_log_prob": ("rnnwavefunctions_tpu_torch/csrc/tfim_flip.cu",
                        "rnnwavefunctions_tpu/ops/fused_gru.py:250"),
    "K2 gru_log_prob_bwd": ("rnnwavefunctions_tpu_torch/csrc/fused_gru_bwd.cu",
                            "rnnwavefunctions_tpu/ops/fused_gru_bwd.py:681"),
    "K3 tfim_sample_and_flip_sum": ("rnnwavefunctions_tpu_torch/csrc/tfim_flip.cu",
                                    "rnnwavefunctions_tpu/ops/tfim_flip_kernel.py:595"),
    "K4 tfim_flip_ratio_sum": ("rnnwavefunctions_tpu_torch/csrc/tfim_flip.cu",
                               "rnnwavefunctions_tpu/ops/tfim_flip_kernel.py:499"),
    "B5 gru_sample": ("rnnwavefunctions_tpu_torch/csrc/tfim_flip.cu",
                      "rnnwavefunctions_tpu/ops/fused_gru.py:319"),
    "B6a tfim_flip_log_probs": ("rnnwavefunctions_tpu_torch/csrc/tfim_flip.cu",
                                "rnnwavefunctions_tpu/ops/tfim_flip_kernel.py:550"),
    "B6b tfim_sample_and_flip_sum per_flip": ("rnnwavefunctions_tpu_torch/csrc/tfim_flip.cu",
                                              "rnnwavefunctions_tpu/ops/tfim_flip_kernel.py:595"),
    "B7 crnn_log_amp_parts": ("rnnwavefunctions_tpu_torch/csrc/j1j2_exchange.cu",
                              "rnnwavefunctions_tpu/ops/fused_crnn.py:171"),
    "B8 crnn_sample": ("rnnwavefunctions_tpu_torch/csrc/j1j2_exchange.cu",
                       "rnnwavefunctions_tpu/ops/fused_crnn.py:245"),
    "B9 crnn_log_amp_bwd": ("rnnwavefunctions_tpu_torch/csrc/fused_crnn_bwd.cu",
                            "rnnwavefunctions_tpu/ops/fused_crnn_bwd.py:196"),
    # B9's stage a, launched apart as the J1-J2 step's forward
    "B9 replay": ("rnnwavefunctions_tpu_torch/csrc/j1j2_exchange.cu",
                  "rnnwavefunctions_tpu/ops/fused_crnn_bwd.py:196"),
    "B10 j1j2_exchange_offdiag": ("rnnwavefunctions_tpu_torch/csrc/j1j2_exchange.cu",
                                  "rnnwavefunctions_tpu/ops/j1j2_exchange_kernel.py:542"),
    "B11 j1j2_sample_and_exchange": ("rnnwavefunctions_tpu_torch/csrc/j1j2_exchange.cu",
                                     "rnnwavefunctions_tpu/ops/j1j2_exchange_kernel.py:626"),
    "B12 mdrnn_log_prob": ("rnnwavefunctions_tpu_torch/csrc/fused_mdrnn.cu",
                           "rnnwavefunctions_tpu/ops/fused_mdrnn.py:165"),
    "B13 mdrnn_sample": ("rnnwavefunctions_tpu_torch/csrc/fused_mdrnn.cu",
                         "rnnwavefunctions_tpu/ops/fused_mdrnn.py:186"),
    "B14 mdrnn_log_prob_bwd": ("rnnwavefunctions_tpu_torch/csrc/fused_mdrnn_bwd.cu",
                               "rnnwavefunctions_tpu/ops/fused_mdrnn_bwd.py:402"),
    "B15 mdrnn_flip_ratio_sum": ("rnnwavefunctions_tpu_torch/csrc/mdrnn_flip.cu",
                                 "rnnwavefunctions_tpu/ops/mdrnn_flip_kernel.py:556"),
    "B16 mdrnn_sample_and_flip_sum": ("rnnwavefunctions_tpu_torch/csrc/mdrnn_flip.cu",
                                      "rnnwavefunctions_tpu/ops/mdrnn_flip_kernel.py:594"),
    "B17 jac_sweep": ("rnnwavefunctions_tpu_torch/csrc/fused_gru_bwd.cu",
                      "rnnwavefunctions_tpu/ops/fused_jac.py:525"),
    "B18 jac_sweep N=1000": ("rnnwavefunctions_tpu_torch/csrc/fused_gru_bwd.cu",
                             "rnnwavefunctions_tpu/ops/fused_jac.py:559"),
    "B19 rollout_hist": ("rnnwavefunctions_tpu_torch/csrc/fused_jac.cu",
                         "rnnwavefunctions_tpu/ops/fused_jac.py:1042"),
    "B20 sweep_dgates": ("rnnwavefunctions_tpu_torch/csrc/fused_jac.cu",
                         "rnnwavefunctions_tpu/ops/fused_jac.py:1131"),
    "B21 sr_cg_solve": ("rnnwavefunctions_tpu_torch/csrc/sr_cg.cu",
                        "rnnwavefunctions_tpu/ops/sr_cg.py:108"),
}
J2_FLAG = 0.2
E_DMRG_J1J2 = -40.73881897  # J1J2(N=100, J2=0.2), open chain (the JAX package's BASELINE.md)
NX_FLAG = NY_FLAG = 16  # the 2D flagship: bench.py's mdrnn_16x16 row, Bx=3
BX_2D = 3.0
# phase 12: a CPU rehearsal of the plain path (same model, S=500, lr 5e-3, two
# seeds) was within 1.0e-4 of ED after 100 steps and 3.3e-5 after 200
MDRNN_VMC_STEPS, MDRNN_VMC_TOL = 200, 1e-3
# phase 16: a CPU rehearsal of the plain path (same models, S=500, lr 5e-3,
# three seeds) put parity N=10 within 1.6e-4 of ED after 300 steps and 3.8e-5
# after 400; the snake 3x3, Bx=3 sat on a plateau near 3.5e-3 until step
# 350-450 and was within 3.4e-5 from step 500 on (1.8e-5 at 600)
PARITY_VMC_STEPS, PARITY_VMC_TOL = 400, 1e-3
SNAKE_VMC_STEPS, SNAKE_VMC_TOL = 800, 1e-3
NX_SNAKE = NY_SNAKE = 10  # the snake flagship: bench.py's snake2d_10x10 row, Bx=3
# minSR: bench.py's *_minsr rows (lr 5e-2, the CG solve) and its N=20
# accuracy probe; the long chain is its 1dtfim_n1000_minsr row
MINSR_LR = 5e-2
N_LONG, S_LONG = 1000, 64
E_DMRG_N20 = -25.1077971081
# phase 20's J1-J2 probe: tests/test_minsr.py's settings (no Marshall sign).
# From this seed's initial weights the port and the JAX package's trainer
# both end 80 steps on the CPU within 3e-2 of ED; from seeds 4-6 both stall
# near 1e-1 (tests/test_torch_minsr.py::test_j1j2_n8_minsr_run_matches_jax)
J1J2_PROBE_SEED = 7

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): float32
# outside the tensor cores, TF32 on the tensor cores (dense), and device
# memory.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12


def site_flops(u: int, heads: int) -> int:
    """Operations of one GRU site step of one trajectory: the 3U x U
    recurrent product (two per multiply-add), about ten per gate entry for
    the input gates, activations and update, and per 2-logit head a U x 2
    product and the log-softmax."""
    return 6 * u * u + 30 * u + heads * (4 * u + 10)


def bwd_site_flops(u: int, heads: int) -> int:
    """Operations of one site of the VJP: the forward step, the transposed
    product for the recurrent cotangent and the outer product for the
    weight cotangent (three 3U x U products), and the elementwise chains."""
    return 18 * u * u + 60 * u + heads * (12 * u + 20)


def mdrnn_site_flops(u: int) -> int:
    """Operations of one MDRNN site step of one trajectory: the two U x U
    products (two per multiply-add), about twelve per unit for the input
    terms, activation and the U x 2 head, and the log-softmax."""
    return 4 * u * u + 12 * u + 10


def mdrnn_bwd_site_flops(u: int) -> int:
    """Operations of one site of the MDRNN VJP: the forward replay, the two
    transposed products for the cotangents along both links and the two
    outer products for the weight cotangents (six U x U products), and the
    elementwise chains."""
    return 12 * u * u + 40 * u + 20


def jac_stored_site_flops(u: int) -> int:
    """Operations of one reverse site of B20 from the stored gates: the
    recurrent cotangent's 3U x U product and the elementwise chains."""
    return 6 * u * u + 30 * u


def jac_sweep_site_flops(u: int) -> int:
    """Operations of one site of B17's function: the forward step with its
    head, then the reverse site's one product for the recurrent cotangent
    (the gates are kept from the forward step) and its elementwise chains."""
    return site_flops(u, 1) + 6 * u * u + 30 * u


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the FP32 peak
    and the bytes over the memory rate."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tc_bound(steps: int, u: int, nbytes: float) -> float:
    """The least time, in ms, of a flip kernel whose recurrent products run
    on the tensor cores (K3, K4, B6; csrc/tfim_flip.cu) for ``steps`` GRU
    site steps with one head: the 6U^2 operations of each step's 3U x U
    product counted once at the TF32 peak, the other 30U + 4U + 10 (input
    gates, activations, update, the head and its log-softmax) at the FP32
    peak, or the bytes over the memory rate where that is larger.  The
    3xTF32 split issues each product three times; the bound counts the
    work, not the scheme."""
    t_ops = steps * (6 * u * u / TF32_FLOPS + (30 * u + 4 * u + 10) / FP32_FLOPS)
    return 1e3 * max(t_ops, nbytes / HBM_BYTES_PER_S)


def mdrnn_tc_bound(steps: int, u: int, nbytes: float) -> float:
    """The least time, in ms, of the MDRNN flip kernels whose two recurrent
    products run on the tensor cores (B15, B16; csrc/mdrnn_flip.cu) for
    ``steps`` site steps: each step's 4U^2 operations at the TF32 peak, the
    other 12U + 10 of ``mdrnn_site_flops`` at the FP32 peak, or the bytes
    over the memory rate where that is larger."""
    t_ops = steps * (4 * u * u / TF32_FLOPS + (12 * u + 10) / FP32_FLOPS)
    return 1e3 * max(t_ops, nbytes / HBM_BYTES_PER_S)


def exchange_site_steps(samples: torch.Tensor, ham) -> int:
    """The suffix site steps the exchange sum needs on these samples: each
    anti-aligned bond (a, b) with a < b recomputes sites a+1..N-1 (site a's
    state is the base pass's, and its flipped terms come from there)."""
    n = samples.shape[1]
    _, _, _, mask = ham.connected(samples)
    idx = torch.arange(n, device=samples.device)
    start = torch.cat([torch.minimum(idx, (idx + gap) % n) for gap in (1, 2)])
    return int(((n - 1 - start) * mask).sum())


def exchange_tc_bound(base_steps: int, suffix_steps: int, u: int, nbytes: float) -> float:
    """The least time, in ms, of B10/B11 (csrc/j1j2_exchange.cu), whose
    suffix products run on the tensor cores: the base pass's cRNN site steps
    at the FP32 peak; each suffix step's 6U^2 operations of its 3U x U
    product at the TF32 peak and its other 30U + 2 (4U + 10) (input gates,
    activations, update, two heads and their log-softmax) at the FP32 peak;
    or the bytes over the memory rate where that is larger."""
    t_ops = (base_steps * site_flops(u, 2) / FP32_FLOPS
             + suffix_steps * (6 * u * u / TF32_FLOPS + (30 * u + 2 * (4 * u + 10)) / FP32_FLOPS))
    return 1e3 * max(t_ops, nbytes / HBM_BYTES_PER_S)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s", flush=True)
        return False


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def print_launches(name: str, fn, parts, calls: int = 10) -> None:
    """Prints (and returns) the device ms per call of fn of each launch whose
    kernel name holds parts[label], by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {label: sum(e.self_device_time_total for e in prof.key_averages()
                        if key in e.key) / 1e3 / calls for label, key in parts.items()}
    print(f"{name} launches (torch.profiler, ms per call): " + ", ".join(
        f"{label} {ms:.4f}" if ms > 0 else f"{label} not measured"
        for label, ms in split.items()))
    return split


def perturbed_model(pkg, n, u, seed, device, cls="PRNN1D"):
    """A model with Glorot weights plus seeded noise on every tensor, so the
    biases are not zero and the bias paths of the kernels are exercised."""
    gen = torch.Generator().manual_seed(seed)
    model = getattr(pkg, cls)(n, (u,), impl="kernel", device=device).init(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen).to(device))
    return model


def perturbed_mdrnn(pkg, nx, ny, u, seed, device):
    """An MDRNN2D with Glorot weights plus seeded noise on every tensor; the
    two recurrent matrices are then halved, so that the 2D recurrence (whose
    paths multiply along both links) keeps its states bounded at 16x16."""
    gen = torch.Generator().manual_seed(seed)
    model = pkg.MDRNN2D(nx, ny, u, impl="kernel", device=device).init(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen).to(device))
        model.cell.wh.mul_(0.5)
        model.cell.wv.mul_(0.5)
    return model


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import rnnwavefunctions_tpu_torch as pkg
    from rnnwavefunctions_tpu_torch.ed import exact
    from rnnwavefunctions_tpu_torch import interop
    from rnnwavefunctions_tpu_torch.ops import build, fused_crnn, fused_crnn_bwd
    from rnnwavefunctions_tpu_torch.ops import fused_gru, fused_gru_bwd, fused_jac, sr_cg
    from rnnwavefunctions_tpu_torch.ops import fused_mdrnn, fused_mdrnn_bwd
    from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk
    from rnnwavefunctions_tpu_torch.ops import mdrnn_flip_kernel as mk
    from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk
    from rnnwavefunctions_tpu_torch.vmc import jacobian, minsr

    dev = torch.device("cuda", 0)
    wrappers = {
        "K1 gru_log_prob": fused_gru.gru_log_prob,
        "K2 gru_log_prob_bwd": fused_gru_bwd.gru_log_prob_bwd,
        "K3 tfim_sample_and_flip_sum": tk.tfim_sample_and_flip_sum,
        "K4 tfim_flip_ratio_sum": tk.tfim_flip_ratio_sum,
        "B5 gru_sample": fused_gru.gru_sample,
        "B6a tfim_flip_log_probs": tk.tfim_flip_log_probs,
        "B6b tfim_sample_and_flip_sum per_flip": tk.tfim_sample_and_flip_log_probs,
        "B7 crnn_log_amp_parts": fused_crnn.crnn_log_amp_parts,
        "B8 crnn_sample": fused_crnn.crnn_sample,
        "B9 crnn_log_amp_bwd": fused_crnn_bwd.crnn_log_amp_bwd,
        "B9 replay": fused_crnn.crnn_replay,
        "B10 j1j2_exchange_offdiag": jk.j1j2_exchange_offdiag,
        "B11 j1j2_sample_and_exchange": jk.j1j2_sample_and_exchange,
        "B12 mdrnn_log_prob": fused_mdrnn.mdrnn_log_prob,
        "B13 mdrnn_sample": fused_mdrnn.mdrnn_sample,
        "B14 mdrnn_log_prob_bwd": fused_mdrnn_bwd.mdrnn_log_prob_bwd,
        "B15 mdrnn_flip_ratio_sum": mk.mdrnn_flip_ratio_sum,
        "B16 mdrnn_sample_and_flip_sum": mk.mdrnn_sample_and_flip_sum,
        "B17 jac_sweep": fused_jac.jac_sweep,
        "B18 jac_sweep N=1000": fused_jac.jac_sweep,
        "B19 rollout_hist": fused_jac.rollout_hist,
        "B20 sweep_dgates": fused_jac.sweep_dgates,
        "B21 sr_cg_solve": sr_cg.sr_cg_solve,
    }
    record = {k: {} for k in wrappers}
    crnn_names = [k for k in wrappers if k.split()[0] in ("B7", "B9", "B10", "B11")]
    mdrnn_names = [k for k in wrappers if "mdrnn" in k]
    new_names = [k for k in wrappers if k.split()[0] in ("B5", "B6a", "B6b", "B8")]

    with Phase("1 card and build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        print(smi)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
        lib = build.load_library()
        print(f"kernel library {lib.path.name}: built in {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    # ---- flagship inputs
    model = perturbed_model(pkg, N_FLAG, U_FLAG, 1234, dev)
    w = tuple(t.detach() for t in model.weights())
    gen = torch.Generator().manual_seed(99)
    samples = (torch.rand(S_FLAG, N_FLAG, generator=gen) < 0.5).to(torch.int32).to(dev)
    g = torch.randn(S_FLAG, generator=gen).to(dev)
    lp_tol = 1e-5 * N_FLAG  # f32 recurrences summed in another order: 1e-5 per site
    rel_tol = 1e-4          # of the largest |reference| entry

    def rel(got, want):
        return max_err(got, want) / max(1.0, float(want.abs().max()))

    def rel_energy(got, want):
        """Both parts' largest error over the largest modulus of the complex
        reference: Im sums cancelling terms of the real part's size, so its
        f32 rounding error is on the real part's scale while its value is
        small."""
        scale = max(1.0, float(torch.hypot(want[0], want[1]).max()))
        return max(max_err(got[0], want[0]), max_err(got[1], want[1])) / scale

    with Phase("2 kernels against their plain versions (N=100, U=50, B=500)"):
        lp_k = fused_gru.gru_log_prob(w, samples)
        lp_p = fused_gru.log_prob_plain(w, samples)
        torch.cuda.synchronize()
        e = max_err(lp_k, lp_p)
        print(f"K1 log p: max abs err {e:.3e} (tol {lp_tol:.1e})")
        require(e <= lp_tol, "K1 log p")
        record["K1 gru_log_prob"]["max_abs_err"] = e

        gk = fused_gru_bwd.gru_log_prob_bwd(w, samples, g)
        gp = fused_gru.log_prob_bwd_plain(w, samples, g)
        torch.cuda.synchronize()
        names = ("wx", "wh", "bx", "bh", "head_w", "head_b")
        worst = 0.0
        for name, a, b in zip(names, gk, gp):
            r = rel(a, b)
            print(f"K2 d{name}: max abs err {max_err(a, b):.3e}, relative {r:.3e} (tol {rel_tol:.0e})")
            require(r <= rel_tol, f"K2 d{name}")
            worst = max(worst, max_err(a, b))
        record["K2 gru_log_prob_bwd"]["max_abs_err"] = worst
        again = fused_gru_bwd.gru_log_prob_bwd(w, samples, g)
        replay = fused_gru.gru_log_prob(w, samples, store=True)
        fused = fused_gru_bwd.gru_log_prob_bwd(w, samples, g, replay=replay)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(again, gk)), "K2 gives the same bits twice")
        require(all(torch.equal(a, b) for a, b in zip(fused, gk)) and torch.equal(replay.lp, lp_k),
                "K2 from K1's stored replay gives K2's bits, K1 storing gives K1's")
        print("K2: two calls, and a call from K1's stored replay, give identical bits")

        ratio_k, lp4_k = tk.tfim_flip_ratio_sum(w, samples)
        ratio_p, lp4_p = tk.flip_ratio_sum_plain(w, samples)
        torch.cuda.synchronize()
        er, el = rel(ratio_k, ratio_p), max_err(lp4_k, lp4_p)
        print(f"K4 ratio sum: relative err {er:.3e} (tol {rel_tol:.0e}); "
              f"log p: max abs err {el:.3e} (tol {lp_tol:.1e})")
        require(er <= rel_tol and el <= lp_tol, "K4")
        record["K4 tfim_flip_ratio_sum"]["max_abs_err"] = max(max_err(ratio_k, ratio_p), el)

        s3, lp3, ratio3 = tk.tfim_sample_and_flip_sum(w, S_FLAG, N_FLAG, 7, 1)
        torch.cuda.synchronize()
        require(tuple(s3.shape) == (S_FLAG, N_FLAG), "K3 sample shape")
        require(bool(((s3 == 0) | (s3 == 1)).all()), "K3 spins in {0, 1}")
        lp3_p = fused_gru.log_prob_plain(w, s3)
        ratio3_p, _ = tk.flip_ratio_sum_plain(w, s3)
        e1, e2 = max_err(lp3, lp3_p), rel(ratio3, ratio3_p)
        print(f"K3 log p vs plain K1 on its samples: max abs err {e1:.3e} (tol {lp_tol:.1e}); "
              f"ratio vs plain K4: relative err {e2:.3e} (tol {rel_tol:.0e})")
        require(e1 <= lp_tol and e2 <= rel_tol, "K3")
        record["K3 tfim_sample_and_flip_sum"]["max_abs_err"] = max(
            e1, max_err(ratio3, ratio3_p))
        s3b, _, _ = tk.tfim_sample_and_flip_sum(w, S_FLAG, N_FLAG, 7, 1)
        require(bool((s3b == s3).all()), "K3 draws are a function of (seed, offset)")

        n3, draws = 3, 20000
        small = perturbed_model(pkg, n3, U_FLAG, 5, dev)
        ws = tuple(t.detach() for t in small.weights())
        s_small, _, _ = tk.tfim_sample_and_flip_sum(ws, draws, n3, 11, 0)
        codes = (s_small.cpu().numpy() @ (2 ** np.arange(n3))).astype(int)
        freq = np.bincount(codes, minlength=8) / draws
        basis = torch.tensor([[(c >> i) & 1 for i in range(n3)] for c in range(8)],
                             dtype=torch.int32, device=dev)
        probs = torch.exp(fused_gru.log_prob_plain(ws, basis)).cpu().numpy()
        e = float(np.abs(freq - probs).max())
        print(f"K3 sampler at N=3, {draws} draws: max |freq - p| {e:.4f} (tol 0.02), "
              f"sum p = {probs.sum():.6f}")
        require(e <= 0.02, "K3 sampler distribution")

        # the suffix pass's edges: groups of 64 trajectories (one sample, a
        # full group and one more, the flagship's 8 groups, the N=1000
        # chain's one), the turned-around pass's widest U (56), the first U
        # past it (57, the first suffix pass) and the family's widest (120)
        for b_, n_, u_ in ((1, N_FLAG, U_FLAG), (64, N_FLAG, U_FLAG), (65, N_FLAG, U_FLAG),
                           (S_LONG, N_LONG, U_FLAG), (65, N_FLAG, 56), (65, N_FLAG, 57),
                           (65, N_FLAG, 120)):
            we = tuple(t.detach() for t in perturbed_model(pkg, n_, u_, 7, dev).weights())
            se = (torch.rand(b_, n_, generator=gen) < 0.5).to(torch.int32).to(dev)
            ratio_e, lp_e = tk.tfim_flip_ratio_sum(we, se)
            lpf_e, lp6_e = tk.tfim_flip_log_probs(we, se)
            ratio_ep, lp_ep = tk.flip_ratio_sum_plain(we, se)
            lpf_ep, _ = tk.per_flip_log_probs_plain(we, se)
            # a sample's terms wherever it lands: the rows permuted
            perm = torch.randperm(b_, generator=gen).to(dev)
            ratio_pm, _ = tk.tfim_flip_ratio_sum(we, se[perm].contiguous())
            lpf_pm, _ = tk.tfim_flip_log_probs(we, se[perm].contiguous())
            torch.cuda.synchronize()
            tol = 1e-5 * n_
            er, el, ef = rel(ratio_e, ratio_ep), max_err(lp_e, lp_ep), max_err(lpf_e, lpf_ep)
            same = bool(torch.equal(ratio_pm, ratio_e[perm])) and bool(
                torch.equal(lpf_pm, lpf_e[perm])) and bool(torch.equal(lp6_e, lp_e))
            print(f"K4/B6a at B={b_}, N={n_}, U={u_}: ratio relative err {er:.3e} (tol "
                  f"{rel_tol:.0e}), log p {el:.3e}, lpf {ef:.3e} (tol {tol:.1e}); rows permuted, "
                  f"the same bits per sample: {same}")
            require(er <= rel_tol and el <= tol and ef <= tol and same,
                    f"K4/B6a at B={b_}, N={n_}, U={u_}")
        wl = tuple(t.detach() for t in perturbed_model(pkg, N_LONG, U_FLAG, 8, dev).weights())
        sl, lpl, ratio_l = tk.tfim_sample_and_flip_sum(wl, S_LONG, N_LONG, 5, 2)
        sl6, lpl6, lpfl6 = tk.tfim_sample_and_flip_sum(wl, S_LONG, N_LONG, 5, 2, per_flip=True)
        ratio_lp, lp_lp = tk.flip_ratio_sum_plain(wl, sl)
        torch.cuda.synchronize()
        e1, e2 = rel(ratio_l, ratio_lp), max_err(lpl, lp_lp)
        same = (bool(torch.equal(sl6, sl)) and bool(torch.equal(lpl6, lpl))
                and bool(torch.equal(tk.tfim_flip_log_probs(wl, sl)[0], lpfl6)))
        print(f"K3 at N={N_LONG}, S={S_LONG}: ratio vs plain K4 on its samples: relative err "
              f"{e1:.3e} (tol {rel_tol:.0e}), log p {e2:.3e} (tol {1e-5 * N_LONG:.1e}); B6b "
              f"draws K3's samples and gives B6a's lpf on them, bit for bit: {same}")
        require(e1 <= rel_tol and e2 <= 1e-5 * N_LONG and same, f"K3 and B6b at N={N_LONG}")

    with Phase("3 times at the flagship shapes (CUDA events)"):
        uni = torch.rand(S_FLAG, N_FLAG, generator=gen).to(dev)
        pairs = {
            "K1 gru_log_prob": (lambda: fused_gru.gru_log_prob(w, samples),
                                lambda: fused_gru.log_prob_plain(w, samples)),
            "K2 gru_log_prob_bwd": (lambda: fused_gru_bwd.gru_log_prob_bwd(w, samples, g),
                                    lambda: fused_gru.log_prob_bwd_plain(w, samples, g)),
            "K3 tfim_sample_and_flip_sum": (
                lambda: tk.tfim_sample_and_flip_sum(w, S_FLAG, N_FLAG, 3, 4),
                lambda: tk.sample_and_flip_sum_plain(w, uni)),
            "K4 tfim_flip_ratio_sum": (lambda: tk.tfim_flip_ratio_sum(w, samples),
                                       lambda: tk.flip_ratio_sum_plain(w, samples)),
        }
        for name, (kern, plain) in pairs.items():
            record[name]["ms"] = cuda_ms(kern, reps=20)
            record[name]["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
            print(f"{name}: kernel {record[name]['ms']:.4f} ms, "
                  f"plain {record[name]['plain_ms']:.4f} ms")
        # K3's and K2's launches apart: device time per call of each
        # K3's suffix pass runs flip_suffix_rs_kernel at U <= 56 (the first
        # design, flip_suffix_kernel, only past it)
        for label, call in (
                ("K3", lambda: tk.tfim_sample_and_flip_sum(w, S_FLAG, N_FLAG, 3, 4)),
                (f"K3 at N={N_LONG}, S={S_LONG}",
                 lambda: tk.tfim_sample_and_flip_sum(w, S_LONG, N_LONG, 3, 4))):
            split = print_launches(label, call, {
                "base pass": "flip_base_kernel", "suffix pass": "flip_suffix_rs_kernel",
                "first suffix pass": "flip_suffix_kernel", "ratio sum": "flip_sum_kernel"})
            require(split["suffix pass"] > 0 and split["first suffix pass"] == 0,
                    f"{label}: the suffix pass is the turned-around one")
        print_launches("K2", lambda: fused_gru_bwd.gru_log_prob_bwd(w, samples, g),
                       {"replay": "flip_base_kernel", "reverse sweep": "bwd_sweep_kernel",
                        "weight cotangent": "bwd_weights_kernel",
                        "chunk sum": "sum_partials_kernel"})
        steps_k3 = S_FLAG * N_FLAG + S_FLAG * N_FLAG * (N_FLAG - 1) // 2
        k3_bytes = 4 * sum(t.numel() for t in w) + 4 * S_FLAG * N_FLAG + 8 * S_FLAG
        for name in ("K3 tfim_sample_and_flip_sum", "K4 tfim_flip_ratio_sum"):
            record[name]["tc_bound_ms"] = tc_bound(steps_k3, U_FLAG, k3_bytes)
        t3 = record["K3 tfim_sample_and_flip_sum"]
        print(f"K3: {t3['ms']:.4f} ms; tensor-core bound {t3['tc_bound_ms']:.4f} ms "
              f"(share {t3['tc_bound_ms'] / t3['ms']:.1%}); FP32 bound in phase 7's print")
        # K2 from K1's stored replay (GRULogProb's backward in the training step)
        replay = fused_gru.gru_log_prob(w, samples, store=True)
        t_store = cuda_ms(lambda: fused_gru.gru_log_prob(w, samples, store=True), reps=20)
        t_from = cuda_ms(lambda: fused_gru_bwd.gru_log_prob_bwd(w, samples, g, replay=replay),
                         reps=20)
        print(f"K1 storing K2's replay {t_store:.4f} ms, K2 from it {t_from:.4f} ms "
              f"(sum {t_store + t_from:.4f}; K1 + K2 "
              f"{record['K1 gru_log_prob']['ms'] + record['K2 gru_log_prob_bwd']['ms']:.4f}); "
              f"bounds in phase 7's print")

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    with Phase("4 VMC at N=10 against exact diagonalization"):
        n = 10
        e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0))
        trainer = pkg.VMCTrainer(pkg.PRNN1D(n, (U_FLAG,), device=dev),
                                 pkg.TFIM1D(n, 1.0), pkg.TrainConfig(num_samples=500))
        state = trainer.init()
        reset_counts()
        state, ms = trainer.run_steps(state, 300)
        s_eval = trainer.ansatz.sample(500, torch.Generator().manual_seed(0))
        trainer.local_energy(s_eval)
        torch.cuda.synchronize()
        c = counts()
        print("launches:", c)
        require(all(c[k] > 0 for k in c if k.startswith("K")),
                "every kernel launched in the N=10 run")
        e_vmc = float(ms["mean_energy"][-50:].mean())
        rel_err = abs(e_vmc - e_exact) / abs(e_exact)
        print(f"N=10: E_vmc (mean of the last 50 steps) {e_vmc:.6f}, E_exact {e_exact:.6f}, "
              f"relative error {rel_err:.3e} (tol 5e-3)")
        require(rel_err <= 5e-3, "N=10 relative error against ED")

    with Phase("5 flagship: 1D TFIM N=100, GRU 50, S=500, Adam lr 5e-3"):
        trainer = pkg.VMCTrainer(pkg.PRNN1D(N_FLAG, (U_FLAG,), device=dev),
                                 pkg.TFIM1D(N_FLAG, 1.0), pkg.TrainConfig())
        state = trainer.init()
        trainer.run_steps(state, 3)  # warm-up (build, allocator)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, ms = trainer.run_steps(state, 50)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        trainer.local_energy(trainer.ansatz.sample(S_FLAG, torch.Generator().manual_seed(1)))
        torch.cuda.synchronize()
        c = counts()
        energies = ms["mean_energy"].cpu().numpy()
        print(f"{smi}: {50 / dt:.2f} steps/s ({1000 * dt / 50:.3f} ms/step)")
        print(f"energy: first {energies[0]:.4f}, last {energies[-1]:.4f} "
              f"(DMRG ground state -126.9618766964)")
        print("launches:", c)
        require(bool(np.isfinite(energies).all()), "finite flagship energies")
        require(energies[-5:].mean() < energies[:5].mean(), "flagship energies falling")
        require(all(c[k] > 0 for k in c if k.startswith("K")),
                "every kernel launched in the flagship run")
        launches = {k: v for k, v in c.items() if k.startswith("K")}
        tfim_steps_per_s = 50 / dt

    # ---- the J1-J2 flagship inputs: N=100, U=50, B=500, perturbed weights
    crnn = perturbed_model(pkg, N_FLAG, U_FLAG, 4321, dev, cls="CRNNU1")
    wc = tuple(t.detach() for t in crnn.weights())
    keys = torch.rand(S_FLAG, N_FLAG, generator=gen)
    sector = (keys.argsort(dim=1) < N_FLAG // 2).to(torch.int32).to(dev)
    g_re, g_im = torch.randn(2, S_FLAG, generator=gen).to(dev)
    configs = {
        "open, J2=0.2": pkg.J1J2(N_FLAG, j2=J2_FLAG),
        "periodic, Marshall sign, J2=0.2": pkg.J1J2(N_FLAG, j2=J2_FLAG, periodic=True,
                                                   marshall_sign=True),
        "open, J2=0": pkg.J1J2(N_FLAG),
    }
    flag_info = configs["open, J2=0.2"].exchange_kernel_info
    # the widths the kernel families take at N=100 on this card
    gru_u = max(u for u in range(1, 257) if fused_gru.supports(N_FLAG, (u,), dev))
    crnn_u = max(u for u in range(1, 257) if fused_crnn.supports(N_FLAG, (u,), dev))

    with Phase("6 J1-J2 kernels against their plain versions (N=100, U=50, B=500)"):
        # B7 on the flagship weights and at the family's widest U, with the
        # mask on and off
        wide = tuple(t.detach() for t in perturbed_model(pkg, N_FLAG, crnn_u, 4322, dev,
                                                         cls="CRNNU1").weights())
        worst = 0.0
        for wts, label_u in ((wc, f"U={U_FLAG}"), (wide, f"U={crnn_u}")):
            for u1, s_in in ((True, sector), (True, samples), (False, samples)):
                re_k, im_k = fused_crnn.crnn_log_amp_parts(wts, s_in, u1)
                re_p, im_p = fused_crnn.log_amp_parts_plain(wts, s_in, u1)
                torch.cuda.synchronize()
                e = max(max_err(re_k, re_p), max_err(im_k, im_p))
                print(f"B7 ({label_u}, u1={u1}, {'in' if s_in is sector else 'random'} "
                      f"samples): max abs err {e:.3e} (tol {lp_tol:.1e})")
                require(e <= lp_tol, "B7 (Re, Im) log psi")
                worst = max(worst, e)
        record["B7 crnn_log_amp_parts"]["max_abs_err"] = worst

        # B9 alone and from its replay (CRNNLogAmpParts' forward), on the
        # flagship weights with the mask on and off and at the family's widest
        worst = worst_replay = 0.0
        names = ("wx", "wh", "bx", "bh", "ampl_w", "ampl_b", "phase_w", "phase_b")
        for label, wts, u1 in (("u1=True", wc, True), ("u1=False", wc, False),
                               (f"U={crnn_u}, u1=True", wide, True)):
            gk = fused_crnn_bwd.crnn_log_amp_bwd(wts, sector, g_re, g_im, u1)
            gp = fused_crnn_bwd.log_amp_bwd_plain(wts, sector, g_re, g_im, u1)
            replay = fused_crnn.crnn_replay(wts, sector, u1)
            gr = fused_crnn_bwd.crnn_log_amp_bwd(wts, sector, g_re, g_im, u1, replay=replay)
            again = fused_crnn_bwd.crnn_log_amp_bwd(wts, sector, g_re, g_im, u1)
            want = fused_crnn.replay_plain(wts, sector, u1)
            torch.cuda.synchronize()
            for name, a, b in zip(names, gk, gp):
                r = rel(a, b)
                print(f"B9 d{name} ({label}): max abs err {max_err(a, b):.3e}, "
                      f"relative {r:.3e} (tol {rel_tol:.0e})")
                require(r <= rel_tol, f"B9 d{name} ({label})")
                worst = max(worst, max_err(a, b))
            er = max(rel(a, b) for a, b in zip(gr, gp))
            same = all(torch.equal(a, b) for a, b in zip(gr, gk))
            twice = all(torch.equal(a, b) for a, b in zip(again, gk))
            e_lp = max(max_err(replay.re, want.re), max_err(replay.im, want.im))
            e_st = max(rel(getattr(replay, k), getattr(want, k))
                       for k in ("rows", "gates", "seeds"))
            print(f"B9 ({label}) from its replay: relative err {er:.3e} (tol {rel_tol:.0e}), the "
                  f"bits of B9 alone: {same}; B9 twice, the same bits: {twice}; the replay's "
                  f"(Re, Im) log psi against plain B7 {e_lp:.3e} (tol {lp_tol:.1e}), its rows, "
                  f"gates and seeds against the plain replay {e_st:.3e} (tol {rel_tol:.0e})")
            require(er <= rel_tol and same and twice and e_lp <= lp_tol and e_st <= rel_tol,
                    f"B9 from its replay, its bits and the replay ({label})")
            worst_replay = max(worst_replay, e_lp, *(max_err(getattr(replay, k), getattr(want, k))
                                                     for k in ("rows", "gates", "seeds")))
        record["B9 crnn_log_amp_bwd"]["max_abs_err"] = worst
        record["B9 replay"]["max_abs_err"] = worst_replay

        worst10 = worst11 = 0.0
        for label, ham in configs.items():
            info = ham.exchange_kernel_info
            k10 = jk.j1j2_exchange_offdiag(wc, sector, u1=True, **info)
            p10 = jk.exchange_offdiag_plain(wc, sector, u1=True, **info)
            torch.cuda.synchronize()
            er = rel_energy(k10[:2], p10[:2])
            el = max(max_err(k10[2], p10[2]), max_err(k10[3], p10[3]))
            print(f"B10 ({label}): energy relative err {er:.3e} (tol {rel_tol:.0e}); "
                  f"log psi max abs err {el:.3e} (tol {lp_tol:.1e})")
            require(er <= rel_tol and el <= lp_tol, f"B10 ({label})")
            worst10 = max(worst10, el, *(max_err(a, b) for a, b in zip(k10[:2], p10[:2])))

            s11, *k11 = jk.j1j2_sample_and_exchange(wc, S_FLAG, N_FLAG, 7, 1, u1=True, **info)
            torch.cuda.synchronize()
            require(tuple(s11.shape) == (S_FLAG, N_FLAG), "B11 sample shape")
            require(bool((s11.sum(dim=1) == N_FLAG // 2).all()), "B11 zero magnetisation")
            b7 = fused_crnn.crnn_log_amp_parts(wc, s11, True)
            b10 = jk.j1j2_exchange_offdiag(wc, s11, u1=True, **info)
            p11 = jk.exchange_offdiag_plain(wc, s11, u1=True, **info)
            torch.cuda.synchronize()
            same7 = bool(torch.equal(k11[2], b7[0])) and bool(torch.equal(k11[3], b7[1]))
            e10 = rel_energy(k11[:2], b10[:2])
            ep = rel_energy(k11[:2], p11[:2])
            ep_lp = max(max_err(k11[2], p11[2]), max_err(k11[3], p11[3]))
            print(f"B11 ({label}): (Re, Im) log psi equal to B7's on its samples, bit for bit: "
                  f"{same7}; energy vs B10 relative {e10:.3e}, vs plain B10 relative {ep:.3e} "
                  f"(tol {rel_tol:.0e}); log psi vs plain {ep_lp:.3e} (tol {lp_tol:.1e})")
            require(same7 and e10 <= rel_tol and ep <= rel_tol and ep_lp <= lp_tol,
                    f"B11 ({label})")
            worst11 = max(worst11, ep_lp, *(max_err(a, b) for a, b in zip(k11[:2], p11[:2])))
            again, *_ = jk.j1j2_sample_and_exchange(wc, S_FLAG, N_FLAG, 7, 1, u1=True, **info)
            require(bool((again == s11).all()), "B11 draws are a function of (seed, offset)")
        # the mask off, on random samples; and the cRNN family's widest U on
        # this card, whose suffix pass takes two 64-row tiles per gate
        for label, wts, u1, s_in in (("mask off, random samples", wc, False, samples),
                                     (f"U={crnn_u}", wide, True, sector)):
            k10 = jk.j1j2_exchange_offdiag(wts, s_in, u1=u1, **flag_info)
            p10 = jk.exchange_offdiag_plain(wts, s_in, u1=u1, **flag_info)
            s11, *k11 = jk.j1j2_sample_and_exchange(wts, S_FLAG, N_FLAG, 7, 1, u1=u1, **flag_info)
            p11 = jk.exchange_offdiag_plain(wts, s11, u1=u1, **flag_info)
            k7 = fused_crnn.crnn_log_amp_parts(wts, s_in, u1)
            k7_11 = fused_crnn.crnn_log_amp_parts(wts, s11, u1)
            torch.cuda.synchronize()
            er, ep = rel_energy(k10[:2], p10[:2]), rel_energy(k11[:2], p11[:2])
            el = max(max_err(a, b) for a, b in zip((*k10[2:], *k11[2:], *k7),
                                                   (*p10[2:], *p11[2:], *p10[2:])))
            same7 = all(torch.equal(a, b) for a, b in zip(k7_11, k11[2:]))
            print(f"B10 and B11 ({label}, open, J2=0.2): energy relative err {er:.3e} and "
                  f"{ep:.3e} (tol {rel_tol:.0e}); log psi (and B7's) max abs err {el:.3e} "
                  f"(tol {lp_tol:.1e}); B7 on B11's samples equal to B11's log psi, bit for "
                  f"bit: {same7}")
            require(er <= rel_tol and ep <= rel_tol and el <= lp_tol and same7,
                    f"B7/B10/B11 ({label})")
            worst10 = max(worst10, el, *(max_err(a, b) for a, b in zip(k10[:2], p10[:2])))
            worst11 = max(worst11, el, *(max_err(a, b) for a, b in zip(k11[:2], p11[:2])))
        record["B10 j1j2_exchange_offdiag"]["max_abs_err"] = worst10
        record["B11 j1j2_sample_and_exchange"]["max_abs_err"] = worst11

        n4, draws = 4, 20000
        small = perturbed_model(pkg, n4, U_FLAG, 6, dev, cls="CRNNU1")
        ws4 = tuple(t.detach() for t in small.weights())
        s_small, *_ = jk.j1j2_sample_and_exchange(ws4, draws, n4, 11, 0, u1=True, **flag_info)
        codes = (s_small.cpu().numpy() @ (2 ** np.arange(n4))).astype(int)
        freq = np.bincount(codes, minlength=16) / draws
        basis = torch.tensor([[(c >> i) & 1 for i in range(n4)] for c in range(16)],
                             dtype=torch.int32, device=dev)
        probs = torch.exp(2.0 * fused_crnn.log_amp_parts_plain(ws4, basis, True)[0]).cpu().numpy()
        e = float(np.abs(freq - probs).max())
        print(f"B11 sampler at N=4, {draws} draws: max |freq - |psi|^2| {e:.4f} (tol 0.02), "
              f"sum |psi|^2 = {probs.sum():.6f}, {int((probs > 1e-12).sum())} states in the sector")
        require(e <= 0.02, "B11 sampler distribution")

    with Phase("7 J1-J2 kernel times at the flagship shapes (CUDA events)"):
        s11, *_ = jk.j1j2_sample_and_exchange(wc, S_FLAG, N_FLAG, 3, 4, u1=True, **flag_info)
        uni = torch.rand(S_FLAG, N_FLAG, generator=gen).to(dev)
        pairs = {
            "B7 crnn_log_amp_parts": (lambda: fused_crnn.crnn_log_amp_parts(wc, s11, True),
                                      lambda: fused_crnn.log_amp_parts_plain(wc, s11, True)),
            "B9 crnn_log_amp_bwd": (
                lambda: fused_crnn_bwd.crnn_log_amp_bwd(wc, s11, g_re, g_im, True),
                lambda: fused_crnn_bwd.log_amp_bwd_plain(wc, s11, g_re, g_im, True)),
            "B9 replay": (lambda: fused_crnn.crnn_replay(wc, s11, True),
                          lambda: fused_crnn.replay_plain(wc, s11, True)),
            "B10 j1j2_exchange_offdiag": (
                lambda: jk.j1j2_exchange_offdiag(wc, s11, u1=True, **flag_info),
                lambda: jk.exchange_offdiag_plain(wc, s11, u1=True, **flag_info)),
            "B11 j1j2_sample_and_exchange": (
                lambda: jk.j1j2_sample_and_exchange(wc, S_FLAG, N_FLAG, 3, 4, u1=True,
                                                    **flag_info),
                lambda: jk.sample_and_exchange_plain(wc, uni, u1=True, **flag_info)),
        }
        for name, (kern, plain) in pairs.items():
            record[name]["ms"] = cuda_ms(kern, reps=20)
            record[name]["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
            print(f"{name}: kernel {record[name]['ms']:.4f} ms, "
                  f"plain {record[name]['plain_ms']:.4f} ms")
        # B9 from its replay (CRNNLogAmpParts' backward in the training step),
        # and its launches apart
        replay = fused_crnn.crnn_replay(wc, s11, True)
        t_from = cuda_ms(lambda: fused_crnn_bwd.crnn_log_amp_bwd(wc, s11, g_re, g_im, True,
                                                                 replay=replay), reps=20)
        print(f"B9 from its replay {t_from:.4f} ms; the replay {record['B9 replay']['ms']:.4f} ms "
              f"(B7 {record['B7 crnn_log_amp_parts']['ms']:.4f})")
        print_launches("B9", pairs["B9 crnn_log_amp_bwd"][0],
                       {"replay exchange_base_kernel": "exchange_base_kernel",
                        "reverse sweep bwd_sweep_kernel": "bwd_sweep_kernel",
                        "weight cotangent bwd_weights_kernel": "bwd_weights_kernel",
                        "chunk sum sum_partials_kernel": "sum_partials_kernel"})
        # B10/B11's suffix pass runs exchange_suffix_rs_kernel at U <= 56 (the
        # first design, exchange_suffix_kernel, only past it), here and at the
        # J1-J2 cell's N=1000, S=64, where the packed tiles' occupancy is printed
        wl = tuple(t.detach() for t in perturbed_model(pkg, N_LONG, U_FLAG, 8, dev,
                                                       cls="CRNNU1").weights())
        long_info = pkg.J1J2(N_LONG, j2=J2_FLAG, marshall_sign=True).exchange_kernel_info
        s_long, *k11_long = jk.j1j2_sample_and_exchange(wl, S_LONG, N_LONG, 3, 4, u1=True,
                                                        **long_info)
        print(f"B11 at N={N_LONG}, S={S_LONG}: packed suffix tiles' occupancy "
              f"{jk.suffix_occupancy(jk.list_lengths(s_long, **long_info)):.4f}")
        # B11 against the plain version on its own chains (packed tiles across
        # start sites, rows joining late, 999-site suffixes): on the cell's
        # first weights (Glorot, zero biases) with the n1000 test's limits, and
        # on these perturbed weights within 1e-3 of the largest sum, where both
        # suffix designs read ~2.2e-4 of it from the plain and ~1.8e-4 from a
        # float64 plain (the plain float32 ~4.8e-5): the split's rounding over
        # 999 sites, not the packing; a term misplaced would move a sum by up
        # to ~0.8.  B10 on B11's chains gives B11's numbers bit for bit.
        cell = pkg.CRNNU1(N_LONG, (U_FLAG,), device="cpu").init(torch.Generator().manual_seed(5))
        wg = tuple(t.detach().to(dev) for t in cell.weights())
        s_cell, *k11_cell = jk.j1j2_sample_and_exchange(wg, S_LONG, N_LONG, 5, 6, u1=True,
                                                        **long_info)
        for label, wts, chains, got, rel_tol in (
                ("the cell's first weights", wg, s_cell, k11_cell, 1e-4),
                ("the perturbed weights", wl, s_long, k11_long, 1e-3)):
            k10_long = jk.j1j2_exchange_offdiag(wts, chains, u1=True, **long_info)
            p_long = jk.exchange_offdiag_plain(wts, chains, u1=True, **long_info)
            torch.cuda.synchronize()
            scale = float(torch.complex(*p_long[:2]).abs().max())
            es = max(max_err(a, b) for a, b in zip(got[:2], p_long[:2]))
            el = max(max_err(a, b) for a, b in zip(got[2:], p_long[2:]))
            same = all(bool(torch.equal(a, b)) for a, b in zip(k10_long, got))
            print(f"B11 at N={N_LONG}, S={S_LONG} on {label} vs plain on its samples: sums "
                  f"{es:.3e} ({es / scale:.2e} of the largest, tol {rel_tol:.0e}), log psi "
                  f"{el:.3e} (tol 2e-4); B10 on B11's samples gives B11's numbers bit for bit: "
                  f"{same}")
            require(es <= rel_tol * scale and el <= 2e-4 and same,
                    f"B10/B11 at N={N_LONG} on {label}")
        for label, call in (
                ("B10", pairs["B10 j1j2_exchange_offdiag"][0]),
                ("B11", pairs["B11 j1j2_sample_and_exchange"][0]),
                (f"B11 at N={N_LONG}, S={S_LONG}", lambda: jk.j1j2_sample_and_exchange(
                    wl, S_LONG, N_LONG, 3, 4, u1=True, **long_info))):
            split = print_launches(label, call, {
                "base pass": "exchange_base_kernel", "bond lists": "exchange_list_kernel",
                "suffix pass": "exchange_suffix_rs_kernel",
                "first suffix pass": "exchange_suffix_kernel", "sum": "exchange_sum_kernel"})
            require(split["suffix pass"] > 0 and split["first suffix pass"] == 0,
                    f"{label}: the suffix pass is the turned-around one")

    # bounds at the main paths' shapes, from this run's inputs
    b_, n_, u_ = S_FLAG, N_FLAG, U_FLAG
    w6 = 4 * sum(t.numel() for t in w)
    w8 = 4 * sum(t.numel() for t in wc)
    steps_flip = b_ * n_ + b_ * n_ * (n_ - 1) // 2
    suffix_exchange = exchange_site_steps(s11, configs["open, J2=0.2"])
    steps_exchange = b_ * n_ + suffix_exchange
    work = {
        "K1 gru_log_prob": (b_ * n_ * site_flops(u_, 1), 4 * b_ * n_ + w6 + 4 * b_),
        "K2 gru_log_prob_bwd": (b_ * n_ * bwd_site_flops(u_, 1), 4 * b_ * n_ + 4 * b_ + 2 * w6),
        "K3 tfim_sample_and_flip_sum": (steps_flip * site_flops(u_, 1), w6 + 4 * b_ * n_ + 8 * b_),
        "K4 tfim_flip_ratio_sum": (steps_flip * site_flops(u_, 1), 4 * b_ * n_ + w6 + 8 * b_),
        "B7 crnn_log_amp_parts": (b_ * n_ * site_flops(u_, 2), 4 * b_ * n_ + w8 + 8 * b_),
        "B9 crnn_log_amp_bwd": (b_ * n_ * bwd_site_flops(u_, 2), 4 * b_ * n_ + 8 * b_ + 2 * w8),
        # the replay's stores: A's rows, the gates, the seeds, (Re, Im)
        "B9 replay": (b_ * n_ * site_flops(u_, 2),
                      4 * b_ * n_ + w8 + 4 * (b_ * (n_ + 1) * (u_ + 3) + b_ * n_ * (4 * u_ + 2))
                      + 8 * b_),
        "B10 j1j2_exchange_offdiag": (steps_exchange * site_flops(u_, 2),
                                      4 * b_ * n_ + w8 + 16 * b_),
        "B11 j1j2_sample_and_exchange": (steps_exchange * site_flops(u_, 2),
                                         w8 + 4 * b_ * n_ + 16 * b_),
    }
    print(f"exchange site steps on the J1-J2 flagship samples: {steps_exchange} "
          f"({steps_exchange / (b_ * n_ * n_):.3f} of B N^2), {suffix_exchange} in the suffixes")
    for name, (flops, nbytes) in work.items():
        record[name]["bound_ms"], record[name]["bound_by"] = bound(flops, nbytes)
        if name.split()[0] in ("B10", "B11"):
            record[name]["tc_bound_ms"] = exchange_tc_bound(b_ * n_, suffix_exchange, u_, nbytes)
        tc = record[name].get("tc_bound_ms")
        tc_txt = "" if tc is None else (f"; tensor-core bound {tc:.4f} ms, share "
                                        f"{tc / record[name]['ms']:.1%}")
        print(f"{name}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.3f} MB: bound "
              f"{record[name]['bound_ms']:.4f} ms ({record[name]['bound_by']}, share "
              f"{record[name]['bound_ms'] / record[name]['ms']:.1%}), "
              f"kernel {record[name]['ms']:.4f} ms{tc_txt}")

    with Phase("8 J1-J2 VMC at N=10 (J2=0.2, Marshall sign) against exact diagonalization"):
        n = 10
        e_exact = exact.ground_state_energy(exact.j1j2_dense(n, 1.0, J2_FLAG, marshall_sign=True))
        trainer = pkg.VMCTrainer(pkg.CRNNU1(n, (U_FLAG,), device=dev),
                                 pkg.J1J2(n, j2=J2_FLAG, marshall_sign=True),
                                 pkg.TrainConfig(num_samples=S_FLAG))
        state = trainer.init()
        reset_counts()
        state, ms = trainer.run_steps(state, 500)
        s_eval = trainer.ansatz.sample(S_FLAG, torch.Generator().manual_seed(0))
        trainer.local_energy(s_eval)
        with torch.no_grad():  # log psi with no gradient after it: B7
            trainer.ansatz.log_amp_parts(s_eval)
        torch.cuda.synchronize()
        c = counts()
        print("launches:", c)
        require(all(c[k] > 0 for k in crnn_names), "every J1-J2 kernel launched")
        e_vmc = float(ms["mean_energy"][-50:].mean())
        e_im = float(ms["mean_energy_im"][-50:].mean())
        rel_err = abs(e_vmc - e_exact) / abs(e_exact)
        print(f"N=10: E_vmc (mean of the last 50 steps) {e_vmc:.6f}, E_exact {e_exact:.6f}, "
              f"relative error {rel_err:.3e} (tol 5e-2); mean Im E {e_im:.3e} (tol 0.05)")
        require(rel_err <= 5e-2, "N=10 J1-J2 relative error against ED")
        require(abs(e_im) < 0.05, "N=10 J1-J2 imaginary energy")

    with Phase("9 J1-J2 flagship: CRNNU1 GRU 50 on J1J2(N=100, J2=0.2), S=500, Adam lr 5e-3"):
        trainer = pkg.VMCTrainer(pkg.CRNNU1(N_FLAG, (U_FLAG,), device=dev),
                                 pkg.J1J2(N_FLAG, j2=J2_FLAG),
                                 pkg.TrainConfig(num_samples=S_FLAG, learning_rate=5e-3))
        state = trainer.init()
        trainer.run_steps(state, 3)  # warm-up (allocator)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, ms = trainer.run_steps(state, 50)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        s_eval = trainer.ansatz.sample(S_FLAG, torch.Generator().manual_seed(1))
        trainer.local_energy(s_eval)
        with torch.no_grad():  # log psi of the drawn samples, no gradient after it: B7
            trainer.ansatz.log_amp_parts(s_eval)
        torch.cuda.synchronize()
        c = counts()
        require(c["B7 crnn_log_amp_parts"] == 1 and c["B9 replay"] == 50
                and c["B9 crnn_log_amp_bwd"] == 50,
                "the steps ran B9's replay and B9 from it, B7 only the evaluation after them")
        energies = ms["mean_energy"].cpu().numpy()
        print(f"{smi}: {50 / dt:.2f} steps/s ({1000 * dt / 50:.3f} ms/step)")
        print(f"energy: first {energies[0]:.4f}, last {energies[-1]:.4f} "
              f"(DMRG ground state {E_DMRG_J1J2})")
        # the step's launches by their profiler names (outside the counted run)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = trainer.run_steps(state, 5)
            torch.cuda.synchronize()
        on_card = {e.key: e.count / 5 for e in prof.key_averages() if e.self_device_time_total > 0}

        def per_step(part):
            return sum(v for k, v in on_card.items() if part in k)

        # B9's replay is the teacher-forced base pass storing (ExStore 2)
        step_kernels = {k: per_step(k) for k in (
            "exchange_base_kernel<false, (rnnwf::ExStore)2>", "exchange_base_kernel<true",
            "bwd_sweep_kernel", "bwd_weights_kernel", "sum_partials_kernel",
            "exchange_base_kernel<false, (rnnwf::ExStore)0>")}
        print("launches per step by profiler name (the profiler's counts):", step_kernels)
        require(all(step_kernels[k] > 0 for k in (
                    "exchange_base_kernel<false, (rnnwf::ExStore)2>", "exchange_base_kernel<true",
                    "bwd_sweep_kernel", "bwd_weights_kernel"))
                and step_kernels["exchange_base_kernel<false, (rnnwf::ExStore)0>"] == 0,
                "the J1-J2 step launches B11's base pass and B9's replay, B9's reverse sweep and "
                "weight cotangent, and not B7 (the base pass storing nothing)")
        print("launches:", c)
        require(bool(np.isfinite(energies).all()), "finite J1-J2 flagship energies")
        require(energies[-5:].mean() < energies[:5].mean(), "J1-J2 flagship energies falling")
        require(all(c[k] > 0 for k in crnn_names),
                "every J1-J2 kernel launched in the flagship run")
        launches.update({k: c[k] for k in crnn_names})

    # ---- the 2D flagship inputs: 16x16, U=50, B=500, perturbed weights
    ns = NX_FLAG * NY_FLAG
    mdrnn = perturbed_mdrnn(pkg, NX_FLAG, NY_FLAG, U_FLAG, 2468, dev)
    wm = tuple(t.detach() for t in mdrnn.weights())
    lattices = (torch.rand(S_FLAG, NX_FLAG, NY_FLAG, generator=gen) < 0.5).to(torch.int32).to(dev)
    lp2d_tol = 1e-5 * ns  # 1e-5 per site, as K1

    def check_mdrnn(w, s, label, worst):
        """B12, B14, B15 and B13/B16 against their plain versions on
        lattices ``s``; folds each kernel's largest error into ``worst``."""
        b, nx, ny = s.shape
        tol = 1e-5 * nx * ny
        lk, lp = fused_mdrnn.mdrnn_log_prob(w, s), fused_mdrnn.log_prob_plain(w, s)
        torch.cuda.synchronize()
        e = max_err(lk, lp)
        print(f"B12 ({label}): log p max abs err {e:.3e} (tol {tol:.1e})")
        require(e <= tol, f"B12 log p ({label})")
        worst["B12 mdrnn_log_prob"] = max(worst["B12 mdrnn_log_prob"], e)
        # B12 storing B14's replay against the plain replay; both the same
        # bits on a second run
        stored, want = fused_mdrnn.mdrnn_log_prob(w, s, store=True), fused_mdrnn.replay_plain(w, s)
        stored2, lk2 = fused_mdrnn.mdrnn_log_prob(w, s, store=True), fused_mdrnn.mdrnn_log_prob(w, s)
        torch.cuda.synchronize()
        eh, ep = rel(stored.hist, want.hist), max_err(stored.p1, want.p1)
        same = bool(torch.equal(lk2, lk)) and all(torch.equal(a, c) for a, c in zip(stored2, stored))
        print(f"B12 storing ({label}): log p {max_err(stored.lp, want.lp):.3e} (tol {tol:.1e}), "
              f"history {eh:.3e} of its largest entry (tol {rel_tol:.0e}), p1 {ep:.3e} (tol 1e-5); B12 "
              f"and B12 storing twice, the same bits: {same}")
        require(max_err(stored.lp, want.lp) <= tol and eh <= rel_tol and ep <= 1e-5 and same,
                f"B12 storing B14's replay ({label})")

        gm = torch.randn(b, generator=gen).to(dev)
        gk = fused_mdrnn_bwd.mdrnn_log_prob_bwd(w, s, gm)
        gp = fused_mdrnn.log_prob_bwd_plain(w, s, gm)
        replay = fused_mdrnn.mdrnn_log_prob(w, s, store=True)
        gr = fused_mdrnn_bwd.mdrnn_log_prob_bwd(w, s, gm, replay=replay)
        again = fused_mdrnn_bwd.mdrnn_log_prob_bwd(w, s, gm)
        torch.cuda.synchronize()
        for name, a, c in zip(("uh", "uv", "wh", "wv", "b", "head_w", "head_b"), gk, gp):
            r = rel(a, c)
            print(f"B14 d{name} ({label}): max abs err {max_err(a, c):.3e}, relative {r:.3e} "
                  f"(tol {rel_tol:.0e})")
            require(r <= rel_tol, f"B14 d{name} ({label})")
            worst["B14 mdrnn_log_prob_bwd"] = max(worst["B14 mdrnn_log_prob_bwd"], max_err(a, c))
        er = max(rel(a, c) for a, c in zip(gr, gp))
        same = all(torch.equal(a, c) for a, c in zip(gr, gk))
        twice = all(torch.equal(a, c) for a, c in zip(again, gk))
        print(f"B14 ({label}) from B12's stored replay: relative err {er:.3e} (tol "
              f"{rel_tol:.0e}), the bits of B14 alone: {same}; B14 twice, the same bits: "
              f"{twice}; B12 storing gives B12's log p: {bool(torch.equal(replay.lp, lk))}")
        require(er <= rel_tol and same and twice and bool(torch.equal(replay.lp, lk)),
                f"B14 from the replay, and its bits ({label})")

        rk, l15 = mk.mdrnn_flip_ratio_sum(w, s)
        rp, l15p = mk.flip_ratio_sum_plain(w, s)
        torch.cuda.synchronize()
        er, el = rel(rk, rp), max_err(l15, l15p)
        print(f"B15 ({label}): ratio relative err {er:.3e} (tol {rel_tol:.0e}); log p max abs "
              f"err {el:.3e} (tol {tol:.1e})")
        require(er <= rel_tol and el <= tol, f"B15 ({label})")
        worst["B15 mdrnn_flip_ratio_sum"] = max(worst["B15 mdrnn_flip_ratio_sum"],
                                                max_err(rk, rp), el)

        s16, lp16, r16 = mk.mdrnn_sample_and_flip_sum(w, b, nx, ny, 7, 1)
        s13, lp13 = fused_mdrnn.mdrnn_sample(w, b, nx, ny, 7, 1)
        torch.cuda.synchronize()
        require(tuple(s16.shape) == (b, nx, ny), "B16 sample shape")
        require(bool(((s16 == 0) | (s16 == 1)).all()), "B16 spins in {0, 1}")
        require(bool((s13 == s16).all()), "B13 draws the same lattices as B16 for one key")
        again, _, _ = mk.mdrnn_sample_and_flip_sum(w, b, nx, ny, 7, 1)
        again13, lp13_again = fused_mdrnn.mdrnn_sample(w, b, nx, ny, 7, 1)
        other, _ = fused_mdrnn.mdrnn_sample(w, b, nx, ny, 7, 2)
        require(bool((again == s16).all()), "B16 draws are a function of (seed, offset)")
        require(bool(torch.equal(again13, s13)) and bool(torch.equal(lp13_again, lp13)),
                "B13 twice: the same bits")
        require(not bool((other == s13).all()), "B13 draws change with the offset")
        l12 = fused_mdrnn.mdrnn_log_prob(w, s16)
        r15, _ = mk.mdrnn_flip_ratio_sum(w, s16)
        lp_p = fused_mdrnn.log_prob_plain(w, s16)
        r_p, _ = mk.flip_ratio_sum_plain(w, s16)
        torch.cuda.synchronize()
        e12, e15, ep = max_err(lp16, l12), rel(r16, r15), rel(r16, r_p)
        e13, epl = max_err(lp13, lp_p), max_err(lp16, lp_p)
        print(f"B16 ({label}): log p vs B12 on its samples {e12:.3e}, vs plain {epl:.3e} (tol "
              f"{tol:.1e}); ratio vs B15 relative {e15:.3e}, vs plain B15 {ep:.3e} (tol "
              f"{rel_tol:.0e}); B13 log p vs plain {e13:.3e}")
        require(e12 <= tol and epl <= tol and e15 <= rel_tol and ep <= rel_tol and e13 <= tol,
                f"B13/B16 ({label})")
        worst["B16 mdrnn_sample_and_flip_sum"] = max(
            worst["B16 mdrnn_sample_and_flip_sum"], epl, max_err(r16, r_p))
        worst["B13 mdrnn_sample"] = max(worst["B13 mdrnn_sample"], e13)

    with Phase("10 MDRNN kernels against their plain versions (16x16, U=50, B=500)"):
        worst = {k: 0.0 for k in mdrnn_names}
        check_mdrnn(wm, lattices, "16x16", worst)
        for nx, ny in ((5, 3), (3, 6)):
            small = perturbed_mdrnn(pkg, nx, ny, U_FLAG, 11 * nx + ny, dev)
            ws = tuple(t.detach() for t in small.weights())
            s_small = (torch.rand(37, nx, ny, generator=gen) < 0.5).to(torch.int32).to(dev)
            check_mdrnn(ws, s_small, f"{nx}x{ny}, B=37", worst)
        for k, v in worst.items():
            record[k]["max_abs_err"] = v

        # the float32 rounding of the ratio sums grows with the sites (log p
        # is a sum over them): B15 against its plain version in float64 on
        # Nx x 2 lattices up to the family's widest at U=50, on two seeds (for
        # the weights, then the samples): the card test's (0, 1) and (Nx, Nx)
        widest2 = max(n for n in range(1, 2049) if fused_mdrnn.supports(n, 2, U_FLAG, dev))
        for nx in (16, 128, 257, 512, widest2):
            for seed_w, seed_s in ((0, 1), (nx, nx)):
                ww = tuple(t.detach() for t in
                           perturbed_mdrnn(pkg, nx, 2, U_FLAG, seed_w, dev).weights())
                s_w = (torch.rand(3, nx, 2, generator=torch.Generator().manual_seed(seed_s))
                       < 0.5).to(torch.int32).to(dev)
                ref = mk.flip_ratio_sum_plain(tuple(t.double() for t in ww), s_w)[0]
                e_k, e_p = (float(((r.double() - ref).abs() / ref.abs()).max()) for r in (
                    mk.mdrnn_flip_ratio_sum(ww, s_w)[0], mk.flip_ratio_sum_plain(ww, s_w)[0]))
                print(f"B15 at {nx}x2 ({2 * nx} sites), B=3, seeds {seed_w}, {seed_s}: ratio "
                      f"sums {e_k:.3e} relative from the float64 plain version (tol 1e-4); "
                      f"the float32 plain version {e_p:.3e}")
                require(e_k <= 1e-4, f"B15 at {nx}x2 against the float64 plain version")

        draws = 20000
        tiny = perturbed_mdrnn(pkg, 2, 2, U_FLAG, 12, dev)
        wt = tuple(t.detach() for t in tiny.weights())
        s_tiny, _ = fused_mdrnn.mdrnn_sample(wt, draws, 2, 2, 11, 0)
        codes = (s_tiny.transpose(1, 2).reshape(draws, 4).cpu().numpy() @ (2 ** np.arange(4)))
        freq = np.bincount(codes.astype(int), minlength=16) / draws
        flat = torch.tensor([[(c >> i) & 1 for i in range(4)] for c in range(16)], dtype=torch.int32)
        basis = flat.reshape(16, 2, 2).transpose(1, 2).contiguous().to(dev)  # bit y*2 + x
        probs = torch.exp(fused_mdrnn.log_prob_plain(wt, basis)).cpu().numpy()
        e = float(np.abs(freq - probs).max())
        print(f"B13 sampler at 2x2, {draws} draws: max |freq - p| {e:.4f} (tol 0.02), "
              f"sum p = {probs.sum():.6f}")
        require(e <= 0.02, "B13 sampler distribution")

    with Phase("11 MDRNN kernel times at the flagship shapes (CUDA events)"):
        s16, *_ = mk.mdrnn_sample_and_flip_sum(wm, S_FLAG, NX_FLAG, NY_FLAG, 3, 4)
        uni2 = torch.rand(S_FLAG, ns, generator=gen).to(dev)
        g2 = torch.randn(S_FLAG, generator=gen).to(dev)
        pairs = {
            "B12 mdrnn_log_prob": (lambda: fused_mdrnn.mdrnn_log_prob(wm, s16),
                                   lambda: fused_mdrnn.log_prob_plain(wm, s16)),
            "B13 mdrnn_sample": (
                lambda: fused_mdrnn.mdrnn_sample(wm, S_FLAG, NX_FLAG, NY_FLAG, 3, 4),
                lambda: fused_mdrnn.sample_plain(wm, uni2, NX_FLAG, NY_FLAG)),
            "B14 mdrnn_log_prob_bwd": (
                lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd(wm, s16, g2),
                lambda: fused_mdrnn.log_prob_bwd_plain(wm, s16, g2)),
            "B15 mdrnn_flip_ratio_sum": (lambda: mk.mdrnn_flip_ratio_sum(wm, s16),
                                         lambda: mk.flip_ratio_sum_plain(wm, s16)),
            "B16 mdrnn_sample_and_flip_sum": (
                lambda: mk.mdrnn_sample_and_flip_sum(wm, S_FLAG, NX_FLAG, NY_FLAG, 3, 4),
                lambda: mk.sample_and_flip_sum_plain(wm, uni2, NX_FLAG, NY_FLAG)),
        }
        for name, (kern, plain) in pairs.items():
            record[name]["ms"] = cuda_ms(kern, reps=10)
            record[name]["plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            print(f"{name}: kernel {record[name]['ms']:.4f} ms, "
                  f"plain {record[name]['plain_ms']:.4f} ms")
        replay = fused_mdrnn.mdrnn_log_prob(wm, s16, store=True)
        store_ms = cuda_ms(lambda: fused_mdrnn.mdrnn_log_prob(wm, s16, store=True), reps=10)
        from_replay_ms = cuda_ms(
            lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd(wm, s16, g2, replay=replay), reps=10)
        print(f"B12 storing B14's replay: {store_ms:.4f} ms; B14 from that replay (as the "
              f"training step runs it): {from_replay_ms:.4f} ms")
        print_launches("B16", lambda: mk.mdrnn_sample_and_flip_sum(wm, S_FLAG, NX_FLAG, NY_FLAG,
                                                                   3, 4),
                       {"base pass": "mdrnn_sweep_kernel", "suffix pass": "mdrnn_tc_suffix_kernel",
                        "ratio sum": "mdrnn_flip_sum_kernel"}, calls=5)
        b14_parts = {"replay": "mdrnn_sweep_kernel", "reverse sweep": "mdrnn_bwd_sweep_kernel",
                     "weight cotangent": "mdrnn_bwd_weights_kernel",
                     "chunk sum": "sum_partials_kernel"}
        print_launches("B14", lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd(wm, s16, g2), b14_parts)
        print_launches("B14 from the replay",
                       lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd(wm, s16, g2, replay=replay),
                       {k: v for k, v in b14_parts.items() if k != "replay"})
        b_, m_, u_ = S_FLAG, ns, U_FLAG
        wb = 4 * sum(t.numel() for t in wm)
        steps_sweep = b_ * m_
        steps_flip = steps_sweep + b_ * m_ * (m_ + 1) // 2
        work2d = {
            "B12 mdrnn_log_prob": (steps_sweep * mdrnn_site_flops(u_), 4 * b_ * m_ + wb + 4 * b_),
            "B13 mdrnn_sample": (steps_sweep * mdrnn_site_flops(u_), wb + 4 * b_ * m_ + 4 * b_),
            "B14 mdrnn_log_prob_bwd": (steps_sweep * mdrnn_bwd_site_flops(u_),
                                       4 * b_ * m_ + 4 * b_ + 2 * wb),
            "B15 mdrnn_flip_ratio_sum": (steps_flip * mdrnn_site_flops(u_),
                                         4 * b_ * m_ + wb + 8 * b_),
            "B16 mdrnn_sample_and_flip_sum": (steps_flip * mdrnn_site_flops(u_),
                                              wb + 4 * b_ * m_ + 8 * b_),
        }
        print(f"MDRNN flip site steps at the flagship: {steps_flip}")
        widest = max(n for n in range(1, 513) if fused_mdrnn.supports(n, 16, U_FLAG, dev))
        largest = {n: max(u for u in range(1, 257) if fused_mdrnn.supports(n, n, u, dev))
                   for n in (1, 16, 32, 48)}
        print(f"MDRNN kernels cover Nx <= {widest} at U={U_FLAG}; the largest U at "
              f"Nx = Ny = 1, 16, 32, 48: {largest}")
        require(fused_mdrnn.supports(NX_FLAG, NY_FLAG, U_FLAG, dev), "the flagship is covered")
        for name, (flops, nbytes) in work2d.items():
            record[name]["bound_ms"], record[name]["bound_by"] = bound(flops, nbytes)
            tc_txt = ""
            if name.split()[0] in ("B15", "B16"):
                record[name]["tc_bound_ms"] = mdrnn_tc_bound(steps_flip, u_, nbytes)
                tc_txt = (f"; tensor-core bound {record[name]['tc_bound_ms']:.4f} ms, shares "
                          f"FP32 {record[name]['bound_ms'] / record[name]['ms']:.1%}, tensor "
                          f"cores {record[name]['tc_bound_ms'] / record[name]['ms']:.1%}")
            print(f"{name}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.3f} MB: bound "
                  f"{record[name]['bound_ms']:.4f} ms ({record[name]['bound_by']}), "
                  f"kernel {record[name]['ms']:.4f} ms{tc_txt}")

    with Phase("12 2D TFIM VMC at 3x3, Bx=3 against exact diagonalization"):
        e_exact = exact.ground_state_energy(exact.tfim2d_dense(3, 3, BX_2D))
        trainer = pkg.VMCTrainer(pkg.MDRNN2D(3, 3, U_FLAG, device=dev),
                                 pkg.TFIM2D(3, 3, BX_2D, encoding="grid"),
                                 pkg.TrainConfig(num_samples=S_FLAG))
        state = trainer.init()
        reset_counts()
        state, ms = trainer.run_steps(state, MDRNN_VMC_STEPS)
        trainer.local_energy(trainer.ansatz.sample(S_FLAG, torch.Generator().manual_seed(0)))
        torch.cuda.synchronize()
        c = counts()
        print("launches:", c)
        require(all(c[k] > 0 for k in mdrnn_names), "every MDRNN kernel launched")
        e_vmc = float(ms["mean_energy"][-50:].mean())
        rel_err = abs(e_vmc - e_exact) / abs(e_exact)
        print(f"3x3: E_vmc (mean of the last 50 steps) {e_vmc:.6f}, E_exact {e_exact:.6f}, "
              f"relative error {rel_err:.3e} (tol {MDRNN_VMC_TOL:.0e})")
        require(rel_err <= MDRNN_VMC_TOL, "3x3 relative error against ED")

    with Phase("13 2D flagship: MDRNN2D 16x16, U=50, on TFIM2D(16, 16, Bx=3), S=500, "
               "Adam lr 5e-3"):
        trainer = pkg.VMCTrainer(pkg.MDRNN2D(NX_FLAG, NY_FLAG, U_FLAG, device=dev),
                                 pkg.TFIM2D(NX_FLAG, NY_FLAG, BX_2D, encoding="grid"),
                                 pkg.TrainConfig(num_samples=S_FLAG, learning_rate=5e-3))
        state = trainer.init()
        trainer.run_steps(state, 3)  # warm-up (allocator)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, ms = trainer.run_steps(state, 50)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        trainer.local_energy(trainer.ansatz.sample(S_FLAG, torch.Generator().manual_seed(1)))
        torch.cuda.synchronize()
        c = counts()
        energies = ms["mean_energy"].cpu().numpy()
        print(f"{smi}: {50 / dt:.2f} steps/s ({1000 * dt / 50:.3f} ms/step)")
        print(f"energy: first {energies[0]:.4f}, last {energies[-1]:.4f} "
              f"(per site {energies[-1] / ns:.4f})")
        print("launches:", c)
        require(bool(np.isfinite(energies).all()), "finite 2D flagship energies")
        require(energies[-5:].mean() < energies[:5].mean(), "2D flagship energies falling")
        require(all(c[k] > 0 for k in mdrnn_names),
                "every MDRNN kernel launched in the 2D flagship run")
        launches.update({k: c[k] for k in mdrnn_names})

    # ---- phases 14-17: the stand-alone samplers, the per-flip log p, and the
    # parity and snake paths; N=100, U=50, B=500 with phase 2's and phase 6's
    # perturbed weights (w, wc) and random chains (samples)
    def rel_elementwise(got, want):
        return float(((got.double() - want.double()).abs() / want.double().abs()).max())

    def freq_err(s, n, probs):
        codes = (s.cpu().numpy() @ (2 ** np.arange(n))).astype(int)
        freq = np.bincount(codes, minlength=1 << n) / s.shape[0]
        return float(np.abs(freq - probs).max())

    def basis(n):
        return torch.tensor([[(c >> i) & 1 for i in range(n)] for c in range(1 << n)],
                            dtype=torch.int32, device=dev)

    with Phase("14 B5, B6 and B8 against their plain versions (N=100, U=50, B=500)"):
        s5, lp5 = fused_gru.gru_sample(w, S_FLAG, N_FLAG, 7, 1)
        s3, lp3, _ = tk.tfim_sample_and_flip_sum(w, S_FLAG, N_FLAG, 7, 1)
        lp5_p = fused_gru.log_prob_plain(w, s5)
        torch.cuda.synchronize()
        e = max_err(lp5, lp5_p)
        same = bool(torch.equal(s5, s3)) and bool(torch.equal(lp5, lp3))
        print(f"B5: log p vs plain K1 on its samples: max abs err {e:.3e} (tol {lp_tol:.1e}); "
              f"spins and log p equal to K3's for one key, bit for bit: {same}")
        require(e <= lp_tol and same, "B5 against plain and K3")
        require(not bool(torch.equal(fused_gru.gru_sample(w, S_FLAG, N_FLAG, 7, 2)[0], s5)),
                "B5 draws change with the offset")
        record["B5 gru_sample"]["max_abs_err"] = e

        lpf, lp6 = tk.tfim_flip_log_probs(w, samples)
        lpf_p, lp6_p = tk.per_flip_log_probs_plain(w, samples)
        ratio4, lp4 = tk.tfim_flip_ratio_sum(w, samples)
        torch.cuda.synchronize()
        ef, el = max_err(lpf, lpf_p), max_err(lp6, lp6_p)
        er = rel_elementwise(tk.ratio_sum(lpf, lp6), ratio4)
        print(f"B6a: lpf max abs err {ef:.3e}, log p {el:.3e} (tol {lp_tol:.1e}), lpf in "
              f"[{float(lpf.min()):.2f}, {float(lpf.max()):.2f}], all finite "
              f"{bool(torch.isfinite(lpf).all())}; flip-order sum of exp(0.5 (lpf - lp)) vs "
              f"K4's ratio: relative err {er:.3e} (tol 1e-5); log p equal to K4's: "
              f"{bool(torch.equal(lp6, lp4))}")
        require(ef <= lp_tol and el <= lp_tol and bool(torch.isfinite(lpf).all()), "B6a")
        require(er <= 1e-5 and bool(torch.equal(lp6, lp4)), "B6a against K4")
        record["B6a tfim_flip_log_probs"]["max_abs_err"] = max(ef, el)

        s6, lp6s, lpf6 = tk.tfim_sample_and_flip_sum(w, S_FLAG, N_FLAG, 7, 1, per_flip=True)
        lpf6_t, lp6_t = tk.tfim_flip_log_probs(w, s6)
        lpf6_p, lp6s_p = tk.per_flip_log_probs_plain(w, s6)
        torch.cuda.synchronize()
        same = (bool(torch.equal(s6, s3)) and bool(torch.equal(lpf6, lpf6_t))
                and bool(torch.equal(lp6s, lp6_t)))
        e = max(max_err(lpf6, lpf6_p), max_err(lp6s, lp6s_p))
        print(f"B6b: K3's draws, and lpf and log p equal to B6a's on them, bit for bit: {same}; "
              f"vs plain: max abs err {e:.3e} (tol {lp_tol:.1e})")
        require(same and e <= lp_tol, "B6b")
        record["B6b tfim_sample_and_flip_sum per_flip"]["max_abs_err"] = e

        s8, lp8 = fused_crnn.crnn_sample(wc, S_FLAG, N_FLAG, 7, 1, True)
        s11, _, _, lp11_re, lp11_im = jk.j1j2_sample_and_exchange(wc, S_FLAG, N_FLAG, 7, 1,
                                                                  u1=True, **flag_info)
        re7, im7 = fused_crnn.crnn_log_amp_parts(wc, s11, True)
        re_p, _ = fused_crnn.log_amp_parts_plain(wc, s8, True)
        torch.cuda.synchronize()
        same = bool(torch.equal(s8, s11)) and bool(torch.equal(lp8, 2.0 * lp11_re))
        same7 = bool(torch.equal(re7, lp11_re)) and bool(torch.equal(im7, lp11_im))
        in_sector = bool((s8.sum(dim=1) == N_FLAG // 2).all())
        ep = max_err(lp8, 2.0 * re_p)
        print(f"B8: spins equal to B11's and log |psi|^2 to 2 Re log psi of B11, bit for bit: "
              f"{same}; zero magnetisation: {in_sector}; B7's (Re, Im) on those samples equal "
              f"to B11's log psi, bit for bit: {same7}; vs plain {ep:.3e} (tol {2 * lp_tol:.1e})")
        require(same and same7 and in_sector and ep <= 2 * lp_tol, "B8 and B7 against B11")
        record["B8 crnn_sample"]["max_abs_err"] = ep

        draws = 20000
        small = perturbed_model(pkg, 3, U_FLAG, 5, dev)  # phase 2's N=3 model and key
        ws = tuple(t.detach() for t in small.weights())
        s_small, _ = fused_gru.gru_sample(ws, draws, 3, 11, 0)
        probs = torch.exp(fused_gru.log_prob_plain(ws, basis(3))).cpu().numpy()
        e = freq_err(s_small, 3, probs)
        print(f"B5 sampler at N=3, {draws} draws: max |freq - p| {e:.4f} (tol 0.01)")
        require(e <= 0.01, "B5 sampler distribution")
        small = perturbed_model(pkg, 4, U_FLAG, 6, dev, cls="CRNNU1")  # phase 6's N=4 model
        ws4 = tuple(t.detach() for t in small.weights())
        s_small, _ = fused_crnn.crnn_sample(ws4, draws, 4, 11, 0, True)
        probs = torch.exp(2.0 * fused_crnn.log_amp_parts_plain(ws4, basis(4), True)[0])
        e = freq_err(s_small, 4, probs.cpu().numpy())
        print(f"B8 sampler at N=4, {draws} draws: max |freq - |psi|^2| {e:.4f} (tol 0.01)")
        require(e <= 0.01, "B8 sampler distribution")

    with Phase("15 B5, B6 and B8 times at the flagship shapes (CUDA events) and coverage"):
        uni3 = torch.rand(S_FLAG, N_FLAG, generator=gen).to(dev)
        pairs = {
            "B5 gru_sample": (lambda: fused_gru.gru_sample(w, S_FLAG, N_FLAG, 3, 4),
                              lambda: fused_gru.sample_plain(w, uni3)),
            "B6a tfim_flip_log_probs": (lambda: tk.tfim_flip_log_probs(w, samples),
                                        lambda: tk.per_flip_log_probs_plain(w, samples)),
            "B6b tfim_sample_and_flip_sum per_flip": (
                lambda: tk.tfim_sample_and_flip_sum(w, S_FLAG, N_FLAG, 3, 4, per_flip=True),
                lambda: tk.sample_and_per_flip_plain(w, uni3)),
            "B8 crnn_sample": (lambda: fused_crnn.crnn_sample(wc, S_FLAG, N_FLAG, 3, 4, True),
                               lambda: fused_crnn.sample_plain(wc, uni3, True)),
        }
        for name, (kern, plain) in pairs.items():
            record[name]["ms"] = cuda_ms(kern, reps=20)
            record[name]["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
            print(f"{name}: kernel {record[name]['ms']:.4f} ms, "
                  f"plain {record[name]['plain_ms']:.4f} ms")
        b_, n_, u_ = S_FLAG, N_FLAG, U_FLAG
        steps_chain = b_ * n_ + b_ * n_ * (n_ - 1) // 2  # base pass plus the flip suffixes
        work_new = {
            "B5 gru_sample": (b_ * n_ * site_flops(u_, 1), w6 + 4 * b_ * n_ + 4 * b_),
            "B6a tfim_flip_log_probs": (steps_chain * site_flops(u_, 1),
                                        4 * b_ * n_ + w6 + 4 * b_ * n_ + 4 * b_),
            "B6b tfim_sample_and_flip_sum per_flip": (steps_chain * site_flops(u_, 1),
                                                      w6 + 8 * b_ * n_ + 4 * b_),
            "B8 crnn_sample": (b_ * n_ * site_flops(u_, 2), w8 + 4 * b_ * n_ + 4 * b_),
        }
        for name, (flops, nbytes) in work_new.items():
            record[name]["bound_ms"], record[name]["bound_by"] = bound(flops, nbytes)
            tc_txt = ""
            if name.startswith("B6"):
                record[name]["tc_bound_ms"] = tc_bound(steps_chain, u_, nbytes)
                tc_txt = (f"; tensor-core bound {record[name]['tc_bound_ms']:.4f} ms, share "
                          f"{record[name]['tc_bound_ms'] / record[name]['ms']:.1%}")
            print(f"{name}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.3f} MB: bound "
                  f"{record[name]['bound_ms']:.4f} ms ({record[name]['bound_by']}), "
                  f"kernel {record[name]['ms']:.4f} ms{tc_txt}")
        limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
        over = [k for k, v in fused_crnn.shared_memory_bytes(crnn_u + 1).items() if v > limit]
        print(f"coverage at N={N_FLAG}: B5 and B6 run K3/K4's base and suffix launches, covered "
              f"by the K1-K4 family to U={gru_u}; B8 runs B11's base launch, covered by the cRNN "
              f"family to U={crnn_u} (U <= 91 before B9's three stages); at U={crnn_u + 1} "
              f"{', '.join(over)} does not fit in {limit} bytes of shared memory")
        require(gru_u >= U_FLAG and crnn_u >= U_FLAG, "the flagships are covered")
        require(gru_u >= 91 and crnn_u >= 91,
                "the K1-K4 and cRNN families take every width to U=91 on an H100")
        require(gru_u >= 120, "the K1-K4 family takes every width to U=120 on an H100, through "
                "the turned-around suffix pass to U=56 and the first one past it")
        wide = tuple(t.detach() for t in perturbed_model(pkg, 4, gru_u + 1, 3, dev).weights())
        wide_c = tuple(t.detach() for t in
                       perturbed_model(pkg, 4, crnn_u + 1, 3, dev, cls="CRNNU1").weights())
        for label, call in (
                ("B5", lambda: fused_gru.gru_sample(wide, 8, 4, 0, 0)),
                ("B6a", lambda: tk.tfim_flip_log_probs(wide, samples[:8, :4].contiguous())),
                ("B6b", lambda: tk.tfim_sample_and_flip_sum(wide, 8, 4, 0, 0, per_flip=True)),
                ("B8", lambda: fused_crnn.crnn_sample(wide_c, 8, 4, 0, 0, True))):
            try:
                call()
            except ValueError as exc:
                print(f"{label} one unit past its coverage: raises ({exc})")
            else:
                raise RuntimeError(f"check failed: {label} ran past its shared-memory coverage")

    with Phase("16 parity VMC at N=10 and snake VMC at 3x3, Bx=3, against exact "
               "diagonalization"):
        reset_counts()
        n = 10
        e_exact = exact.ground_state_energy(exact.tfim1d_dense(n, 1.0))
        trainer = pkg.VMCTrainer(pkg.PRNN1D(n, (U_FLAG,), parity=True, device=dev),
                                 pkg.TFIM1D(n, 1.0), pkg.TrainConfig(num_samples=S_FLAG))
        state = trainer.init()
        state, ms = trainer.run_steps(state, PARITY_VMC_STEPS)
        trainer.local_energy(trainer.ansatz.sample(S_FLAG, torch.Generator().manual_seed(0)))
        e_vmc = float(ms["mean_energy"][-50:].mean())
        rel_err = abs(e_vmc - e_exact) / abs(e_exact)
        print(f"parity N=10: E_vmc (mean of the last 50 of {PARITY_VMC_STEPS} steps) "
              f"{e_vmc:.6f}, E_exact {e_exact:.6f}, relative error {rel_err:.3e} "
              f"(tol {PARITY_VMC_TOL:.0e})")
        require(rel_err <= PARITY_VMC_TOL, "parity N=10 relative error against ED")
        e_exact = exact.ground_state_energy(exact.tfim2d_dense(3, 3, BX_2D))
        trainer = pkg.VMCTrainer(pkg.PRNNSnake2D(3, 3, (U_FLAG,), device=dev),
                                 pkg.TFIM2D(3, 3, BX_2D), pkg.TrainConfig(num_samples=S_FLAG))
        state = trainer.init()
        state, ms = trainer.run_steps(state, SNAKE_VMC_STEPS)
        trainer.local_energy(trainer.ansatz.sample(S_FLAG, torch.Generator().manual_seed(0)))
        torch.cuda.synchronize()
        c = counts()
        print("launches:", c)
        e_vmc = float(ms["mean_energy"][-50:].mean())
        rel_err = abs(e_vmc - e_exact) / abs(e_exact)
        print(f"snake 3x3: E_vmc (mean of the last 50 of {SNAKE_VMC_STEPS} steps) {e_vmc:.6f}, "
              f"E_exact {e_exact:.6f}, relative error {rel_err:.3e} (tol {SNAKE_VMC_TOL:.0e})")
        require(rel_err <= SNAKE_VMC_TOL, "snake 3x3 relative error against ED")
        require(all(c[k] > 0 for k in new_names if k != "B8 crnn_sample")
                and all(c[k] > 0 for k in c if k.startswith("K")),
                "every B5, B6 and K1-K4 counter moved")

    with Phase("17 flagships: parity PRNN1D N=100 and snake PRNNSnake2D 10x10, GRU 50, "
               "S=500, Adam lr 5e-3"):
        crnn_flag = pkg.CRNNU1(N_FLAG, (U_FLAG,), device=dev).init(torch.Generator().manual_seed(3))
        flagships = {
            "parity": (pkg.PRNN1D(N_FLAG, (U_FLAG,), parity=True, device=dev),
                       pkg.TFIM1D(N_FLAG, 1.0), "DMRG ground state of the chain -126.9618766964"),
            "snake": (pkg.PRNNSnake2D(NX_SNAKE, NY_SNAKE, (U_FLAG,), device=dev),
                      pkg.TFIM2D(NX_SNAKE, NY_SNAKE, BX_2D),
                      f"{NX_SNAKE}x{NY_SNAKE}, Bx={BX_2D}"),
        }
        for label, (ansatz, ham, ref) in flagships.items():
            trainer = pkg.VMCTrainer(ansatz, ham,
                                     pkg.TrainConfig(num_samples=S_FLAG, learning_rate=5e-3))
            state = trainer.init()
            trainer.run_steps(state, 3)  # warm-up (allocator)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            state, ms = trainer.run_steps(state, 50)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            in_steps = counts()
            trainer.local_energy(trainer.ansatz.sample(S_FLAG, torch.Generator().manual_seed(1)))
            crnn_flag.sample(S_FLAG, torch.Generator().manual_seed(2))
            torch.cuda.synchronize()
            c = counts()
            energies = ms["mean_energy"].cpu().numpy()
            print(f"{label}: {smi}: {50 / dt:.2f} steps/s ({1000 * dt / 50:.3f} ms/step)")
            print(f"{label}: energy: first {energies[0]:.4f}, last {energies[-1]:.4f} ({ref})")
            print(f"{label}: launches in the 50 steps:", in_steps)
            print(f"{label}: launches with the samples:", c)
            require(bool(np.isfinite(energies).all()), f"finite {label} flagship energies")
            require(energies[-5:].mean() < energies[:5].mean(), f"{label} flagship energies falling")
            require(c["K3 tfim_sample_and_flip_sum"] == in_steps["K3 tfim_sample_and_flip_sum"]
                    and c["B11 j1j2_sample_and_exchange"] == 0,
                    "PRNN1D.sample and CRNNU1.sample launch neither K3 nor B11")
            require(c["B5 gru_sample"] == in_steps["B5 gru_sample"] + 1
                    and c["B8 crnn_sample"] == 1, "the samples ran B5 and B8")
            if label == "parity":
                require(all(c[k] > 0 for k in new_names) and c["K1 gru_log_prob"] >= 100
                        and c["K2 gru_log_prob_bwd"] >= 100,
                        "every parity kernel launched in the parity flagship run")
                launches.update({k: c[k] for k in new_names})
            else:
                require(all(c[k] > 0 for k in c if k.startswith("K")),
                        "K1-K4 launched in the snake flagship run")

    # ---- phases 18-21: minSR.  Phase 2's and phase 6's perturbed models and
    # weights (model, w; crnn, wc) and random chains (samples), B11's samples
    def tree_err(got, want):
        """(largest abs error, largest error over its leaf's largest |want|)
        over the leaves of two row trees."""
        pairs = list(zip(interop.tree_leaves(got), interop.tree_leaves(want)))
        return max(max_err(a, b) for a, b in pairs), max(rel(a, b) for a, b in pairs)

    def plain_twin(ansatz, cls, n):
        twin = getattr(pkg, cls)(n, (U_FLAG,), impl="plain", device=dev)
        twin.load_state_dict(ansatz.state_dict())
        return twin

    def relative_residual(t, c, x):
        return float((t.double() @ x.double() - c.double()).norm() / c.double().norm())

    def spd_system(s_cg):
        """A symmetric positive definite (S, S) system of an SR Gram's form,
        A A^T / (2S) + 1e-2 I with A (S, 2S), and a right-hand side."""
        a = torch.randn(s_cg, 2 * s_cg, generator=gen, dtype=torch.float64)
        t = (a @ a.T / (2 * s_cg) + 1e-2 * torch.eye(s_cg, dtype=torch.float64)).float()
        return t.to(dev), torch.randn(s_cg, generator=gen).to(dev)

    # B21's limits per system, (against the plain CG, relative residual):
    # read 2.8e-5 and 3.0e-6 on the TFIM Gram, 4.9e-5 and 1.4e-3 on the
    # J1-J2 Gram (condition number ~6e4; the plain CG's residual 2.7e-3)
    cg_tol = {"TFIM (S, S)": (1e-3, 1e-4), "J1-J2 (2S, 2S)": (1e-3, 1e-2)}
    long_samples = (torch.rand(S_LONG, N_LONG, generator=gen) < 0.5).to(torch.int32).to(dev)
    plain_tfim = plain_twin(model, "PRNN1D", N_FLAG)
    plain_crnn = plain_twin(crnn, "CRNNU1", N_FLAG)
    ham_tfim = pkg.TFIM1D(N_FLAG, 1.0)
    s11, e11, e11_im, _, _ = jk.j1j2_sample_and_exchange(wc, S_FLAG, N_FLAG, 7, 1, u1=True,
                                                         **flag_info)
    e11 = configs["open, J2=0.2"].diagonal(s11) + e11
    trunk_c = wc[:4]
    systems = {}

    with Phase("18 minSR kernels against their plain versions (B17-B21)"):
        for name, s_in in (("B17 jac_sweep", samples), ("B18 jac_sweep N=1000", long_samples)):
            b, n = s_in.shape
            sweeps = fused_jac.jac_sweep(w, s_in), fused_jac.jac_sweep_plain(w, s_in)
            got, want = ((t.hist, t.dg, t.dl1) for t in sweeps)
            torch.cuda.synchronize()
            errs = [rel(a, ref) for a, ref in zip(got, want)]
            print(f"{name} (N={n}, B={b}): hist, dg, dl1 errors over their largest entry "
                  f"{', '.join(f'{e:.3e}' for e in errs)} (tol {rel_tol:.0e})")
            require(max(errs) <= rel_tol, f"{name} outputs")
            lp_k, rows_k = fused_jac.prnn1d_rows(w, s_in)
            lp_p, rows_p = jacobian._prnn1d_log_prob_rows(plain_tfim, s_in)
            torch.cuda.synchronize()
            e_lp, (e_abs, e_rows) = max_err(lp_k, lp_p), tree_err(rows_k, rows_p)
            print(f"{name}: per-sample rows against the plain (autodiff) rows: error over the "
                  f"leaf's largest entry {e_rows:.3e} (tol {rel_tol:.0e}), max abs {e_abs:.3e}; "
                  f"log p max abs err {e_lp:.3e} (tol {1e-5 * n:.1e})")
            require(e_rows <= rel_tol and e_lp <= 1e-5 * n, f"{name} rows")
            record[name]["max_abs_err"] = max(
                max_err(a, ref) for a, ref in zip((sweeps[0].hist, sweeps[0].dg, sweeps[0].dl1),
                                                  (sweeps[1].hist, sweeps[1].dg, sweeps[1].dl1)))

        # B19 storing the gates and B20 from them, as the minSR step runs them
        hist_k, gates_k = fused_jac.rollout_hist(trunk_c, s11, store=True)
        hist_p, gates_p = fused_jac.rollout_hist_plain(trunk_c, s11, store=True)
        sites = torch.arange(N_FLAG, device=dev)
        dla, dlp = jacobian.crnn_head_seeds(crnn, hist_k, s11,
                                            torch.cumsum(s11, dim=1) - s11, sites)
        douts = torch.stack([dla @ wc[4].T, dlp @ wc[6].T])
        dg_k = fused_jac.sweep_dgates(trunk_c, s11, hist_k, douts, gates=gates_k)
        dg_p = fused_jac.sweep_dgates_plain(trunk_c, s11, hist_k, douts)
        dg_st = fused_jac.sweep_stored_plain(trunk_c, hist_k, gates_k, douts)
        dg_alone = fused_jac.sweep_dgates(trunk_c, s11, hist_k, douts)
        hist_1 = fused_jac.rollout_hist(trunk_c, s11)
        torch.cuda.synchronize()
        e19 = max(rel(hist_k, hist_p), rel(gates_k, gates_p))
        e20 = max(rel(dg_k[p], dg_p[p]) for p in range(2))
        e20_st = max(rel(dg_k[p], dg_st[p]) for p in range(2))
        same = bool(torch.equal(dg_alone, dg_k)) and bool(torch.equal(hist_1, hist_k))
        print(f"B19 storing, hist and gates: error over their largest entry {e19:.3e}; B20 dg "
              f"from the stored gates (Re and Im parts, one launch) against the plain sweep "
              f"that recomputes the gates {e20:.3e}, against its stored-gates plain twin "
              f"{e20_st:.3e} (tol {rel_tol:.0e}); B20 alone (B19 storing first) and B19 not "
              f"storing give the same bits: {same}")
        require(e19 <= rel_tol and e20 <= rel_tol and e20_st <= rel_tol and same, "B19 and B20")
        record["B19 rollout_hist"]["max_abs_err"] = max(max_err(hist_k, hist_p),
                                                        max_err(gates_k, gates_p))
        record["B20 sweep_dgates"]["max_abs_err"] = max_err(dg_k, dg_p)
        rows_k = jacobian._crnn_rows_fused(crnn, s11)
        rows_p = jacobian.crnn_log_amp_rows(plain_crnn, s11)
        torch.cuda.synchronize()
        e_rows = max(tree_err(a, ref)[1] for a, ref in zip(rows_k, rows_p))
        print(f"B19 + B20 (Re, Im) rows against the plain (autodiff) rows: error over the "
              f"leaf's largest entry {e_rows:.3e} (tol {rel_tol:.0e})")
        require(e_rows <= rel_tol, "the cRNN rows")

        s3, _, ratio3 = tk.tfim_sample_and_flip_sum(w, S_FLAG, N_FLAG, 7, 1)
        e3 = ham_tfim.diagonal(s3) + ham_tfim.uniform_flip_element * ratio3
        systems["TFIM (S, S)"] = minsr.sample_space_system(
            minsr.per_sample_log_amp_grad_trees(model, s3)[0], None, e3, None, e3.mean(), None,
            1e-2)[:2]
        rows_re, rows_im = minsr.per_sample_log_amp_grad_trees(crnn, s11)
        systems["J1-J2 (2S, 2S)"] = minsr.sample_space_system(
            rows_re, rows_im, e11, e11_im, e11.mean(), e11_im.mean(), 1e-2)[:2]
        worst = 0.0
        for label, (t, c) in systems.items():
            x_k = sr_cg.sr_cg_solve(t, c, 64)
            x_p = sr_cg.cg_solve_plain(t, c, 64)
            x_c = torch.cholesky_solve(c[:, None], torch.linalg.cholesky(t))[:, 0]
            again = sr_cg.sr_cg_solve(t, c, 64)
            torch.cuda.synchronize()
            e_p = float((x_k - x_p).norm() / x_p.norm())
            r_k, r_p, r_c = (relative_residual(t, c, x) for x in (x_k, x_p, x_c))
            tol_p, tol_r = cg_tol[label]
            print(f"B21 on the {label} Gram (S={t.shape[0]}): |x - x_plain| / |x_plain| {e_p:.3e} "
                  f"(tol {tol_p:.0e}); relative residual {r_k:.3e} (tol {tol_r:.0e}), plain CG "
                  f"{r_p:.3e}, Cholesky {r_c:.3e}; the same bits twice: "
                  f"{bool(torch.equal(again, x_k))}")
            require(e_p <= tol_p and r_k <= tol_r and bool(torch.equal(again, x_k)),
                    f"B21 on the {label} Gram")
            worst = max(worst, max_err(x_k, x_p))
        # each of B21's paths, chosen by S, on an SR-Gram-like system A A^T /
        # (2S) + 1e-2 I: one block at the N=1000 chain's S=64, clusters of 4
        # blocks at S=230 and of 8 at the TFIM S=500, the cooperative grid at
        # the J1-J2 2S=1000 and at S=3000
        for s_cg, want_path in ((64, "block"), (230, "cluster"), (500, "cluster"),
                                (1000, "grid"), (3000, "grid")):
            t, c = spd_system(s_cg)
            x_k = sr_cg.sr_cg_solve(t, c, 64)
            taken = sr_cg.sr_cg_solve.last_path
            again = sr_cg.sr_cg_solve(t, c, 64)
            x_p = sr_cg.cg_solve_plain(t, c, 64)
            x_c = torch.cholesky_solve(c[:, None], torch.linalg.cholesky(t))[:, 0]
            torch.cuda.synchronize()
            e_p, e_c = (float((x_k - ref).norm() / ref.norm()) for ref in (x_p, x_c))
            print(f"B21 on the {taken} path (S={s_cg}): |x - x_plain| / |x_plain| {e_p:.3e}, "
                  f"against Cholesky {e_c:.3e} (tol 1e-4); the same bits twice: "
                  f"{bool(torch.equal(again, x_k))}")
            require(taken == want_path and e_p <= 1e-4 and e_c <= 1e-4
                    and bool(torch.equal(again, x_k)),
                    f"B21 on the {want_path} path at S={s_cg} (took the {taken} path)")
            worst = max(worst, max_err(x_k, x_p))
        record["B21 sr_cg_solve"]["max_abs_err"] = worst

    with Phase("19 minSR kernel times (CUDA events), bounds and coverage"):
        gru = torch.nn.GRU(2, U_FLAG, batch_first=True).to(dev)
        with torch.no_grad():
            for p, src in zip((gru.weight_ih_l0, gru.weight_hh_l0, gru.bias_ih_l0,
                               gru.bias_hh_l0), (wc[0].T, wc[1].T, wc[2], wc[3])):
                p.copy_(src)
        x0 = fused_jac.input_onehot_rows(s11)

        @torch.no_grad()
        def cudnn_gru():
            return gru(x0)[0]

        print(f"torch.nn.GRU (cuDNN) hidden states against B19's history: max abs err "
              f"{max_err(cudnn_gru(), hist_k):.3e}")
        t_tfim, c_tfim = systems["TFIM (S, S)"]
        t_j, c_j = systems["J1-J2 (2S, 2S)"]
        pairs = {
            "B17 jac_sweep": (lambda: fused_jac.jac_sweep(w, samples),
                              lambda: fused_jac.jac_sweep_plain(w, samples), None),
            "B18 jac_sweep N=1000": (lambda: fused_jac.jac_sweep(w, long_samples),
                                     lambda: fused_jac.jac_sweep_plain(w, long_samples), None),
            "B19 rollout_hist": (
                lambda: fused_jac.rollout_hist(trunk_c, s11, store=True),
                lambda: fused_jac.rollout_hist_plain(trunk_c, s11, store=True), None),
            "B20 sweep_dgates": (
                lambda: fused_jac.sweep_dgates(trunk_c, s11, hist_k, douts, gates=gates_k),
                lambda: fused_jac.sweep_dgates_plain(trunk_c, s11, hist_k, douts), None),
            "B21 sr_cg_solve": (
                lambda: sr_cg.sr_cg_solve(t_tfim, c_tfim, 64),
                lambda: sr_cg.cg_solve_plain(t_tfim, c_tfim, 64),
                lambda: torch.cholesky_solve(c_tfim[:, None], torch.linalg.cholesky(t_tfim))),
        }
        for name, (kern, plain, library) in pairs.items():
            record[name]["ms"] = cuda_ms(kern, reps=20)
            record[name]["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
            record[name]["library_ms"] = None if library is None else cuda_ms(library, reps=20)
            lib_txt = "" if library is None else f", library {record[name]['library_ms']:.4f} ms"
            print(f"{name}: kernel {record[name]['ms']:.4f} ms, plain "
                  f"{record[name]['plain_ms']:.4f} ms{lib_txt}")
        for name, s_in in (("B17", samples), ("B18", long_samples)):
            print_launches(name, lambda: fused_jac.jac_sweep(w, s_in),
                           {"replay": "flip_base_kernel", "reverse sweep": "bwd_sweep_kernel"})
        # cuDNN computes B19's history, not the gates the main path stores:
        # it stands beside B19 not storing, and B19's entry has no library call
        t19 = cuda_ms(lambda: fused_jac.rollout_hist(trunk_c, s11), reps=20)
        t_cudnn = cuda_ms(cudnn_gru, reps=20)
        print(f"B19 storing the gates {record['B19 rollout_hist']['ms']:.4f} ms; not storing "
              f"{t19:.4f} ms against torch.nn.GRU (cuDNN) {t_cudnn:.4f} ms in this call: "
              f"{'faster' if t19 < t_cudnn else 'slower'}, ratio {t_cudnn / t19:.2f}")
        print(f"B20 from the stored gates {record['B20 sweep_dgates']['ms']:.4f} ms; alone (B19 "
              f"storing first) "
              f"{cuda_ms(lambda: fused_jac.sweep_dgates(trunk_c, s11, hist_k, douts), reps=20):.4f}"
              f" ms")
        t_64, c_64 = spd_system(S_LONG)
        for label, (t, c) in (("TFIM (S, S)", (t_tfim, c_tfim)), ("J1-J2 (2S, 2S)", (t_j, c_j)),
                              (f"N={N_LONG} chain's S={S_LONG}", (t_64, c_64))):
            kernel_ms = cuda_ms(lambda: sr_cg.sr_cg_solve(t, c, 64), reps=20)
            print(f"B21 on the {label} Gram, {sr_cg.sr_cg_solve.last_path} path: "
                  f"{kernel_ms:.4f} ms")
            chol_ms = cuda_ms(lambda: torch.cholesky_solve(c[:, None], torch.linalg.cholesky(t)),
                              reps=20)
            print(f"B21 on the {label} Gram: Cholesky {chol_ms:.4f} ms")
        b_, n_, u_ = S_FLAG, N_FLAG, U_FLAG
        w4 = 4 * sum(t.numel() for t in trunk_c)
        jac_site = jac_sweep_site_flops(u_)
        s_t = t_tfim.shape[0]
        work_minsr = {
            "B17 jac_sweep": (b_ * n_ * jac_site, 4 * b_ * n_ + w6 + 4 * b_ * n_ * (5 * u_ + 1)),
            "B18 jac_sweep N=1000": (S_LONG * N_LONG * jac_site,
                                     4 * S_LONG * N_LONG + w6 + 4 * S_LONG * N_LONG * (5 * u_ + 1)),
            "B19 rollout_hist": (b_ * n_ * site_flops(u_, 0),
                                 4 * b_ * n_ + w4 + 4 * b_ * n_ * 5 * u_),
            "B20 sweep_dgates": (2 * b_ * n_ * jac_stored_site_flops(u_),
                                 4 * b_ * n_ + 4 * 3 * u_ * u_ + 4 * b_ * n_ * 5 * u_
                                 + 2 * 4 * b_ * n_ * 5 * u_),
            "B21 sr_cg_solve": (64 * (2 * s_t * s_t + 10 * s_t), 4 * s_t * s_t + 8 * s_t),
        }
        for name, (flops, nbytes) in work_minsr.items():
            record[name]["bound_ms"], record[name]["bound_by"] = bound(flops, nbytes)
            print(f"{name}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB: bound "
                  f"{record[name]['bound_ms']:.4f} ms ({record[name]['bound_by']}), "
                  f"kernel {record[name]['ms']:.4f} ms")
        print(f"coverage: B17 is in the K1-K4 family (U <= {gru_u} at N={N_FLAG}), B19 and B20 "
              f"in the cRNN family (U <= {crnn_u}); their shared memory does not depend on N")

    minsr_cfg = dict(num_samples=S_FLAG, learning_rate=MINSR_LR, optimizer="minsr")
    adam_only = ("K1 gru_log_prob", "K2 gru_log_prob_bwd", "B7 crnn_log_amp_parts",
                 "B9 crnn_log_amp_bwd", "B9 replay")
    tfim_kernels = ("K3 tfim_sample_and_flip_sum", "B17 jac_sweep", "B21 sr_cg_solve")
    j1j2_kernels = ("B11 j1j2_sample_and_exchange", "B19 rollout_hist", "B20 sweep_dgates",
                    "B21 sr_cg_solve")

    def require_launches(c, names, label):
        print(f"{label}: launches", {k: c[k] for k in names + adam_only})
        require(all(c[k] > 0 for k in names) and all(c[k] == 0 for k in adam_only),
                f"{label} ran its minSR kernels and no loss-gradient kernel")

    with Phase("20 minSR accuracy: TFIM N=20 against DMRG, J1-J2 N=8 against ED"):
        reset_counts()
        trainer = pkg.VMCTrainer(pkg.PRNN1D(20, (U_FLAG,), device=dev), pkg.TFIM1D(20, 1.0),
                                 pkg.TrainConfig(**minsr_cfg))
        state, done, rel_err = trainer.init(), 0, float("inf")
        while done < 600 and rel_err > 1e-3:
            state, ms = trainer.run_steps(state, 50)
            done += 50
            rel_err = abs(float(ms["mean_energy"].mean()) - E_DMRG_N20) / abs(E_DMRG_N20)
            print(f"TFIM N=20 minSR: {done} steps, block mean energy "
                  f"{float(ms['mean_energy'].mean()):.6f}, relative error {rel_err:.3e}")
        torch.cuda.synchronize()
        require(rel_err <= 1e-3, "TFIM N=20 minSR within 1e-3 of DMRG in 600 steps")
        require_launches(counts(), tfim_kernels, "TFIM N=20")
        reset_counts()
        n = 8
        e_exact = exact.ground_state_energy(exact.j1j2_dense(n, 1.0, J2_FLAG))
        trainer = pkg.VMCTrainer(pkg.CRNNU1(n, (12,), device=dev), pkg.J1J2(n, j2=J2_FLAG),
                                 pkg.TrainConfig(num_samples=256, learning_rate=MINSR_LR,
                                                 optimizer="minsr", seed=J1J2_PROBE_SEED))
        state, ms = trainer.run_steps(trainer.init(), 80)
        torch.cuda.synchronize()
        e_vmc = float(ms["mean_energy"][-10:].mean())
        rel_err = abs(e_vmc - e_exact) / abs(e_exact)
        print(f"J1-J2 N=8 minSR: E_vmc (mean of the last 10 of 80 steps) {e_vmc:.6f}, E_exact "
              f"{e_exact:.6f}, relative error {rel_err:.3e} (tol 3e-2)")
        require(rel_err <= 3e-2, "J1-J2 N=8 minSR within 3e-2 of ED")
        require_launches(counts(), j1j2_kernels, "J1-J2 N=8")

    with Phase("21 minSR flagships: TFIM and J1-J2 at N=100, S=500, and the N=1000, S=64 "
               "chain, lr 5e-2"):
        # label: (ansatz, Hamiltonian, S, steps, its kernels, the kernels whose
        # main path it is, reference)
        flagships = {
            "TFIM": (pkg.PRNN1D(N_FLAG, (U_FLAG,), device=dev), pkg.TFIM1D(N_FLAG, 1.0), S_FLAG,
                     50, tfim_kernels, ("B17 jac_sweep", "B21 sr_cg_solve"),
                     "DMRG ground state -126.9618766964"),
            "J1-J2": (pkg.CRNNU1(N_FLAG, (U_FLAG,), device=dev), pkg.J1J2(N_FLAG, j2=J2_FLAG),
                      S_FLAG, 50, j1j2_kernels, ("B19 rollout_hist", "B20 sweep_dgates"),
                      f"DMRG ground state {E_DMRG_J1J2}"),
            f"N={N_LONG}": (pkg.PRNN1D(N_LONG, (U_FLAG,), device=dev), pkg.TFIM1D(N_LONG, 1.0),
                            S_LONG, 10, ("K3 tfim_sample_and_flip_sum", "B18 jac_sweep N=1000",
                                         "B21 sr_cg_solve"), ("B18 jac_sweep N=1000",),
                            "TFIM chain, Bx=1"),
        }
        for label, (ansatz, ham, s_num, steps, names, own, ref) in flagships.items():
            trainer = pkg.VMCTrainer(ansatz, ham, pkg.TrainConfig(
                **{**minsr_cfg, "num_samples": s_num}))
            state = trainer.init()
            trainer.run_steps(state, 3)  # warm-up (allocator)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            state, ms = trainer.run_steps(state, steps)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c = counts()
            energies = ms["mean_energy"].cpu().numpy()
            print(f"minSR {label}: {smi}: {steps / dt:.2f} steps/s ({1000 * dt / steps:.3f} ms/step)")
            print(f"minSR {label}: energy: first {energies[0]:.4f}, last {energies[-1]:.4f} ({ref})")
            require(bool(np.isfinite(energies).all()), f"finite minSR {label} energies")
            require(energies[-3:].mean() < energies[:3].mean(), f"minSR {label} energies falling")
            require_launches(c, names, f"minSR {label}")
            launches.update({k: c[k] for k in own})

    with Phase("22 the 1D-TFIM CLI and compat.run_1DTFIM on the card (N=100, U=50, S=500)"):
        import contextlib
        import io
        import tempfile

        from rnnwavefunctions_tpu_torch import compat
        from rnnwavefunctions_tpu_torch.cli import run_1dtfim
        from rnnwavefunctions_tpu_torch.cli.run_loop import run_training
        from rnnwavefunctions_tpu_torch.utils.checkpoints import Checkpointer

        cli_kernels = ("K1 gru_log_prob", "K2 gru_log_prob_bwd", "K3 tfim_sample_and_flip_sum")
        argv = ["--systemsize", str(N_FLAG), "--num-units", str(U_FLAG), "--numsamples",
                str(S_FLAG), "--schedule", "staged", "--lr-stage-bounds", "50",
                "--lr-stage-scales", "0.5"]
        tag = f"N{N_FLAG}_samp{S_FLAG}_Jz1Bx1.0_GRURNN_OBC_TFIM_units_{U_FLAG}x1"
        with tempfile.TemporaryDirectory() as workdir:
            ckpt = Checkpointer(f"{workdir}/ckpt_{tag}", torch.nn.Module())
            runs = {}
            for label, extra, entries in (("fresh", ["--numsteps", "100"], 101),
                                          ("resumed", ["--numsteps", "200", "--resume"], 201)):
                reset_counts()
                mean_e, var_e = run_1dtfim.main(argv + extra + ["--workdir", workdir])
                torch.cuda.synchronize()
                c = counts()
                series = np.asarray(mean_e)
                updates = entries - (101 if label == "resumed" else 0)
                print(f"{label}: {len(series)} entries, energy first {series[0]:.4f}, last "
                      f"{series[-1]:.4f}; checkpoints at updates {ckpt.all_steps()}; launches",
                      {k: c[k] for k in cli_kernels + ("K4 tfim_flip_ratio_sum",
                                                         "B5 gru_sample")})
                require(len(series) == len(var_e) == entries
                        and bool(np.isfinite(series).all()) and bool(np.isfinite(var_e).all()),
                        f"the {label} CLI run's series: {entries} finite entries")
                # every update ran the fused step on the kernels: one K3, one
                # K1 storing K2's replay and one K2 each; the generic sampler
                # and estimator (B5, K4) did not run
                require(all(c[k] == updates for k in cli_kernels)
                        and c["K4 tfim_flip_ratio_sum"] == 0 and c["B5 gru_sample"] == 0,
                        f"the {label} CLI run launched K1, K2 and K3 once per update")
                runs[label] = series
            require(runs["resumed"][-10:].mean() < runs["resumed"][:10].mean(),
                    "the CLI run's energies fall")
            require(bool(np.array_equal(runs["resumed"][:101], runs["fresh"])),
                    "the resumed run keeps the first run's 101 entries")
            # the final saves: after loop index 100 (update 101) and 200
            require(ckpt.all_steps() == [101, 201], "checkpoints after loop steps 100 and 200")
            saved = torch.load(ckpt.path(201), weights_only=True)
            lr = saved["optimizer"]["param_groups"][0]["lr"]
            want = float(np.float32(5e-3) * np.float32(0.5))
            print(f"the Adam group's lr at the last update (step 200): {lr} (staged: 0.5 x 5e-3 "
                  f"from step 50 on, {want})")
            require(saved["optimizer_kind"] == "Adam" and lr == want,
                    "the staged schedule's rate after step 150")
            log = [json.loads(line) for line in open(f"{workdir}/metrics_{tag}.jsonl")]
            t = {r["step"]: r["wall_time_s"] for r in log}
            loop_rate = (200 - 110) / (t[200] - t[110])
            print(f"{smi}: the CLI loop {loop_rate:.2f} steps/s (JSONL wall clock, steps 110-200 "
                  f"of the resumed run: blocks of 10, one metrics copy, a JSONL record and an "
                  f".npy flush each), run_steps in phase 5 {tfim_steps_per_s:.2f} steps/s")

        # the loop's cost against run_steps on the same trainer, 101 updates
        # each (init included), in turns loop, steps, steps, loop
        def turn(loop: bool) -> float:
            trainer = pkg.VMCTrainer(pkg.PRNN1D(N_FLAG, (U_FLAG,), device=dev),
                                     pkg.TFIM1D(N_FLAG, 1.0), pkg.TrainConfig())
            with tempfile.TemporaryDirectory() as wd, contextlib.redirect_stdout(io.StringIO()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if loop:
                    run_training(trainer, 100, wd, "turn")
                else:
                    trainer.run_steps(trainer.init(), 101)
                torch.cuda.synchronize()
                return 101 / (time.perf_counter() - t0)

        rates = [(label, turn(label == "loop")) for label in ("loop", "steps", "steps", "loop")]
        print(f"{smi}: steps/s of 101 updates, turns loop, steps, steps, loop: the CLI loop "
              f"(run_training) {[round(r, 2) for k, r in rates if k == 'loop']}, run_steps "
              f"{[round(r, 2) for k, r in rates if k == 'steps']}")

        with tempfile.TemporaryDirectory() as workdir:
            reset_counts()
            mean_e, var_e = compat.run_1DTFIM(numsteps=20, systemsize=N_FLAG, workdir=workdir)
            torch.cuda.synchronize()
            c = counts()
            print(f"compat.run_1DTFIM(numsteps=20, systemsize={N_FLAG}): {mean_e.shape[0]} entries, "
                  f"last {mean_e[-1]:.4f}; launches", {k: c[k] for k in cli_kernels})
            require(mean_e.shape == var_e.shape == (21,) and bool(np.isfinite(mean_e).all())
                    and all(c[k] == 21 for k in cli_kernels),
                    "compat.run_1DTFIM's series on the kernels")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": record[name]["max_abs_err"], "ms": record[name]["ms"],
         "plain_ms": record[name]["plain_ms"], "bound_ms": record[name]["bound_ms"],
         "bound_by": record[name]["bound_by"], "tc_bound_ms": record[name].get("tc_bound_ms"),
         "library_ms": record[name].get("library_ms")}
        for name in wrappers
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
