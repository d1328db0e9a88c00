"""Drives the PyTorch port's main path on one CUDA card and checks it.

    python3 chip_smoke.py

Phases (each prints its time; any failure raises and exits non-zero):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the CUDA kernels from ``rnnwavefunctions_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card at the flagship
   shapes (N=100, U=50, B=500; parameters drawn from a seeded generator),
   every max error printed beside its tolerance; the K3 sampler's
   frequencies at N=3 against the exact density.
3. Each kernel and its plain version timed with CUDA events.
4. VMC training of the 1D TFIM at N=10 (300 steps, impl "auto") against
   exact diagonalization; all four kernels must have launched.
5. 50 steps of the flagship (N=100, one GRU layer of 50 units, S=500, Adam
   at lr 5e-3): steps/s and the first and last energies, which must be
   finite and falling.

The second-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
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
    "K1 gru_log_prob": ("rnnwavefunctions_tpu_torch/csrc/fused_gru.cu",
                        "rnnwavefunctions_tpu/ops/fused_gru.py:250"),
    "K2 gru_log_prob_bwd": ("rnnwavefunctions_tpu_torch/csrc/fused_gru_bwd.cu",
                            "rnnwavefunctions_tpu/ops/fused_gru_bwd.py:681"),
    "K3 tfim_sample_and_flip_sum": ("rnnwavefunctions_tpu_torch/csrc/tfim_flip.cu",
                                    "rnnwavefunctions_tpu/ops/tfim_flip_kernel.py:595"),
    "K4 tfim_flip_ratio_sum": ("rnnwavefunctions_tpu_torch/csrc/tfim_flip.cu",
                               "rnnwavefunctions_tpu/ops/tfim_flip_kernel.py:499"),
}


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


def perturbed_model(pkg, n, u, seed, device):
    """A model with Glorot weights plus seeded noise on every tensor, so the
    biases are not zero and the bias paths of the kernels are exercised."""
    gen = torch.Generator().manual_seed(seed)
    model = pkg.PRNN1D(n, (u,), impl="kernel", device=device).init(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen).to(device))
    return model


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import rnnwavefunctions_tpu_torch as pkg
    from rnnwavefunctions_tpu_torch.ed import exact
    from rnnwavefunctions_tpu_torch.ops import build, fused_gru, fused_gru_bwd
    from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk

    dev = torch.device("cuda", 0)
    wrappers = {
        "K1 gru_log_prob": fused_gru.gru_log_prob,
        "K2 gru_log_prob_bwd": fused_gru_bwd.gru_log_prob_bwd,
        "K3 tfim_sample_and_flip_sum": tk.tfim_sample_and_flip_sum,
        "K4 tfim_flip_ratio_sum": tk.tfim_flip_ratio_sum,
    }
    record = {k: {} for k in wrappers}

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
        require(all(v > 0 for v in c.values()), "every kernel launched in the N=10 run")
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
        require(all(v > 0 for v in c.values()), "every kernel launched in the flagship run")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": c[name],
         "max_abs_err": record[name]["max_abs_err"], "ms": record[name]["ms"],
         "plain_ms": record[name]["plain_ms"]}
        for name in wrappers
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
