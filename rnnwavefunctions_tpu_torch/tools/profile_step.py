"""Measures a flagship VMC step on one CUDA card:

* ``--model tfim`` (default): 1D TFIM N=100, Bx=1, open boundaries; ``PRNN1D``
  with one GRU layer of 50 units; S=500; Adam at lr 5e-3;
* ``--model j1j2``: ``J1J2(N=100, J2=0.2)``, open chain (``--marshall-sign``
  applies the Marshall rotation, which leaves the spectrum as it is);
  ``CRNNU1`` with one GRU layer of 50 units; S=500; Adam at lr 5e-3;
* ``--model mdrnn``: ``MDRNN2D(16, 16, units=50)`` on
  ``TFIM2D(16, 16, Bx=3, encoding="grid")``; S=500; Adam at lr 5e-3
  (``profile``); ``accuracy`` trains the same model on the 4x4, Bx=3
  lattice;
* ``--model parity``: the tfim chain with ``PRNN1D(parity=True)``, the
  parity-symmetrized density (bench.py's ``parity_n100`` row);
* ``--model snake``: ``PRNNSnake2D(10, 10, (50,))`` on
  ``TFIM2D(10, 10, Bx=3, encoding="flat")``; S=500; Adam at lr 5e-3
  (``profile``, bench.py's ``snake2d_10x10`` row); ``accuracy`` trains the
  same model on the 4x4, Bx=3 lattice;
* ``--model chain1000``: the tfim model on the N=1000 chain with S=64
  (bench.py's ``1dtfim_n1000_minsr`` row; ``profile`` only).

``--optimizer minsr`` trains with minSR at lr 5e-2 (bench.py's ``*_minsr``
rows: ``sr_damping=1e-2``, the CG solve of 64 steps) in place of Adam;
``--sr-solver chol`` solves its system by Cholesky (``TrainConfig.sr_solver``)
in place of the CG kernel.

    python -m rnnwavefunctions_tpu_torch.tools.profile_step profile [--model M] [--optimizer O] [--out FILE]
    python -m rnnwavefunctions_tpu_torch.tools.profile_step accuracy [--model M] [--steps 8000]
        [--optimizer minsr] [--sr-solver cg|chol]
    python -m rnnwavefunctions_tpu_torch.tools.profile_step system --model j1j2 --at 150,250

``profile``: steps/s of the plain path (``impl="plain"``; host clock,
ending in a synchronize) over two repeats of 5 steps (1 for
``chain1000``, whose plain step takes seconds); then ``torch.profiler``
over 20 kernel-path steps, after 3 warm-up steps: device time per step of
each kernel, and the host's self CPU time per step, in all and for the ten
largest ops (a step whose host time exceeds its device time leaves the
card idle).  The kernel path's steps/s and the card's idle share are the
benchmark's (``benchmark/``).

``accuracy``: ``--steps`` steps from ``--seed`` (``TrainConfig()``'s by
default) with ``--samples`` samples per step (500), the metrics read back
every ``--block`` steps; the energy is the mean of the
last 100 steps' mean energies (± their standard error), reported beside
the reference energy: the DMRG ground-state energy of the chain, or for
``mdrnn`` and ``snake`` the Lanczos energy of the 4x4 lattice (reported,
not gated).  Also reported: each block's mean energy, the first step
whose mean energy is not finite (None when every step's is), and, where a
Cholesky solve (``--sr-solver chol``) found its Gram not positive definite,
the block of steps where it did (training stops there).  For J1-J2
minSR, ``tests/jax_minsr_reference_run.py`` runs the JAX package's trainer
on the CPU from the same seed's initial weights.

``system``: minSR training from ``--seed`` with ``--samples`` samples; at
each step of ``--at`` it reads the sample-space system the next step
solves (on a draw that leaves the training run's random stream as it
was): the extreme eigenvalues of the damped Gram, and the CG kernel's
relative residual and its distance from a float64 solve of the same
system.

Each mode prints the card's name and power limit first and a JSON summary
last, and writes that summary to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import (
    CRNNU1, J1J2, MDRNN2D, PRNN1D, PRNNSnake2D, TFIM1D, TFIM2D, TrainConfig, VMCTrainer,
)
from ..ed.exact import E_TFIM2D_4X4_BX3

N, U = 100, 50
BX_2D = 3.0
# the profiled lattices: bench.py's mdrnn_16x16 and snake2d_10x10 rows
LATTICE = {"mdrnn": (16, 16), "snake": (10, 10)}
# optimizer -> learning rate: the reference's Adam rate, bench.py's minSR rate
LEARNING_RATE = {"adam": 5e-3, "minsr": 5e-2}
PLAIN_STEPS = {"chain1000": 1}  # steps per timed plain repeat; 5 for the others
# Reference ground-state energies: DMRG for the chains (the JAX package's
# README and BASELINE.md; parity symmetrizes the same TFIM chain), Lanczos
# for the 4x4, Bx=3 lattice of ``accuracy``
E_REF = {"tfim": -126.9618766964, "parity": -126.9618766964, "j1j2": -40.73881897,
         "mdrnn": E_TFIM2D_4X4_BX3, "snake": E_TFIM2D_4X4_BX3}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _trainer(model: str, impl: str = "auto", marshall_sign: bool = False, lattice=None,
             optimizer: str = "adam", samples: int = 500, seed: int = TrainConfig.seed,
             sr_solver: str = TrainConfig.sr_solver):
    """The model's trainer at the flagship size; ``lattice`` overrides the
    2D models' lattice."""
    lattice = lattice or LATTICE.get(model)
    if model in ("tfim", "parity"):
        ansatz = PRNN1D(N, (U,), parity=model == "parity", impl=impl, device="cuda")
        ham = TFIM1D(N, 1.0)
    elif model == "chain1000":
        ansatz, ham, samples = PRNN1D(1000, (U,), impl=impl, device="cuda"), TFIM1D(1000, 1.0), 64
    elif model == "mdrnn":
        ansatz = MDRNN2D(*lattice, units=U, impl=impl, device="cuda")
        ham = TFIM2D(*lattice, bx=BX_2D, encoding="grid")
    elif model == "snake":
        ansatz = PRNNSnake2D(*lattice, (U,), impl=impl, device="cuda")
        ham = TFIM2D(*lattice, bx=BX_2D, encoding="flat")
    else:
        ansatz = CRNNU1(N, (U,), impl=impl, device="cuda")
        ham = J1J2(N, j2=0.2, marshall_sign=marshall_sign)
    trainer = VMCTrainer(ansatz, ham, TrainConfig(
        num_samples=samples, learning_rate=LEARNING_RATE[optimizer], optimizer=optimizer,
        seed=seed, sr_solver=sr_solver))
    return trainer, trainer.init()


def profile(model: str, marshall_sign: bool, optimizer: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    trainer, state = _trainer(model, marshall_sign=marshall_sign, optimizer=optimizer)
    trainer.run_steps(state, 3)  # warm-up: build, allocator
    plain, plain_state = _trainer(model, "plain", marshall_sign, optimizer=optimizer)
    plain.run_steps(plain_state, 1)
    plain_steps, plain_rates = PLAIN_STEPS.get(model, 5), []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.run_steps(plain_state, plain_steps)
        torch.cuda.synchronize()
        plain_rates.append(plain_steps / (time.perf_counter() - t0))

    steps = 20
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        trainer.run_steps(state, steps)
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    # the profiler mirrors host ranges (the rnnwf.* spans) onto the device: not work
    ranges = {e.key for e in host}
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
    per_step = {e.key: e.self_device_time_total / 1e3 / steps for e in device}
    return {
        "model": model,
        "optimizer": optimizer,
        "marshall_sign": marshall_sign,
        "plain_steps_per_s": plain_rates,
        "profiled_steps": steps,
        "device_ms_per_step": dict(sorted(per_step.items(), key=lambda kv: -kv[1])),
        "host_self_cpu_ms_per_step": sum(e.self_cpu_time_total for e in host) / 1e3 / steps,
        "host_top_ms_per_step": {e.key: e.self_cpu_time_total / 1e3 / steps for e in host[:10]},
    }


def accuracy(model: str, marshall_sign: bool, steps: int, block: int, optimizer: str,
             samples: int, seed: int, sr_solver: str = TrainConfig.sr_solver) -> dict:
    lattice = (4, 4) if model in LATTICE else None
    trainer, state = _trainer(model, marshall_sign=marshall_sign, lattice=lattice,
                              optimizer=optimizer, samples=samples, seed=seed,
                              sr_solver=sr_solver)
    energies, imag, failed = [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for done in range(0, steps, block):
        try:
            state, ms = trainer.run_steps(state, min(block, steps - done))
        except torch.linalg.LinAlgError as exc:  # a Cholesky solve of a Gram not positive definite
            failed = {"steps": [done + 1, min(done + block, steps)], "error": str(exc)}
            break
        energies.append(ms["mean_energy"].cpu().numpy())
        if "mean_energy_im" in ms:
            imag.append(ms["mean_energy_im"].cpu().numpy())
    seconds = time.perf_counter() - t0
    trained = np.concatenate(energies) if energies else np.zeros(0, np.float32)
    steps = trained.size
    nonfinite = np.flatnonzero(~np.isfinite(trained))
    last = trained[-100:]
    energy = float(last.mean()) if last.size else float("nan")
    e_ref = E_REF[model]
    return {
        "model": model,
        "optimizer": optimizer,
        "marshall_sign": marshall_sign,
        "samples": samples,
        "seed": seed,
        "sr_solver": sr_solver if optimizer == "minsr" else None,
        "steps": steps,
        "seconds": seconds,
        "steps_per_s": steps / seconds,
        "energy": energy,
        "energy_stderr": float(last.std(ddof=1) / np.sqrt(last.size)) if last.size > 1 else None,
        "energy_im": float(np.concatenate(imag)[-100:].mean()) if imag else None,
        "e_ref": e_ref,
        "relative_error": abs(energy - e_ref) / abs(e_ref),
        "block_energies": [float(e.mean()) for e in energies],
        "first_nonfinite_step": int(nonfinite[0]) if nonfinite.size else None,
        "solve_failed": failed,
    }


def system(model: str, marshall_sign: bool, at, samples: int, seed: int) -> dict:
    from ..ops import sr_cg
    from ..vmc import minsr

    trainer, state = _trainer(model, marshall_sign=marshall_sign, optimizer="minsr",
                              samples=samples, seed=seed)
    cfg, done, reads = trainer.config, 0, []
    for step in at:
        state, ms = trainer.run_steps(state, step - done)
        done = step
        stream = state.generator.get_state()
        draw, e_re, e_im = trainer._sample_and_energy(state)
        state.generator.set_state(stream)
        rows_re, rows_im = minsr.per_sample_log_amp_grad_trees(trainer.ansatz, draw)
        t, c, _ = minsr.sample_space_system(
            rows_re, rows_im, e_re, e_im, e_re.mean(), None if e_im is None else e_im.mean(),
            cfg.sr_damping)
        read = {"step": step, "mean_energy": float(ms["mean_energy"][-1])}
        if bool(torch.isfinite(t).all() and torch.isfinite(c).all()):
            x = sr_cg.sr_cg_solve(t, c, cfg.sr_cg_iters).double()
            t64, c64 = t.double(), c.double()
            eig, vec = torch.linalg.eigh(t64)  # solves where LU calls the system singular
            x64 = vec @ ((vec.T @ c64) / eig)
            read.update({
                "gram_eig_min": float(eig[0]), "gram_eig_max": float(eig[-1]),
                "cg_relative_residual": float((t64 @ x - c64).norm() / c64.norm()),
                "cg_vs_float64_solve": float((x - x64).norm() / x64.norm()),
            })
        reads.append(read)
    return {"model": model, "optimizer": "minsr", "marshall_sign": marshall_sign,
            "samples": samples, "seed": seed, "sr_cg_iters": cfg.sr_cg_iters, "reads": reads}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("profile", "accuracy", "system"))
    parser.add_argument("--model", default="tfim",
                        choices=("tfim", "parity", "j1j2", "mdrnn", "snake", "chain1000"))
    parser.add_argument("--optimizer", choices=tuple(LEARNING_RATE), default="adam")
    parser.add_argument("--sr-solver", choices=("cg", "chol"), default=TrainConfig.sr_solver,
                        help="accuracy with --optimizer minsr: the sample-space solve")
    parser.add_argument("--marshall-sign", action="store_true",
                        help="j1j2: train the Marshall-rotated Hamiltonian")
    parser.add_argument("--steps", type=int, default=8000, help="accuracy: training steps")
    parser.add_argument("--samples", type=int, default=500,
                        help="accuracy, system: samples per step")
    parser.add_argument("--seed", type=int, default=TrainConfig.seed, help="accuracy, system: seed")
    parser.add_argument("--at", default="100,200",
                        help="system: steps at which to read the system (ascending)")
    parser.add_argument("--block", type=int, default=500,
                        help="accuracy: steps between metric reads")
    parser.add_argument("--out", type=Path, help="also write the summary here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    print(_card(), flush=True)
    if args.mode == "profile":
        result = profile(args.model, args.marshall_sign, args.optimizer)
    elif args.mode == "system":
        result = system(args.model, args.marshall_sign, [int(k) for k in args.at.split(",")],
                        args.samples, args.seed)
    else:
        if args.model == "chain1000":
            parser.error("accuracy has no reference energy for the N=1000 chain")
        result = accuracy(args.model, args.marshall_sign, args.steps, args.block,
                          args.optimizer, args.samples, args.seed, args.sr_solver)
    result["card"] = _card()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
