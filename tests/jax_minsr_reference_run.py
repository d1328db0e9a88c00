"""The JAX package's minSR run on the CPU from the PyTorch port's initial
weights: the reference trajectory that ``profile_step accuracy --model j1j2
--optimizer minsr --seed S`` is read against.

The port's ``CRNNU1(N, (50,))`` is initialised as ``VMCTrainer.init`` does
for ``seed`` and its weights go into the JAX package's ``CRNNU1``; the JAX
trainer then takes ``--steps`` minSR steps (lr 5e-2, ``sr_damping=1e-2``,
64 CG steps, float32 at full precision on the CPU) with samples drawn from
``jax.random.PRNGKey(seed)``.  Prints one JSON line per block and a summary
with the same keys as ``profile_step accuracy``.  Not a test (pytest
collects ``test_*.py`` only): an N=100 step takes seconds on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_minsr_reference_run.py --seed 0 --marshall-sign
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np
import torch

from rnnwavefunctions_tpu import CRNNU1 as JCRNNU1
from rnnwavefunctions_tpu import J1J2 as JJ1J2
from rnnwavefunctions_tpu import TrainConfig as JTrainConfig
from rnnwavefunctions_tpu import VMCTrainer as JVMCTrainer
from rnnwavefunctions_tpu.parallel.mesh import make_mesh
from rnnwavefunctions_tpu_torch import CRNNU1, interop
from rnnwavefunctions_tpu_torch.ed import exact

E_DMRG_J1J2_N100 = -40.73881897  # J2=0.2, open chain (the JAX package's BASELINE.md)


def port_initial_weights(n: int, units: int, seed: int):
    """The port's initial CRNNU1 weights for ``seed`` as a JAX tree."""
    model = CRNNU1(n, (units,), device="cpu")
    model.init(torch.Generator().manual_seed(seed))
    return jax.tree.map(jax.numpy.asarray, interop.params_to_numpy(model))


def jax_trainer(n: int, units: int, samples: int, seed: int, marshall_sign: bool):
    return JVMCTrainer(
        JCRNNU1(num_sites=n, units=(units,)),
        JJ1J2(num_sites=n, j2=0.2, marshall_sign=marshall_sign),
        JTrainConfig(num_samples=samples, learning_rate=5e-2, optimizer="minsr", seed=seed),
        mesh=make_mesh(1))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=100)
    parser.add_argument("--units", type=int, default=50)
    parser.add_argument("--samples", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--block", type=int, default=100)
    parser.add_argument("--marshall-sign", action="store_true")
    args = parser.parse_args()
    if args.n == 100:
        e_ref = E_DMRG_J1J2_N100
    else:
        e_ref = exact.ground_state_energy(exact.j1j2_dense(args.n, 1.0, 0.2))
    trainer = jax_trainer(args.n, args.units, args.samples, args.seed, args.marshall_sign)
    state = trainer.init()._replace(params=port_initial_weights(args.n, args.units, args.seed))
    key = jax.random.PRNGKey(args.seed)
    energies, t0 = [], time.perf_counter()
    for done in range(0, args.steps, args.block):
        state, ms = trainer.run_steps(state, key, args.block)
        energies.append(np.asarray(ms["mean_energy"]))
        print(json.dumps({"steps": done + args.block, "block_energy": float(energies[-1].mean()),
                          "seconds": time.perf_counter() - t0}), flush=True)
    flat = np.concatenate(energies)
    nonfinite = np.flatnonzero(~np.isfinite(flat))
    energy = float(flat[-100:].mean())
    print(json.dumps({
        "model": "j1j2", "package": "rnnwavefunctions_tpu (JAX, CPU)", "n": args.n,
        "marshall_sign": args.marshall_sign, "samples": args.samples, "seed": args.seed,
        "steps": args.steps, "energy": energy, "e_ref": e_ref,
        "relative_error": abs(energy - e_ref) / abs(e_ref),
        "block_energies": [float(e.mean()) for e in energies],
        "first_nonfinite_step": int(nonfinite[0]) if nonfinite.size else None,
    }))


if __name__ == "__main__":
    main()
