"""CLI: VMC with a 1D pRNN on the 1D TFIM, on the CUDA card.

    python -m rnnwavefunctions_tpu_torch.cli.run_1dtfim [flags]

Counterpart of ``rnnwavefunctions_tpu/cli/run_1dtfim.py``: the same flags,
defaults (those of the reference runner: numsteps 10^3, N=20, Bx=1, 50
units x 1 layer, 500 samples, lr 5e-3, seed 111) and artifact names.  Not
here: ``--jax-cache-dir`` and ``--matmul-precision``, which set the JAX
compilation cache and the TPU's matmul passes.  Added: ``--device`` (the
card by default; ``cpu`` runs the plain PyTorch versions of the kernels).
Values the port does not run yet are refused with the ROADMAP item that
ports them: ``--cell lstm``, ``--dtype float64``, ``--tp`` > 1 and
``--num-devices`` other than 1.
"""

from __future__ import annotations

import argparse

from .. import PRNN1D, TFIM1D, TrainConfig, VMCTrainer
from .run_loop import add_schedule_flags, run_training, schedule_kwargs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--numsteps", type=int, default=10**3)
    p.add_argument("--systemsize", type=int, default=20)
    p.add_argument("--bx", type=float, default=1.0)
    p.add_argument("--num-units", type=int, default=50)
    p.add_argument("--num-layers", type=int, default=1,
                   help="stacked GRU layers; the kernels take one layer, so a "
                        "deeper stack runs only with --device cpu")
    p.add_argument("--cell", type=str, default="gru", choices=["gru", "lstm"],
                   help="recurrent cell ('lstm' is not ported yet: ROADMAP A5)")
    p.add_argument("--numsamples", type=int, default=500)
    p.add_argument("--learningrate", type=float, default=5e-3)
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--optimizer", type=str, default="adam", choices=["adam", "minsr"],
                   help="parameter update rule: the reference's Adam, or minSR "
                        "(stochastic reconfiguration solved in sample space, "
                        "vmc/minsr.py)")
    p.add_argument("--sr-damping", type=float, default=1e-2,
                   help="SR diagonal shift (only with --optimizer minsr)")
    p.add_argument("--sr-solver", type=str, default="cg", choices=["cg", "chol"],
                   help="SR sample-space solver: the CG kernel B21 (default) or a "
                        "Cholesky solve")
    p.add_argument("--sr-cg-iters", type=int, default=64,
                   help="CG iterations for --sr-solver cg")
    p.add_argument("--parity", action="store_true",
                   help="parity-symmetrized density (RNNwavefunction_paritysym)")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "float64"],
                   help="compute dtype: float32 with Kahan-compensated sums "
                        "('float64' is not ported yet: ROADMAP A6)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel devices (one card; more are ROADMAP A7)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width (1; more is ROADMAP A7)")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="max rows per log-amplitude evaluation batch")
    p.add_argument("--workdir", type=str, default="Check_Points/1DTFIM")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="trace one block of steps with torch.profiler into this "
                        "directory (Chrome trace)")
    p.add_argument("--device", type=str, default=None,
                   help="device of the parameters and kernels (default: the CUDA "
                        "card; 'cpu' runs the plain PyTorch versions)")
    add_schedule_flags(p)
    return p


def refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """Exits through ``parser.error`` (status 2) for a value the port does
    not run yet, naming the ROADMAP item that ports it."""
    if args.cell != "gru":
        parser.error(f"--cell {args.cell} is not ported yet (ROADMAP A5)")
    if args.dtype != "float32":
        parser.error(f"--dtype {args.dtype} is not ported yet (ROADMAP A6)")
    if args.tp != 1:
        parser.error(f"--tp {args.tp} is not ported yet: one card (ROADMAP A7)")
    if args.num_devices not in (None, 1):
        parser.error(f"--num-devices {args.num_devices} is not ported yet: one card "
                     "(ROADMAP A7)")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    ansatz = PRNN1D(args.systemsize, (args.num_units,) * args.num_layers,
                    parity=args.parity, device=args.device)
    ham = TFIM1D(args.systemsize, bx=args.bx)
    config = TrainConfig(
        num_samples=args.numsamples,
        learning_rate=args.learningrate,
        **schedule_kwargs(args),
        chunk_size=args.chunk_size,
        seed=args.seed,
        optimizer=args.optimizer,
        sr_damping=args.sr_damping,
        sr_solver=args.sr_solver,
        sr_cg_iters=args.sr_cg_iters,
    )
    trainer = VMCTrainer(ansatz, ham, config)
    sym = "_paritysym" if args.parity else ""
    # the reference's file names (TrainingRNN_1DTFIM.py:146), as the JAX CLI
    tag = (
        f"N{args.systemsize}_samp{args.numsamples}_Jz1Bx{args.bx}"
        f"_GRURNN_OBC_TFIM_units_{args.num_units}x{args.num_layers}{sym}"
    )
    _, mean_e, var_e = run_training(
        trainer, args.numsteps, args.workdir, tag,
        resume=args.resume, profile_dir=args.profile_dir,
    )
    return mean_e, var_e


if __name__ == "__main__":
    main()
