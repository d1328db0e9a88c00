"""Function API matching the reference repository's 1D-TFIM entry point.

Counterpart of ``rnnwavefunctions_tpu/compat.py`` for ``run_1DTFIM``
(``1DTFIM/TrainingRNN_1DTFIM.py:79`` of the reference): the same keyword
names and defaults, delegating to the CLI (``cli/run_1dtfim.py``), so the
artifacts, the checkpoint cadence and the inclusive
``range(start, numsteps + 1)`` loop are the CLI's.

Deviations, documented as in the JAX package's module:

- Returns are ``np.ndarray`` (length ``numsteps + 1``, one entry per step
  including step 0), not Python lists.
- ``seed`` seeds the parameters and the per-step ``torch.Generator``:
  per-run distributions match the reference's, bit-for-bit trajectories
  cannot (neither the reference's nor the JAX package's).
- One keyword more, last: ``device`` (None: the CUDA card; "cpu" runs the
  plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import numpy as np

__all__ = ["run_1DTFIM"]


def run_1DTFIM(
    numsteps=10**4,
    systemsize=20,
    num_units=50,
    Bx=1,
    num_layers=1,
    numsamples=500,
    learningrate=5e-3,
    seed=111,
    workdir="Check_Points/1DTFIM",
    resume=False,
    device=None,
):
    """1D TFIM ground search with a positive GRU pRNN, constant learning
    rate.  Returns ``(RNNEnergy, varRNNEnergy)`` per-step series as numpy
    arrays."""
    from .cli.run_1dtfim import main

    argv = [
        "--numsteps", str(numsteps),
        "--systemsize", str(systemsize),
        "--bx", repr(float(Bx)),
        "--num-units", str(num_units),
        "--num-layers", str(num_layers),
        "--numsamples", str(numsamples),
        "--learningrate", repr(float(learningrate)),
        "--seed", str(seed),
        "--workdir", workdir,
    ]
    if resume:
        argv.append("--resume")
    if device is not None:
        argv += ["--device", str(device)]
    mean_e, var_e = main(argv)
    return np.asarray(mean_e), np.asarray(var_e)
