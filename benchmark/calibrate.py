"""The readings the correctness limits are set from, at a cell's own sizes:

    python3 -m benchmark.calibrate --workload <cell> --first-seed <n> [--seeds 12]
        [--control 3] [--faults 3] [--witness 0]

In one process: for each of ``--seeds`` seeds the program's set-up (its
first block, the first updates recorded) and the reference's check of it,
the program's readings; on the first ``--control`` of those seeds the
control (the reference in TF32 in the program's place) read against the
same reference; on the first ``--witness`` of them the round-off witness;
and on ``--faults`` further seeds each fault of ``faults.py`` planted in
the program.  One JSON line per reading, with each update's and each
leaf's gaps, on standard output.  The
benchmark's own runs never run this.

The round-off witness runs the reference alone from the initial weights
on the program's samples, each side with its own parameters and optimizer
state throughout: in float64, and against that the program's own updates,
the float32 reference's and the TF32 control's (``witness``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import check
from .faults import FAULTS
from .reference import FP32, TF32, Precision
from .run import set_up
from .spec import load_cell
from .system import FirstSteps


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def own_path(cell, record: FirstSteps, precision: Precision = FP32,
             dtype: torch.dtype = torch.float32, first_e_loc=None) -> FirstSteps:
    """The reference alone, in ``dtype``, from the initial weights on the
    program's samples: its own parameters and optimizer state throughout;
    its first direction taken from ``first_e_loc`` where given."""
    ref = check.reference_of(cell.config)
    params = {k: v.to(dtype) for k, v in record.params0.items()}
    optimizer = check.optimizer_of(ref, cell.traffic, params)
    out = FirstSteps(params, record.steps)
    for k, samples in enumerate(record.samples):
        lp, e_loc, direction, params = check.reference_update(
            ref, cell.traffic, optimizer, params, samples, precision,
            first_e_loc if k == 0 else None)
        out.samples.append(samples)
        out.log_prob.append(lp)
        out.e_loc.append(e_loc)
        out.energies.append(complex(e_loc.mean()))
        out.params.append(params)
        if out.first is None:
            out.first = direction
    return out


def witness(cell, record: FirstSteps):
    """[(kind, readings, per-update gaps, per-leaf gaps)]: the program, the
    float32 reference and the control, each on its own path, against the
    float64 reference; and the program against the float64 reference whose
    first direction is taken from the program's first local energies, which
    leaves the program's gradient or direction kernels alone in the first
    direction's gap, and that reference against the float64 one, the drift
    the program's first local energies alone cause."""
    f64 = own_path(cell, record, FP32, torch.float64)
    f64_on_program = own_path(cell, record, FP32, torch.float64, record.e_loc[0])
    sides = (("program", record, f64), ("reference_fp32", own_path(cell, record), f64),
             ("control", own_path(cell, record, TF32), f64),
             ("program_vs_f64_on_program_e_loc", record, f64_on_program),
             ("f64_on_program_e_loc", f64_on_program, f64))
    return [(f"witness:{kind}", check.readings(got, ref, []), check.by_step(got, ref),
             check.by_leaf(got, ref)) for kind, got, ref in sides]


def readings_of(cell, seed: int, device, plant=None, control: bool = False,
                with_witness: bool = False):
    """[(kind, readings, seconds the reference took, per-update gaps,
    per-leaf gaps)] of one seed, and the witness's lines where asked."""
    trainer, state, record = set_up(cell, seed, device, plant)
    del trainer, state
    _free(device)
    t0 = time.perf_counter()
    ref = check.follow(cell.config, cell.traffic, record)
    out = [("program", check.readings(record, ref, []), time.perf_counter() - t0,
            check.by_step(record, ref), check.by_leaf(record, ref))]
    if control:
        ctrl = check.control_record(cell.config, cell.traffic, record)
        out.append(("control", check.readings(ctrl, ref, []), None, check.by_step(ctrl, ref),
                    check.by_leaf(ctrl, ref)))
    lines = witness(cell, record) if with_witness else []
    return out, lines


def calibrate(cell, first_seed: int, seeds: int, control: int, faults: int, witnessed: int,
              device):
    for i in range(seeds):
        seed = first_seed + i
        out, lines = readings_of(cell, seed, device, control=i < control,
                                 with_witness=i < witnessed)
        for kind, values, seconds, steps, leaves in out:
            yield {"cell": cell.name, "kind": kind, "seed": seed, "readings": values,
                   "reference_s": seconds, "by_step": steps, "by_leaf": leaves}
        for kind, values, steps, leaves in lines:
            yield {"cell": cell.name, "kind": kind, "seed": seed, "readings": values,
                   "by_step": steps, "by_leaf": leaves}
    for j, (name, plant) in enumerate(FAULTS.items()):
        for i in range(faults):
            seed = first_seed + seeds + j * faults + i
            ((_, values, _, steps, leaves),), _ = readings_of(cell, seed, device, plant)
            yield {"cell": cell.name, "kind": f"fault:{name}", "seed": seed,
                   "readings": values, "by_step": steps, "by_leaf": leaves}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--witness", type=int, default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    for line in calibrate(cell, args.first_seed, args.seeds, args.control, args.faults,
                          args.witness, "cuda"):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
