"""The training loop shared by the CLI entry points.

Counterpart of ``rnnwavefunctions_tpu/cli/run_loop.py``.  It keeps the
reference's loop: sample, local energies and an update per step, record
the mean and variance of the energy, print every ``log_every`` steps,
write the ``.npy`` series every ``save_every`` steps and a checkpoint
every ``ckpt_every`` steps, resume from the checkpoint; the loop range is
``range(start, numsteps + 1)``, inclusive, as in the reference.

The steps of a block up to the next ``log_every`` multiple run back to back
through ``VMCTrainer.run_steps``, their metrics on the card, and the block's
metrics come to the host in one copy (``decode_metrics_block``): one
synchronisation per block, not per step.  The multi-host branches and the
JAX compilation cache of the JAX loop have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import shutil
from typing import Optional

import torch

from ..utils.checkpoints import Checkpointer
from ..utils.metrics import MetricsSeries
from ..utils.summary import summarize_params
from ..utils.trace import span
from ..vmc.trainer import VMCTrainer, decode_metrics_block


def add_schedule_flags(parser, default: str = "constant") -> None:
    """Learning-rate schedule flags shared by the runners; ``default``
    follows each runner's reference trainer."""
    parser.add_argument(
        "--schedule", type=str, default=default,
        choices=["constant", "inverse", "harmonic", "exponential", "staged"],
        help=f"learning-rate schedule (default: {default}, the reference "
             "trainer's choice; 'staged' multiplies the lr by "
             "--lr-stage-scales[i] once step >= --lr-stage-bounds[i])",
    )
    parser.add_argument("--lr-stage-bounds", type=int, nargs="*", default=[],
                        help="staged-schedule step bounds (ascending)")
    parser.add_argument("--lr-stage-scales", type=float, nargs="*", default=[],
                        help="staged-schedule lr multipliers (compounding)")


def schedule_kwargs(args) -> dict:
    """TrainConfig kwargs from ``add_schedule_flags``'s namespace."""
    return {
        "schedule": args.schedule,
        "lr_stage_bounds": tuple(args.lr_stage_bounds),
        "lr_stage_scales": tuple(args.lr_stage_scales),
    }


def _profiler(profile_dir: str, device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def run_training(
    trainer: VMCTrainer,
    num_steps: int,
    workdir: str,
    tag: str,
    resume: bool = False,
    log_every: int = 10,
    save_every: int = 10,
    ckpt_every: int = 500,
    profile_dir: Optional[str] = None,
):
    """Returns (final_state, mean_energy list, var_energy list).  With
    ``profile_dir``, the second block runs under ``torch.profiler``, its
    metrics copy and its JSONL, ``.npy`` and checkpoint writes included
    (spans ``rnnwf.readback``, ``rnnwf.cli.log``, ``rnnwf.cli.npy``,
    ``rnnwf.cli.checkpoint``), and its trace is written there as
    ``trace_<tag>.json`` (Chrome format)."""
    metrics = MetricsSeries(workdir, tag, resume=resume)
    ckpt_dir = os.path.join(workdir, f"ckpt_{tag}")
    if not resume and os.path.isdir(ckpt_dir):
        # a fresh run over an old checkpoint directory would leave a later
        # step there than it saves: clear it, as the metrics artifacts are
        # written anew
        shutil.rmtree(ckpt_dir)
    ckpt = Checkpointer(ckpt_dir, trainer.ansatz)

    state = trainer.init()
    if resume and ckpt.latest_step() is not None:
        try:
            state = ckpt.restore(state)
        except ValueError:
            # another optimizer than the checkpoint's (e.g. an Adam run
            # resumed with --optimizer minsr): keep params + step, start a
            # fresh optimizer; the schedule reads the restored step
            state = ckpt.restore_params_and_step(state)
            print(
                "checkpoint optimizer state layout differs from the "
                "configured optimizer; restored params + step, "
                "re-initialized the optimizer state (moments zeroed, "
                "schedule count fast-forwarded to the restored step)"
            )

    start = state.step
    if resume:
        # the checkpoint's step is the source of truth; the .npy series
        # flushes more often than checkpoints save, so after an interrupted
        # run it can be ahead
        metrics.truncate(start)

    # parameter printout, as the reference does at startup
    print(summarize_params(trainer.ansatz))

    device = next(trainer.ansatz.parameters()).device
    it = start
    while it <= num_steps:
        # a block ends at the next log_every multiple (so its last metrics
        # entry is the logging step) and never runs past a checkpoint step
        # (the saved state is the ckpt_every-step state)
        stop = ((it + log_every - 1) // log_every) * log_every
        if ckpt_every:
            stop = min(stop, ((it + ckpt_every - 1) // ckpt_every) * ckpt_every)
        block = min(stop, num_steps) - it + 1
        last = it + block - 1

        # one traced block, its copy and writes included
        traced = profile_dir is not None and it > start
        with _profiler(profile_dir, device) if traced else contextlib.nullcontext() as prof:
            state, ms = trainer.run_steps(state, block)
            for m, v in decode_metrics_block(ms):
                metrics.append(m, v)
            if last % log_every == 0:
                with span("rnnwf.cli.log"):
                    metrics.print_line(last, trainer.config.num_samples)
                    metrics.log_jsonl(last)
            if any((it + j) % save_every == 0 for j in range(block)):
                with span("rnnwf.cli.npy"):
                    metrics.flush_npy()
            if ckpt_every and last % ckpt_every == 0 and last > start:
                with span("rnnwf.cli.checkpoint"):
                    ckpt.save(state)
        if traced:
            prof.export_chrome_trace(os.path.join(profile_dir, f"trace_{tag}.json"))
            profile_dir = None
        it += block

    ckpt.save(state)
    metrics.flush_npy()
    return state, metrics.mean_energy, metrics.var_energy
