"""Runs one cell of the benchmark of ``rnnwavefunctions_tpu_torch`` once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for (it exits with 2, printing no result, without them).

Set-up: the configuration's trainer on the card, its weights drawn from
the seed on the card, and one ``fit`` block of ``log_every`` updates whose
first ``check_steps`` are recorded for the correctness check, then
``warmup_blocks`` more.  The window then calls ``VMCTrainer.fit`` one block
after another; each block ends in ``decode_metrics_block``'s single
device-to-host copy, and the window ends at the first block boundary after
``--seconds``.  ``--trace 1`` runs the same window under the profiler with
the benchmark's ranges around the trainer's layers (``trace.py``) and
reports the per-layer metrics in place of the end-to-end ones, read from
the window's events by those ranges and by the program's own spans
(``program_spans.py``).  A complex ansatz's mean energies are kept and
judged as complex numbers.

After the window: the peak device memory, a check that no JAX module was
loaded, then the reference's check of the recorded updates
(``check.py``).  The last lines on standard error are the numbers compared
with their limits; the last line on standard output is the result.
"""

from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (from /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import cmath  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rnnwavefunctions_tpu")


def forbidden_modules() -> List[str]:
    """The JAX modules loaded in this process, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    steps: int
    seconds: float
    block_s: List[float]
    energies: List[complex]  # fit's mean energies: complex for a complex ansatz


def run_window(trainer, state, seconds: float, log_every: int, sync: Callable) -> Window:
    """``fit`` blocks back to back until the first block boundary after
    ``seconds``; each block's time runs from the end of the previous
    block's copy to the end of its own."""
    blocks, energies = [], []
    sync()
    start = prev = time.perf_counter()
    while True:
        state, mean_energy, _ = trainer.fit(log_every, state, log_every=log_every)
        now = time.perf_counter()
        blocks.append(now - prev)
        energies.extend(mean_energy)
        prev = now
        if now - start >= seconds:
            return Window(log_every * len(blocks), now - start, blocks, energies)


def set_up(cell, seed: int, device, plant: Optional[Callable] = None, phases=None):
    """(trainer, state, record): the cell's trainer with the benchmark's
    weights, its first block run with ``check_steps`` updates recorded, and
    ``warmup_blocks`` more.  ``plant(trainer, state)`` breaks the program
    first (``faults.py``)."""
    from .system import Recorder, build

    traffic = cell.traffic
    mark = phases.mark if phases is not None else (lambda name: None)
    trainer, state, params0 = build(cell.config, traffic, seed, device, mark)
    if plant is not None:
        plant(trainer, state)
    recorder = Recorder(trainer, state, params0, traffic["check_steps"])
    log_every = traffic["log_every"]
    state, mean_energy, _ = trainer.fit(log_every, state, log_every=log_every)
    record = recorder.remove()
    record.energies = [complex(e) for e in mean_energy[:traffic["check_steps"]]]
    mark("first block")
    return trainer, state, record


class Phases:
    """Wall-clock marks of the set-up's parts."""

    def __init__(self, start: float):
        self.last = start
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``' exclusive method); a
    window of one block is its own tail."""
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]


def _finite(x: float):
    return x if math.isfinite(x) else None


def traced_summary(cell, events) -> Dict:
    """What the per-layer metrics read of a traced window's events:
    ``trace.summarize``'s numbers, the step's least time (``least_s``) and
    the program's own spans (``program``, ``program_spans.summarize``)."""
    from . import program_spans, roofline
    from . import trace as tracing

    summary = tracing.summarize(events)
    summary["least_s"] = roofline.least_s(roofline.step_work(cell.config, cell.traffic))
    summary["program"] = program_spans.summarize(events)
    return summary


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             plant: Optional[Callable] = None, t_start: Optional[float] = None,
             phases: Optional[Phases] = None) -> Dict:
    """One run of ``cell``; returns the result's fields, the verdict and the
    set-up's parts.  Without a card (``device="cpu"``) it runs the plain
    path and reads no device number."""
    import torch

    from . import check
    from . import trace as tracing
    from .spec import metric_reader

    t_start = time.perf_counter() if t_start is None else t_start
    phases = phases or Phases(t_start)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    trainer, state, record = set_up(cell, seed, device, plant, phases)
    if trace:
        tracing.add_ranges(trainer, state)
    log_every = cell.traffic["log_every"]
    for _ in range(cell.traffic["warmup_blocks"]):
        state = trainer.fit(log_every, state, log_every=log_every)[0]
    sync()
    phases.mark("warm-up")
    setup_s = time.perf_counter() - t_start

    with tracing.traced(trace) as prof:
        with tracing.window_range():
            window = run_window(trainer, state, seconds, log_every, sync)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"JAX modules loaded by the run: {loaded}")

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak}
    breakdown = None
    if trace:
        events = tracing.events_of(prof)
        del prof
        summary = traced_summary(cell, events)
        del events
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = summary["breakdown"]
    else:
        values = {
            "steps_per_s": window.steps / window.seconds,
            "block_ms_p95": 1e3 * p95(window.block_s),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    del trainer, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = check.decide(cell.config, cell.traffic, record, window.energies, cell.limits)
    result = {
        "correct": verdict.correct,
        "attempted": window.steps,
        "failed": sum(1 for e in window.energies if not cmath.isfinite(e)),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in verdict.as_json().items()}
    return {"result": result, "verdict": verdict, "setup": phases.seconds,
            "blocks": len(window.block_s)}


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    phases = Phases(T_START)
    root = Path(__file__).resolve().parent.parent
    import torch

    import rnnwavefunctions_tpu_torch

    from .spec import load_cell

    if Path(rnnwavefunctions_tpu_torch.__file__).resolve().parent.parent != root:
        print(f"the program is not this checkout's: {rnnwavefunctions_tpu_torch.__file__}",
              file=sys.stderr)
        return 2
    phases.mark("imports")
    cell = load_cell(args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell.chips} CUDA card(s); this machine has {count}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.empty(1, device="cuda")
    phases.mark("context")
    from rnnwavefunctions_tpu_torch.ops.build import load_library

    load_library()
    phases.mark("library")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start=T_START, phases=phases)
    loaded = forbidden_modules()
    if loaded:
        print(f"JAX modules loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}")
    print(f"blocks in the window: {out['blocks']}")
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in out["setup"].items()),
          file=sys.stderr)
    for line in out["verdict"].lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
