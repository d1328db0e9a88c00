"""The program's own spans in a traced window.

``rnnwavefunctions_tpu_torch`` opens profiler ranges named ``rnnwf.*``
around its phases (``utils/trace.py``).  ``summarize`` reduces the window's
events (``trace.events_of``) to, for each span name:

* ``count``: its instances that begin in the window;
* ``device_s``: the device seconds, inside the window, of the operations
  whose CUDA launch began inside one of its instances, on any thread (the
  autograd engine launches the backward from its own thread while the
  main thread waits inside ``rnnwf.gradient``).  The launch is found as
  ``trace.summarize`` finds it; an instance anywhere up the stack counts,
  so a span's seconds include its children's;
* ``launches``: the CUDA launch calls (``cudaLaunch*``, ``cuLaunch*``,
  ``cudaGraphLaunch``, so that a graph counts once) that began inside one
  of its instances;

and to the block boundaries: for each ``rnnwf.readback`` (a block's one
copy) that some device operation was launched after, the time the device
stood idle from the readback's start to the start of the first such
operation (``boundaries``, ``boundary_idle_s``).  A program without the
spans gives no names and no boundaries.

``readings`` turns that into five per-layer numbers: ``minsr_rows_ms_per_step``,
``minsr_solve_ms_per_step``, ``optimizer_ms_per_step``, ``launches_per_step``
and ``boundary_idle_ms_per_block``.  ``benchmark.run --trace 1`` puts
``summarize``'s output in the summary as ``program``, and each of the five
has its reader, ``metrics/<name>.py``.  Run alone on a machine with a card,

    python3 -m benchmark.program_spans --workload <cell> --seed <n> --seconds <s>

it profiles the cell's window as ``benchmark.run --trace 1`` does and prints
one JSON line: the readings, and beside them the per-layer metrics the cell
reports, from the same window.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import itertools
import json
import sys
from typing import Dict, List, Tuple

from .trace import WINDOW, Event

PREFIX = "rnnwf."
READBACK = PREFIX + "readback"
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")


class _Union:
    """A union of intervals: membership of a time, and the length covered
    inside [a, b]."""

    def __init__(self, intervals: List[Tuple[int, int]]):
        merged: List[List[int]] = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.before = [0] + list(itertools.accumulate(b - a for a, b in merged))

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ends[i]

    def covered(self, a: float, b: float) -> float:
        """Length of the union inside [a, b]."""

        def upto(t):
            i = bisect.bisect_right(self.starts, t)
            full = self.before[i]
            return full - max(0, self.ends[i - 1] - t) if i else 0

        return max(0.0, upto(b) - upto(a))


def summarize(events: List[Event]) -> Dict:
    ops = [e for e in events if e.kind == "op"]
    window = max((e for e in ops if e.name == WINDOW), key=lambda e: e.end - e.start)
    w0, w1 = window.start, window.end
    spans = collections.defaultdict(list)
    for e in ops:
        if e.name.startswith(PREFIX) and w0 <= e.start < w1:
            spans[e.name].append((e.start, e.end))
    held = {name: _Union(iv) for name, iv in spans.items()}

    # launched by the CUDA call of its correlation id, else under the op it
    # is linked to, else (neither recorded) when it began: trace.summarize's rule
    op_start = {e.corr: e.start for e in ops if e.corr > 0}
    calls = {e.corr: e for e in events if e.kind == "runtime"}
    host_names = {e.name for e in ops}  # host ranges mirrored on the device: not work
    device = []  # (launched, start, end), clipped to the window
    for e in events:
        if e.kind != "device" or e.name in host_names:
            continue
        a, b = max(e.start, w0), min(e.end, w1)
        if b <= a:
            continue
        call = calls.get(e.corr)
        if call is not None and call.start <= e.start:
            launched = call.start
        else:
            launched = op_start.get(e.linked, e.start) if e.linked > 0 else e.start
        device.append((launched, a, b))
    launch_calls = [e.start for e in events
                    if e.kind == "runtime" and e.name.startswith(LAUNCHES)]

    out = {}
    for name, union in held.items():
        out[name] = {
            "count": len(spans[name]),
            "device_s": sum(b - a for t, a, b in device if union.holds(t)) / 1e9,
            "launches": sum(1 for t in launch_calls if union.holds(t)),
        }

    # boundary idle: from each readback's start to the first operation
    # launched after it ends, less the device's busy time in between
    busy = _Union([(a, b) for _, a, b in device])
    device.sort()
    launched = [t for t, _, _ in device]
    first_start = list(itertools.accumulate(reversed([a for _, a, _ in device]), min))[::-1]
    boundaries, idle_ns = 0, 0.0
    for start, end in spans.get(READBACK, []):
        i = bisect.bisect_left(launched, end)
        if i == len(device):
            continue
        nxt = first_start[i]
        boundaries += 1
        if nxt > start:
            idle_ns += (nxt - start) - busy.covered(start, nxt)
    return {"spans": out, "boundaries": boundaries, "boundary_idle_s": idle_ns / 1e9}


def readings(program: Dict) -> Dict[str, float]:
    """The per-layer numbers of ``summarize``'s output; a number whose spans
    the trace does not hold is left out."""
    spans = program["spans"]
    steps = spans.get(PREFIX + "step")
    out = {}
    if steps:
        n = steps["count"]
        out["launches_per_step"] = steps["launches"] / n
        optimizer = spans.get(PREFIX + "optimizer")
        if optimizer:
            out["optimizer_ms_per_step"] = 1e3 * optimizer["device_s"] / n
        minsr, rows = spans.get(PREFIX + "minsr"), spans.get(PREFIX + "minsr.rows")
        if minsr and rows:
            out["minsr_rows_ms_per_step"] = 1e3 * rows["device_s"] / n
            out["minsr_solve_ms_per_step"] = 1e3 * (minsr["device_s"] - rows["device_s"]) / n
    if program["boundaries"]:
        out["boundary_idle_ms_per_block"] = (
            1e3 * program["boundary_idle_s"] / program["boundaries"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The program's spans in a cell's traced window.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    from . import run
    from . import trace as tracing
    from .spec import load_cell, metric_reader

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the spans' readings need a CUDA card", file=sys.stderr)
        return 2
    from rnnwavefunctions_tpu_torch.ops.build import load_library

    load_library()
    trainer, state, _ = run.set_up(cell, args.seed, "cuda")
    tracing.add_ranges(trainer, state)
    log_every = cell.traffic["log_every"]
    for _ in range(cell.traffic["warmup_blocks"]):
        state = trainer.fit(log_every, state, log_every=log_every)[0]
    torch.cuda.synchronize()
    with tracing.traced(True) as prof:
        with tracing.window_range():
            run.run_window(trainer, state, args.seconds, log_every, torch.cuda.synchronize)
    summary = run.traced_summary(cell, tracing.events_of(prof))
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "readings": readings(summary["program"]),
        "metrics": {m["name"]: metric_reader(m["name"])(summary) for m in cell.per_layer},
        "spans": summary["program"]["spans"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
