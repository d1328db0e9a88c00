"""Layer times from the benchmark's own profiler ranges.

In a traced run ``add_ranges`` wraps the trainer's ``_sample_and_energy``,
``_update`` and ``_set_minsr_direction`` and the optimizer's ``step``, on
the instances, in ``torch.profiler.record_function`` ranges named
``benchmark.<method>``; ``benchmark.window`` spans the whole measured
window.  The profiler keeps its events in memory, and ``summarize``
reduces them:

* a device operation (kernel, copy, fill) counts toward the innermost
  range that was open on the host when the CUDA call that launched it
  began (the call of its correlation id; else the op the profiler links
  it to), so a layer's time does not depend on its kernels' names;
* busy time is the union of device operations inside the window, idle
  time the rest of the window, block boundaries and copies included;
* an idle gap is named after the innermost host op open at its middle, on
  any thread (the autograd engine runs the backward on its own thread);
* host time is the time the host spends inside the step ranges, less the
  calls that wait for the device (synchronisations and copies).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "benchmark."
WINDOW = PREFIX + "window"
RANGED = ("_sample_and_energy", "_update", "_set_minsr_direction")
OPTIMIZER = "optimizer.step"
STEP_RANGES = (PREFIX + "_sample_and_energy", PREFIX + "_update")
RUNTIME = re.compile(r"^cu(da)?[A-Z]")  # a CUDA runtime or driver call


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str     # "op" (a host op or range), "runtime" (a CUDA API call), "device"
    start: int    # ns
    end: int      # ns
    corr: int     # the correlation id a CUDA call shares with what it launched
    linked: int   # the host op open at the launch (0: none)
    thread: int


def add_ranges(trainer, state) -> None:
    """Wraps the step's layers in profiler ranges, on the instances."""

    def ranged(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)
        return wrapped

    for name in RANGED:
        setattr(trainer, name, ranged(name, getattr(trainer, name)))
    state.optimizer.step = ranged(OPTIMIZER, state.optimizer.step)


def window_range():
    return torch.profiler.record_function(WINDOW)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events_of(prof) -> List[Event]:
    """The profiler's raw events, without building its event tree."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type()
        if device == DeviceType.CUDA:
            kind = "device"
        elif device == DeviceType.CPU:
            if e.is_async() or e.name().startswith("[memory]"):
                continue
            kind = "runtime" if RUNTIME.match(e.name()) else "op"
        else:
            continue
        start = e.start_ns()
        out.append(Event(e.name(), kind, start, start + e.duration_ns(), e.correlation_id(),
                         e.linked_correlation_id(), e.start_thread_id()))
    return out


class Innermost:
    """The innermost of properly nested intervals at a time."""

    def __init__(self, intervals: List[Tuple[int, int, str]]):
        points, stack = [], []

        def pop_until(t):
            while stack and stack[-1][1] <= t:
                end = stack.pop()[1]
                top = stack[-1] if stack else (None, None, None)
                points.append((end, top[2], top[0]))

        for start, end, label in sorted(intervals, key=lambda x: (x[0], -x[1])):
            pop_until(start)
            stack.append((start, end, label))
            points.append((start, label, start))
        pop_until(float("inf"))
        points.sort(key=lambda p: p[0])
        self.times = [p[0] for p in points]
        self.points = points

    def at(self, t: float) -> Tuple[Optional[str], Optional[int]]:
        """(label, start) of the innermost interval holding ``t``."""
        i = bisect.bisect_right(self.times, t) - 1
        return (None, None) if i < 0 else self.points[i][1:]


def _merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel or op name without its return type and arguments, in the
    characters of a metric name, at most 64 of them."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)", "anon")
    name = name.split("(")[0] or name
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def _is_wait(name: str) -> bool:
    return "Synchronize" in name or name.startswith(("cudaMemcpy", "cuMemcpy"))


def summarize(events: List[Event]) -> Dict:
    """The traced window's numbers: ``window_s``, ``busy_s``, ``steps``,
    ``host_s``, device seconds per innermost range (``device_s``, keyed by
    method name, ``"other"`` outside every step range), and the
    ``breakdown`` (the ten device operations that took most time and the
    ten host ops under which the card idled longest)."""
    ops = [e for e in events if e.kind == "op"]
    window = max((e for e in ops if e.name == WINDOW), key=lambda e: e.end - e.start)
    w0, w1 = window.start, window.end
    ranges = [(e.start, e.end, e.name) for e in ops
              if e.name.startswith(PREFIX) and e.name != WINDOW and w0 <= e.start < w1]
    ranges_at = Innermost(ranges)
    op_start = {e.corr: e.start for e in ops if e.corr > 0}
    calls = {e.corr: e for e in events if e.kind == "runtime"}

    # the profiler mirrors host ranges onto the device's timeline: not work
    host_names = {e.name for e in ops}
    device_s: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    busy = []
    for e in events:
        if e.kind != "device" or e.name in host_names:
            continue
        a, b = max(e.start, w0), min(e.end, w1)
        if b <= a:
            continue
        # launched by the CUDA call of its correlation id, else under the op
        # it is linked to, else (neither recorded) when it began
        call = calls.get(e.corr)
        if call is not None and call.start <= e.start:
            launched = call.start
        else:
            launched = op_start.get(e.linked, e.start) if e.linked > 0 else e.start
        label = ranges_at.at(launched)[0]
        device_s[label[len(PREFIX):] if label else "other"] += (b - a) / 1e9
        by_name[short_name(e.name)] += (b - a) / 1e9
        busy.append((a, b))
    busy = _merged(busy)
    busy_ns = sum(b - a for a, b in busy)

    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    by_thread = collections.defaultdict(list)
    for e in ops:
        if e.end > w0 and e.start < w1 and e.name != WINDOW:
            by_thread[e.thread].append((e.start, e.end, e.name))
    host_at = [Innermost(iv) for iv in by_thread.values()]
    idle: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        found = [h.at(mid) for h in host_at]
        found = [f for f in found if f[0] is not None]
        label = max(found, key=lambda f: f[1])[0] if found else "host_outside_ops"
        idle[short_name(label)] += (b - a) / 1e9

    steps = sum(1 for s, _, n in ranges if n == PREFIX + "_update")
    top_ranges = [(s, e) for s, e, n in ranges if n in STEP_RANGES]
    host_ns = sum(e - s for s, e in top_ranges)
    for e in events:
        if e.kind == "runtime" and _is_wait(e.name) and ranges_at.at(e.start)[0] is not None:
            host_ns -= e.end - e.start

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "steps": steps,
        "host_s": host_ns / 1e9,
        "device_s": dict(device_s),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)},
    }


@contextlib.contextmanager
def traced(enabled: bool):
    """The profiler around the window when ``enabled``; yields it (or None)."""
    if not enabled:
        yield None
        return
    with profiler() as prof:
        yield prof
