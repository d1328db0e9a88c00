"""Named spans of the port's phases, on the profiler's own clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs, so the span lands in the same trace as the device's kernels
and copies, and a kernel can be put down to the span whose host code
launched it.  With no profiler running it is one shared no-op context: the
only cost is the check ``torch.autograd._profiler_enabled()`` (a
``record_function`` entered with no profiler costs about a hundred times
more), so the spans can sit in the step's hot path.

The names start with ``rnnwf.``; the kernels' own names live in the
``rnnwf::`` namespace.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler runs, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
