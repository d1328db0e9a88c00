"""Device idle ms at each block boundary: from the start of the program's
``rnnwf.readback`` span (the block's one copy) to the first operation the
next block launches, less the device's busy time in between, averaged
over the boundaries that a launch follows (``program_spans.py``)."""

from benchmark import program_spans


def read(summary):
    return program_spans.readings(summary["program"]).get("boundary_idle_ms_per_block")
