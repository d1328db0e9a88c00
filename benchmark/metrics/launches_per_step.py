"""CUDA launch calls per step: the ``cudaLaunch*``, ``cuLaunch*`` and
``cudaGraphLaunch`` calls (a graph counting once) that begin inside the
program's ``rnnwf.step`` spans, over their count (``program_spans.py``)."""

from benchmark import program_spans


def read(summary):
    return program_spans.readings(summary["program"]).get("launches_per_step")
