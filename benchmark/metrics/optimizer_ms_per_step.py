"""Device ms per step launched inside the program's ``rnnwf.optimizer``
span: the optimizer's update of the parameters (``program_spans.py``)."""

from benchmark import program_spans


def read(summary):
    return program_spans.readings(summary["program"]).get("optimizer_ms_per_step")
