"""Device ms per step launched inside the program's ``rnnwf.minsr.rows``
span: the per-sample jacobian rows (B17/B18) (``program_spans.py``)."""

from benchmark import program_spans


def read(summary):
    return program_spans.readings(summary["program"]).get("minsr_rows_ms_per_step")
