"""Device ms per step launched inside the program's ``rnnwf.minsr`` span
but not its ``rnnwf.minsr.rows``: the Gram and back-contraction GEMMs and
the CG solve (B21) (``program_spans.py``)."""

from benchmark import program_spans


def read(summary):
    return program_spans.readings(summary["program"]).get("minsr_solve_ms_per_step")
