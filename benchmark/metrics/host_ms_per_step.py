"""Host ms per step: the time the host spends inside the step's ranges
(``_sample_and_energy`` and ``_update``), less its calls that wait for the
device."""


def read(summary):
    return 1e3 * summary["host_s"] / summary["steps"] if summary["steps"] else None
