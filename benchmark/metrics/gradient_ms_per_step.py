"""Device ms per step under ``_update`` outside the optimizer's and the
minSR direction's ranges: the surrogate loss, ``log_amp`` (K1 storing, or
B12 storing) and its backward (K2, or B14).  Nothing to read in a minSR
cell, whose update has no loss gradient."""


def read(summary):
    if "gradient" not in summary["least_s"]:
        return None
    seconds = summary["device_s"].get("_update")
    return 1e3 * seconds / summary["steps"] if seconds else None
