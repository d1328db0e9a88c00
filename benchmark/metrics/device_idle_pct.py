"""The share of the whole traced window, block boundaries and copies
included, in which no operation ran on the device, in percent."""


def read(summary):
    window = summary["window_s"]
    return 100.0 * (1.0 - summary["busy_s"] / window) if window > 0 else None
