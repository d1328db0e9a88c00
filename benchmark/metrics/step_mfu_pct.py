"""The whole step's share of the chip's peaks: the summed least time of the
step's layers (``roofline.py``) over the traced window's time per step, in
percent."""


def read(summary):
    if not summary["steps"] or summary["window_s"] <= 0:
        return None
    return 100.0 * sum(summary["least_s"].values()) / (summary["window_s"] / summary["steps"])
