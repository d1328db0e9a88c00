"""The estimator's least time (``roofline.py``) over its device time per
step, in percent."""


def read(summary):
    seconds = summary["device_s"].get("_sample_and_energy")
    least = summary["least_s"].get("estimator")
    if not seconds or least is None:
        return None
    return 100.0 * least / (seconds / summary["steps"])
