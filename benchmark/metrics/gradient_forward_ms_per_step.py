"""Device ms per step launched inside the program's
``rnnwf.gradient.forward`` span: the loss gradient's forward pass (B9's
replay, B10's base pass storing, for the cRNN; B12 storing for the MDRNN),
over the count of ``rnnwf.step`` (``program_spans.py``).  Nothing to read
where the program has no such span."""


def read(summary):
    spans = summary["program"]["spans"]
    forward, steps = spans.get("rnnwf.gradient.forward"), spans.get("rnnwf.step")
    if not forward or not steps:
        return None
    return 1e3 * forward["device_s"] / steps["count"]
