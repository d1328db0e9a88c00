"""Device ms per step under ``_set_minsr_direction``: the jacobian rows
(B17/B18), the Gram and back-contraction GEMMs and the CG solve (B21)."""


def read(summary):
    seconds = summary["device_s"].get("_set_minsr_direction")
    return 1e3 * seconds / summary["steps"] if seconds else None
