"""Device ms per step under ``_sample_and_energy``: the fused sample and
local-energy kernels (K3 on the chain, B16 on the lattice) and the diagonal."""


def read(summary):
    seconds = summary["device_s"].get("_sample_and_energy")
    return 1e3 * seconds / summary["steps"] if seconds else None
