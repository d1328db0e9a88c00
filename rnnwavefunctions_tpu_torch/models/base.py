"""The shared device rule and ``impl`` dispatch of the ansatz modules.

``resolve_device``: the parameters go to the card unless the caller asks
for another device (``device="cpu"``, as the CPU tests do); with no CUDA
device and no explicit device it raises, never falling back to the CPU.

Counterpart of ``rnnwavefunctions_tpu/models/base.py::resolve_impl``:

* ``"plain"`` always takes the plain PyTorch path;
* ``"kernel"`` needs kernel coverage and a CUDA device, and raises otherwise;
* ``"auto"`` takes the kernels exactly when the parameters lie on a CUDA
  device, and raises there when the configuration is outside kernel
  coverage: on the card the plain path runs only when ``impl="plain"``
  asks for it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

IMPLS = ("auto", "kernel", "plain")


def resolve_device(device) -> torch.device:
    """``None`` means the card (``cuda``); anything else is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the parameters go to the card unless a device is "
            "given; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def resolve_impl(ansatz: Any, kernelizable: Callable[[], bool], requirement: str) -> bool:
    """True when ``ansatz`` runs its kernels.  ``kernelizable`` is asked
    only when the answer matters (it may build the kernel library)."""
    if ansatz.impl not in IMPLS:
        raise ValueError(f"unknown impl {ansatz.impl!r}; expected one of {IMPLS}")
    if ansatz.impl == "plain":
        return False
    on_cuda = ansatz.device.type == "cuda"
    if ansatz.impl == "auto" and not on_cuda:
        return False
    if not kernelizable():
        raise ValueError(
            f"the CUDA kernels support {requirement}; got {ansatz!r} on "
            f"{ansatz.device}. Pass impl='plain' to run the plain PyTorch path"
        )
    if not on_cuda:
        raise ValueError(
            f"impl='kernel' needs the parameters on a CUDA device; they are "
            f"on {ansatz.device}"
        )
    return True
