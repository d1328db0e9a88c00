"""The plain reference the benchmark holds the port against.

Plain PyTorch written from the published equations: float32 site
arithmetic with TF32 off, each sample's log p and each local energy summed
in float64, and the minSR system solved densely in float64.  It imports
neither JAX nor anything of ``rnnwavefunctions_tpu_torch``, and takes from
the program only what it judges (the drawn samples, read back).

Every matrix product goes through a ``Precision``: ``FP32`` is the
reference; ``TF32`` rounds both operands to TF32 (10 mantissa bits, round
to nearest) before a float32 product, as the tensor cores' TF32 mode does.
The TF32 reference put in the program's place is the benchmark's control:
the precision one step below what the configurations state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 11 significant bits, to nearest, by
    Veltkamp's split (g = (2^13 + 1) x; g - (g - x) keeps the high 11
    bits): plain float32 arithmetic, so that vmap and autograd pass
    through it."""
    g = x * 8193.0
    return g - (g - x)


def _fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return round_tf32(a) @ round_tf32(b)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


FP32 = Precision("fp32", _fp32)
TF32 = Precision("tf32", _tf32)


def fp32_matmuls() -> None:
    """float32 products stay float32 on the card (no TF32 in cuBLAS)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
