"""K2: the VJP of sum_b g_b log p(sigma_b) with respect to the GRU weights.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_gru_bwd.py::gru_log_prob_bwd``.
The CUDA kernel is ``csrc/fused_gru_bwd.cu`` (forward replay storing the
hidden history, reverse sweep recomputing the gates, per-block partial
gradients summed in block order).  The plain version is autograd through
the plain K1 loop (``fused_gru.log_prob_bwd_plain``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import check, load_library
from .fused_gru import (
    Weights,
    check_samples,
    check_supported,
    check_weights,
    is_cpu_call,
    log_prob_bwd_plain,
    stream_of,
)


def gru_log_prob_bwd(weights: Weights, samples: torch.Tensor,
                     g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(g * log p(samples)) for the six weights, in their
    shapes."""
    if is_cpu_call(samples, g, *weights):
        return tuple(log_prob_bwd_plain(weights, samples, g))
    u = check_weights(weights)
    b, n = check_samples(samples)
    check_supported(n, u, samples.device)
    if g.dtype != torch.float32 or tuple(g.shape) != (b,) or not g.is_contiguous():
        raise ValueError(
            f"cotangent must be a contiguous float32 ({b},) tensor; got "
            f"{tuple(g.shape)} {g.dtype}"
        )
    dev = samples.device
    lib = load_library().lib
    sizes = [w.numel() for w in weights]
    hist = torch.empty(b * n * u, dtype=torch.float32, device=dev)
    partial = torch.empty(lib.rnnwf_gru_bwd_partial_floats(b, u), dtype=torch.float32,
                          device=dev)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rnnwf_gru_log_prob_bwd(
            samples.data_ptr(), g.data_ptr(), *[w.data_ptr() for w in weights],
            hist.data_ptr(), partial.data_ptr(), flat.data_ptr(), b, n, u,
            stream_of(samples),
        )
    check(err, "rnnwf_gru_log_prob_bwd")
    gru_log_prob_bwd.launches += 1
    return tuple(
        part.view(w.shape) for part, w in zip(torch.split(flat, sizes), weights)
    )


gru_log_prob_bwd.launches = 0
