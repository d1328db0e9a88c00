"""B14: the VJP of sum_b g_b log p(sigma_b) with respect to the MDRNN's cell
and head weights.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_mdrnn_bwd.py::mdrnn_log_prob_bwd``.
The CUDA kernel is ``csrc/fused_mdrnn_bwd.cu`` (forward replay storing the
cell-output history, reverse sweep routing cotangents along the horizontal
and vertical links, per-block partial gradients summed in block order).
The plain version is autograd through the plain sweep
(``fused_mdrnn.log_prob_bwd_plain``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import check, load_library
from .fused_gru import is_cpu_call, stream_of
from .fused_mdrnn import (
    Weights,
    check_samples,
    check_supported,
    check_weights,
    log_prob_bwd_plain,
    weight_ptrs,
)


def mdrnn_log_prob_bwd(weights: Weights, samples: torch.Tensor,
                       g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(g * log p(samples)) for the seven weights (uh, uv,
    wh, wv, b, head w, head b), in their shapes (the JAX layout)."""
    if is_cpu_call(samples, g, *weights):
        return tuple(log_prob_bwd_plain(weights, samples, g))
    u = check_weights(weights)
    b, nx, ny = check_samples(samples)
    check_supported(nx, ny, u, samples.device)
    if g.dtype != torch.float32 or tuple(g.shape) != (b,) or not g.is_contiguous():
        raise ValueError(
            f"cotangent must be a contiguous float32 ({b},) tensor; got "
            f"{tuple(g.shape)} {g.dtype}"
        )
    dev = samples.device
    lib = load_library().lib
    sizes = [w.numel() for w in weights]
    hist = torch.empty(b * nx * ny * u, dtype=torch.float32, device=dev)
    partial = torch.empty(lib.rnnwf_mdrnn_bwd_partial_floats(b, u), dtype=torch.float32,
                          device=dev)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rnnwf_mdrnn_log_prob_bwd(
            samples.data_ptr(), g.data_ptr(), *weight_ptrs(weights), hist.data_ptr(),
            partial.data_ptr(), flat.data_ptr(), b, nx, ny, u, stream_of(samples),
        )
    check(err, "rnnwf_mdrnn_log_prob_bwd")
    mdrnn_log_prob_bwd.launches += 1
    return tuple(
        part.view(w.shape) for part, w in zip(torch.split(flat, sizes), weights)
    )


mdrnn_log_prob_bwd.launches = 0
