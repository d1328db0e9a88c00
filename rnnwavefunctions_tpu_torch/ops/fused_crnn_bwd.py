"""B9: the VJP of sum_b (g_re[b] Re log psi_b + g_im[b] Im log psi_b) with
respect to the weights of the single-layer U(1) cRNN.

Counterpart of ``rnnwavefunctions_tpu/ops/fused_crnn_bwd.py::crnn_log_amp_bwd``.
The CUDA kernel is ``csrc/fused_crnn_bwd.cu`` (forward replay storing the
hidden history, reverse sweep through both heads and the U(1)
renormalisation chain, per-block partial gradients summed in block order).
The plain version is autograd through the plain B7 loop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import check, load_library
from .fused_crnn import log_amp_parts_plain
from .fused_gru import (
    CRNN_FAMILY,
    Weights,
    check_samples,
    check_supported,
    check_weights,
    is_cpu_call,
    stream_of,
)


def log_amp_bwd_plain(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor,
                      g_im: torch.Tensor, u1: bool):
    """Autograd through ``log_amp_parts_plain``; returns the weight
    gradients."""
    with torch.enable_grad():
        ws = [w.detach().requires_grad_(True) for w in weights]
        re, im = log_amp_parts_plain(ws, samples, u1)
        return torch.autograd.grad((re, im), ws, grad_outputs=(g_re, g_im))


def crnn_log_amp_bwd(weights: Weights, samples: torch.Tensor, g_re: torch.Tensor,
                     g_im: torch.Tensor, u1: bool) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(g_re * Re + g_im * Im) for the eight weights, in
    their shapes."""
    if is_cpu_call(samples, g_re, g_im, *weights):
        return tuple(log_amp_bwd_plain(weights, samples, g_re, g_im, u1))
    u = check_weights(weights, heads=2)
    b, n = check_samples(samples)
    check_supported(n, u, samples.device, CRNN_FAMILY)
    for g in (g_re, g_im):
        if g.dtype != torch.float32 or tuple(g.shape) != (b,) or not g.is_contiguous():
            raise ValueError(
                f"cotangents must be contiguous float32 ({b},) tensors; got "
                f"{tuple(g.shape)} {g.dtype}"
            )
    dev = samples.device
    lib = load_library().lib
    sizes = [w.numel() for w in weights]
    hist = torch.empty(b * n * u, dtype=torch.float32, device=dev)
    partial = torch.empty(lib.rnnwf_crnn_bwd_partial_floats(b, u), dtype=torch.float32,
                          device=dev)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rnnwf_crnn_log_amp_bwd(
            samples.data_ptr(), g_re.data_ptr(), g_im.data_ptr(),
            *[w.data_ptr() for w in weights], hist.data_ptr(), partial.data_ptr(),
            flat.data_ptr(), b, n, u, int(u1), stream_of(samples),
        )
    check(err, "rnnwf_crnn_log_amp_bwd")
    crnn_log_amp_bwd.launches += 1
    return tuple(
        part.view(w.shape) for part, w in zip(torch.split(flat, sizes), weights)
    )


crnn_log_amp_bwd.launches = 0
