"""The kernel wrappers' shared contract: how a Python call becomes a launch
on the card.

Every wrapper in ``ops/`` runs its plain PyTorch version when its tensors
lie on the CPU (``is_cpu_call``) and otherwise checks its arguments here
(``check_weights``, ``check_samples``, ``check_float32``), asks whether the
kernels of its family take the shape (``check_supported``) and calls
``launch``, which enters the device, appends the device's current stream,
calls the C entry point and raises if the launch was refused.
``counts_launches`` gives a wrapper its ``launches`` count.

The samplers draw from Philox keyed by a (seed, offset) pair: ``draw_key``
takes the pair from the caller's CPU generator (the stream a checkpoint
carries), ``begin_draw`` is every sampler's prologue, and on the CPU the
plain versions draw ``plain_uniforms`` from the same pair.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from .build import load_library

Weights = Tuple[torch.Tensor, ...]

# kernel families whose shared memory ``rnnwf_fits_shared_memory`` checks
GRU_FAMILY, CRNN_FAMILY, MDRNN_FAMILY = 0, 1, 2


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def is_cpu_call(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on CUDA (the kernel runs); raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must lie on one CUDA device")
    return False


def check_layout(weights: Weights, shapes) -> None:
    """Raises unless ``weights`` are contiguous float32 tensors of
    ``shapes``, one each."""
    if len(weights) != len(shapes):
        raise ValueError(f"expected {len(shapes)} weight tensors, got {len(weights)}")
    for w, shape in zip(weights, shapes):
        if w.dtype != torch.float32 or tuple(w.shape) != shape:
            raise ValueError(
                f"weight of shape {tuple(w.shape)} and dtype {w.dtype}; the "
                f"kernels take float32 {shape}"
            )
        if not w.is_contiguous():
            raise ValueError("weights must be contiguous")


def check_weights(weights: Weights, heads: int = 1) -> int:
    """Checks the GRU kernels' weight tuple: the GRU layer and ``heads``
    2-logit heads (6 tensors for K1-K4, 8 for the cRNN kernels, 4 for the
    trunk alone); returns U."""
    u = weights[1].shape[0] if len(weights) > 1 else 0
    check_layout(weights, [(2, 3 * u), (u, 3 * u), (3 * u,), (3 * u,)] + [(u, 2), (2,)] * heads)
    return u


def check_samples(samples: torch.Tensor, ndim: int = 2) -> Tuple[int, ...]:
    """Checks (B, N) chains (``ndim`` 2) or (B, Nx, Ny) lattices (3) of
    int32 spins; returns the shape."""
    layout = "(B, N)" if ndim == 2 else "(B, Nx, Ny)"
    if samples.dtype != torch.int32 or samples.dim() != ndim:
        raise ValueError(
            f"samples must be a {layout} int32 tensor; got {tuple(samples.shape)} "
            f"{samples.dtype}"
        )
    if not samples.is_contiguous():
        raise ValueError("samples must be contiguous")
    if min(samples.shape) < 1:
        raise ValueError(f"empty sample batch {tuple(samples.shape)}")
    return tuple(samples.shape)


def check_chains(weights: Weights, samples: torch.Tensor, family: int = GRU_FAMILY,
                 heads: int = 1) -> Tuple[int, int, int]:
    """The checks before a launch on (B, N) chains: the weights (with
    ``heads`` heads), the samples and the family's coverage; returns
    (B, N, U)."""
    u = check_weights(weights, heads)
    b, n = check_samples(samples)
    check_supported(n, u, samples.device, family)
    return b, n, u


def check_float32(what: str, tensors, shapes, device) -> None:
    """Raises unless each of ``tensors`` (a cotangent, or a stored replay's
    tensor handed to a later stage) is a contiguous float32 tensor of its
    shape on ``device``; ``what`` names them in the error."""
    for t, shape in zip(tensors, shapes):
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous() or t.device != device):
            raise ValueError(
                f"{what} {tuple(t.shape)} {t.dtype} on {t.device}; the kernel takes "
                f"contiguous float32 {tuple(shape)} on {device}"
            )


# ---------------------------------------------------------------------------
# coverage: which shapes each family's kernels take
# ---------------------------------------------------------------------------

def fits_shared_memory(family: int, n_sites: int, units: Sequence[int], device,
                       nx: int = 0) -> bool:
    """True when the kernels of ``family`` take this shape on ``device``:
    one layer and, on a CUDA device, every kernel's shared memory within
    the device's opt-in limit per block (asked of the kernel library, whose
    launches use the same sizes; ``nx`` is the MDRNN family's lattice
    width).  On the CPU only the plain versions run, and they take any
    width."""
    units = tuple(units)
    if len(units) != 1 or n_sites < 1:
        return False
    device = torch.device(device)
    if device.type != "cuda":
        return True
    fits = ctypes.c_int(0)
    index = torch.cuda.current_device() if device.index is None else device.index
    call("rnnwf_fits_shared_memory", device, family, nx, units[0], index, ctypes.byref(fits))
    return bool(fits.value)


def check_supported(n: int, u: int, device, family: int = GRU_FAMILY, nx: int = 0) -> None:
    """Raises unless the kernels of ``family`` take N sites (an Nx-wide
    lattice of them for the MDRNN family) at width U on ``device``."""
    if not fits_shared_memory(family, n, (u,), device, nx=nx):
        shape = f"a {nx}x{n // nx} lattice" if nx else f"N={n}"
        raise ValueError(f"the CUDA kernels do not take {shape} at U={u} on {device}")


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------

def check(err: int, name: str) -> None:
    """Raises if a C entry point reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(device) -> int:
    """The handle of ``device``'s current CUDA stream."""
    return torch.cuda.current_stream(device).cuda_stream


def call(name: str, device, *args) -> None:
    """Calls the C entry point ``name`` on ``device`` and raises through
    ``check`` if it returns an error.  ``args`` go in the C order: a tensor
    as its ``data_ptr()``, ``None`` as a null pointer, Python ints and floats
    and ctypes objects (``byref``) as they are."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(load_library().lib, name)(*args)
    check(err, name)


class _Launched(threading.local):
    count = 0  # the launches this thread made, for counts_launches


_launched = _Launched()


def launch(name: str, device, *args) -> None:
    """Launches the kernel entry point ``name`` on ``device``: ``call`` with
    the device's current stream appended as the last argument."""
    call(name, device, *args, stream_of(device))
    _launched.count += 1


def counts_launches(owner: Optional[Callable] = None):
    """Decorator giving a kernel wrapper its count of calls that launched on
    the card, ``launches``: a call counts once however many kernels it
    launches, in the innermost counted wrapper that made it, and a CPU call
    or a refused one counts nothing.  With ``owner`` (a wrapper's twin that
    also returns its stages) the calls count in ``owner.launches``."""

    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            start = _launched.count
            out = fn(*args, **kwargs)
            if _launched.count > start:
                (owner or counted).launches += 1
                _launched.count = start  # an outer counted wrapper counts nothing more
            return out

        if owner is None:
            counted.launches = 0
        return counted

    return wrap


# ---------------------------------------------------------------------------
# the samplers' key
# ---------------------------------------------------------------------------

def draw_key(generator: torch.Generator) -> Tuple[int, int]:
    """The (seed, offset) pair that keys one kernel draw, taken from the
    caller's CPU ``generator``: the step's whole randomness, so a run is a
    function of the generator's seed and a checkpoint carries the stream."""
    seed, offset = torch.randint(0, 2**32, (2,), generator=generator, dtype=torch.int64).tolist()
    return seed, offset


def check_key(seed: int, offset: int) -> None:
    """The samplers' Philox key: each word in [0, 2^32)."""
    if not (0 <= seed < 2**32 and 0 <= offset < 2**32):
        raise ValueError(f"seed and offset must lie in [0, 2^32); got {seed}, {offset}")


def plain_uniforms(num_samples: int, n_sites: int, seed: int, offset: int,
                   device) -> torch.Tensor:
    """The plain sampler's (B, N) uniforms, drawn from a CPU generator seeded
    by the (seed, offset) pair the kernel would get."""
    gen = torch.Generator().manual_seed((seed << 32) | offset)
    return torch.rand(num_samples, n_sites, generator=gen).to(device)


class Draw(NamedTuple):
    """What a sampler's prologue hands its body: on the CPU the plain
    version's uniforms; on the card the samples buffer and U."""

    uniforms: Optional[torch.Tensor]  # (B, sites) in visit order, on the CPU
    samples: Optional[torch.Tensor]   # (B, *sites) int32 for the kernel to write
    u: int


def begin_draw(weights: Weights, num_samples: int, sites: Tuple[int, ...], seed: int,
               offset: int, family: int,
               weights_check: Callable[[Weights], int] = check_weights) -> Draw:
    """The prologue of every sampler that draws from a key: checks the key
    and that ``num_samples`` and the ``sites`` (N,) of a chain or (Nx, Ny) of
    a lattice are >= 1; then on the CPU draws the plain uniforms, and on the
    card checks the weights (``weights_check`` returns U) and the family's
    coverage and allocates the samples."""
    check_key(seed, offset)
    if min(num_samples, *sites) < 1:
        raise ValueError(f"num_samples and the sizes {sites} must be >= 1; got {num_samples}")
    dev = weights[0].device
    n = math.prod(sites)
    if is_cpu_call(*weights):
        return Draw(plain_uniforms(num_samples, n, seed, offset, dev), None, 0)
    u = weights_check(weights)
    check_supported(n, u, dev, family, nx=sites[0] if len(sites) == 2 else 0)
    return Draw(None, torch.empty(num_samples, *sites, dtype=torch.int32, device=dev), u)
