"""Builds the CUDA kernels under ``csrc/`` at first use and loads them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface (``-gencode arch=compute_90a,code=sm_90a``, no fast math), which
``ctypes`` loads: a build of a few seconds, where a PyTorch C++ extension
would take minutes.  The library goes to ``rnnwavefunctions_tpu_torch/_build/``
under a name keyed by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.  Only the sources in this
package are compiled.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C entry points: name -> (argument types, result type); pointers and the
# stream go as void*, and the launches return a CUDA error code
SIGNATURES = {
    "rnnwf_gru_log_prob": ([_P] * 8 + [_I, _I, _I, _P], _I),
    "rnnwf_gru_log_prob_bwd": ([_P] * 11 + [_I, _I, _I, _P], _I),
    "rnnwf_gru_bwd_partial_floats": ([_I, _I], ctypes.c_longlong),
    "rnnwf_tfim_flip_ratio_sum": ([_P] * 13 + [_I, _I, _I, _P], _I),
    "rnnwf_tfim_sample_and_flip_sum": ([_U, _U] + [_P] * 13 + [_I, _I, _I, _P], _I),
    "rnnwf_fits_shared_memory": ([_I, _I, ctypes.POINTER(_I)], _I),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    build_log: str        # nvcc's -Xptxas -v report (registers, spills)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in the CUDA toolkit's default "
        "location); the CUDA kernels cannot be built"
    )


@functools.cache
def load_library() -> KernelLibrary:
    """Compiles (if needed) and loads the kernel library; raises with nvcc's
    stderr if the build fails."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    target = BUILD_DIR / f"librnnwf_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: a concurrent process never loads half a file
        log = proc.stderr
    lib = ctypes.CDLL(str(target))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return KernelLibrary(lib, target, seconds, log)


def check(err: int, name: str) -> None:
    """Raises if a C entry point reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
