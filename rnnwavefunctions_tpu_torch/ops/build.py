"""Builds the CUDA kernels under ``csrc/`` at first use and loads them.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all started
together) and links the objects into one shared library with a plain C
interface (``-gencode arch=compute_90a,code=sm_90a``, no fast math), which
``ctypes`` loads: a build of seconds, where a PyTorch C++ extension would
take minutes.  The library goes to ``rnnwavefunctions_tpu_torch/_build/``
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_LL = ctypes.c_longlong
_EXCHANGE = ([_P, _U, _U] + [_P] * 13 + [_I] * 4 + [_F, _F, _I, _I, _P], _I)
# C entry points: name -> (argument types, result type); pointers and the
# stream go as void*, and the launches return a CUDA error code
SIGNATURES = {
    "rnnwf_gru_log_prob": ([_P] * 8 + [_I, _I, _I, _P], _I),
    "rnnwf_gru_replay": ([_P] * 11 + [_I, _I, _I, _P], _I),
    "rnnwf_gru_log_prob_bwd": ([_P] * 10 + [_I, _I, _I, _P], _I),
    "rnnwf_gru_bwd_partial_floats": ([_I, _I, _I], _LL),
    "rnnwf_gru_bwd_sweep": ([_P] * 8 + [_I] * 3 + [_P], _I),
    "rnnwf_tfim_flip_ratio_sum": ([_P] * 13 + [_I, _I, _I, _P], _I),
    "rnnwf_tfim_sample_and_flip_sum": ([_U, _U] + [_P] * 13 + [_I, _I, _I, _P], _I),
    "rnnwf_tfim_flip_log_probs": ([_P] * 12 + [_I, _I, _I, _P], _I),
    "rnnwf_tfim_sample_and_flip_log_probs": ([_U, _U] + [_P] * 12 + [_I, _I, _I, _P], _I),
    "rnnwf_gru_sample": ([_U, _U] + [_P] * 8 + [_I, _I, _I, _P], _I),
    "rnnwf_crnn_log_amp_parts": ([_P] * 11 + [_I] * 4 + [_P], _I),
    "rnnwf_crnn_replay": ([_P] * 14 + [_I] * 4 + [_P], _I),
    "rnnwf_crnn_log_amp_bwd": ([_P] * 12 + [_I] * 3 + [_P], _I),
    "rnnwf_crnn_bwd_partial_floats": ([_I, _I, _I], _LL),
    "rnnwf_j1j2_num_bonds": ([_I, _I, _I], _I),
    "rnnwf_j1j2_exchange_offdiag": _EXCHANGE,
    "rnnwf_j1j2_sample_and_exchange": _EXCHANGE,
    "rnnwf_crnn_sample": ([_U, _U] + [_P] * 10 + [_I] * 4 + [_P], _I),
    "rnnwf_mdrnn_log_prob": ([_P] * 9 + [_I] * 4 + [_P], _I),
    "rnnwf_mdrnn_sample": ([_U, _U] + [_P] * 9 + [_I] * 4 + [_P], _I),
    "rnnwf_mdrnn_replay": ([_P] * 11 + [_I] * 4 + [_P], _I),
    "rnnwf_mdrnn_log_prob_bwd": ([_P] * 10 + [_I] * 4 + [_P], _I),
    "rnnwf_mdrnn_bwd_partial_floats": ([_I, _I, _I], _LL),
    "rnnwf_mdrnn_flip_ratio_sum": ([_P] * 14 + [_LL] + [_I] * 4 + [_P], _I),
    "rnnwf_mdrnn_sample_and_flip_sum": ([_U, _U] + [_P] * 14 + [_LL] + [_I] * 4 + [_P], _I),
    "rnnwf_mdrnn_suffix_scratch_floats": ([_I] * 4 + [ctypes.POINTER(_LL)], _I),
    "rnnwf_rollout_hist": ([_P] * 7 + [_I] * 3 + [_P], _I),
    "rnnwf_sweep_dgates": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "rnnwf_sr_cg_solve": ([_P] * 4 + [_I, _I, ctypes.POINTER(_I), _P], _I),
    "rnnwf_fits_shared_memory": ([_I, _I, _I, _I, ctypes.POINTER(_I)], _I),
    "rnnwf_crnn_smem_bytes": ([_I, ctypes.POINTER(_LL)], None),
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


def _check_nvcc(returncode: int, cmd, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stderr}")


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
        nvcc = _nvcc()
        objects = [tmp.with_name(f"{tmp.name}.{path.stem}.o") for path in cu]
        t0 = time.perf_counter()
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(path)]
                        for obj, path in zip(objects, cu))
        ]
        logs = [proc.communicate()[1] for _, proc in procs]  # every process ends here
        for (cmd, proc), stderr in zip(procs, logs):
            _check_nvcc(proc.returncode, cmd, stderr)
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(proc.returncode, link, proc.stderr)
        seconds = time.perf_counter() - t0
        for obj in objects:
            obj.unlink()
        os.replace(tmp, target)  # atomic: a concurrent process never loads half a file
        log = "".join(logs)
    lib = ctypes.CDLL(str(target))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return KernelLibrary(lib, target, seconds, log)

