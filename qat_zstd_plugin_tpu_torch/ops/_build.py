"""Build the port's CUDA sources with nvcc and load them with ctypes.

`csrc/*.cu` is compiled on first use into a shared library with a plain C
interface under `build/torch_kernels/<key>/` beside the package, where
<key> hashes the sources and the flags, so an edit rebuilds and an
unchanged tree reuses the library. No PyTorch header is compiled, which
keeps a build to seconds. Nothing is built at import: the CPU tests
import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_NAME = "libl1_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of csrc/l1_kernels.cu: argument types, each ending in the
# stream; every one returns a cudaError_t as int.
SIGNATURES = {
    "qz_hash_keys_winmin_sync": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "qz_neighbor_unsort_keys": (_P, _P, _I, _I, _I, _I, _I, _P),
    "qz_ldm_keys": (_P, _P, _I, _I, _I, _I, _I, _P),
    "qz_compact_slots_sync": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's nvcc run


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile csrc/ unless the library for these sources exists; returns
    its path. The output is renamed into place, so a killed build never
    leaves a half-written library behind."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.qz_cuda_error_string.argtypes = [ctypes.c_int]
            lib.qz_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
