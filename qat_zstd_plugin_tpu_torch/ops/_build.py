"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` is compiled on first use, one nvcc process per source
and all of them at once, and the objects are linked into one shared
library with a plain C interface under `build/torch_kernels/<key>/`
beside the package, where <key> hashes every file under csrc/ (headers
included) and the flags, so an edit rebuilds and an unchanged tree reuses
the library. No PyTorch header is compiled, which keeps a build to
seconds. Nothing is built at import: the CPU tests import every module on
a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..runtime import stats

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_NAME = "libqz_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _U, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_size_t
# C entry points of csrc/*.cu: argument types, each ending in the stream;
# every one returns a cudaError_t as int.
SIGNATURES = {
    "qz_hash_keys_winmin_sync": (_P,) * 4 + (_I,) * 6 + (_U, _I, _P),
    "qz_neighbor_unsort_keys": (_P, _P, _I, _I, _I, _I, _I, _U, _P),
    "qz_ldm_keys": (_P, _P, _I, _I, _I, _I, _I, _U, _P),
    "qz_compact_slots_sync": (_P,) * 4 + (_I,) * 9 + (_U, _P),
    "qz_hash_keys": (_P, _P, _I, _I, _I, _I, _I, _U, _P),
    "qz_hash_keys_winmin": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _P),
    "qz_finalize_candidates": (_P,) * 9 + (_I,) * 8 + (_Z, _P),
    "qz_compact_slots_dense": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "qz_ldm_winmin": (_P, _P, _P, _I, _I, _I, _P),
    "qz_parse_greedy": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "qz_gram_pos_planes": (_P, _P, _P, _I, _I, _I, _P),
    "qz_neighbor_verify_keys": (_P, _P, _P, _I, _I, _I, _I, _P),
    "qz_finalize_verified": (_P,) * 6 + (_I,) * 3 + (_Z, _P),
    "qz_fse_state": (_P,) * 20 + (_I,) * 4 + (_Z, _Z, _P),
    "qz_literal_keys": (_P,) * 6 + (_I, _I, _P),
    "qz_byte_hist": (_P, _P, _I, _I, _P),
    "qz_compact_slots": (_P, _P, _P, _I, _I, _I, _P),
    "qz_compact_operands": (_P,) * 5 + (_I,) * 4 + (_P,),
    "qz_bitonic_sort": (_P,) * 7 + (_I,) * 3 + (_P, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's nvcc runs


def _sources(csrc: str = CSRC) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def library_path(csrc: str = CSRC) -> str:
    """Where the library for the files under `csrc` and NVCC_FLAGS goes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for root, dirs, files in os.walk(csrc):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, csrc).encode() + b"\0")
            with open(path, "rb") as f:
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


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{err}")


def build() -> str:
    """Compile csrc/ unless the library for these sources exists; returns
    its path. Processes that need it at once (benchmark -P children,
    torch.distributed ranks) take a file lock beside it, so one of them
    builds and the others wait and load its library (build_seconds stays
    None in those). The library is renamed into place, so a killed build
    never leaves a half-written one behind."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.exists(path):
            _compile(path)
    return path


def _compile(path: str) -> None:
    global build_seconds
    tag = f"tmp.{os.getpid()}"
    nvcc = _nvcc()
    objs = [os.path.join(os.path.dirname(path),
                         f"{os.path.basename(src)}.{tag}.o")
            for src in _sources()]
    t0 = time.perf_counter()
    _run([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
          for src, obj in zip(_sources(), objs)])
    tmp = f"{path}.{tag}"
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    build_seconds = time.perf_counter() - t0
    stats.note("built", True)
    os.replace(tmp, path)
    for obj in objs:
        os.remove(obj)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. Once it is loaded a call
    takes no lock."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            with stats.span("load.kernels", built=False):
                lib = ctypes.CDLL(build())
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                lib.qz_cuda_error_string.argtypes = [ctypes.c_int]
                lib.qz_cuda_error_string.restype = ctypes.c_char_p
                lib.qz_bitonic_active_clusters.argtypes = [ctypes.c_int]
                lib.qz_bitonic_active_clusters.restype = ctypes.c_int
            _lib = lib
    return _lib
