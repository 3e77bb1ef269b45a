"""The port's native host runtime: ctypes over its own build of qz_entropy.cc.

Copy of qat_zstd_plugin_tpu.native, restricted to the entry points the
port calls (xxh64, Xxh64Stream, block_body, block_body_external_seqsec,
extend_sequences, fill_gaps, find_sequences, find_sequences_hinted,
compress_blocks_mt for the software codec of tools/, and dec_lz4s, the
reference's LZ4s decoder).
`qz_entropy.cc` here is a byte-for-byte copy of the JAX package's
source; the differences are in the build:

  * it is compiled at first use with g++ and the flags of the JAX
    package's native/build.sh into build/torch_native/<key>/ beside the
    package, where <key> hashes the source, the flags and the host CPU
    (its model name and feature flags from /proc/cpuinfo), so a library
    built with -march=native on another CPU is never loaded;
  * one process builds while the others wait on a file lock beside the
    library, and the library is written to a temporary name and renamed
    into place, so no process loads a half-written file;
  * without g++, or when the build fails, load() raises: the port never
    goes on without its host runtime.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..runtime import stats

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "qz_entropy.cc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "torch_native")
LIB_NAME = "libqz_entropy.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-DNDEBUG", "-std=c++17", "-shared",
             "-fPIC", "-fstack-protector-strong", "-fwrapv")
LINK_FLAGS = ("-lpthread",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _S, _I, _U32 = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                    ctypes.c_uint32)
_SIGNATURES = {  # name: (restype, argtypes)
    "qz_xxh64": (ctypes.c_uint64, (_P, _S, ctypes.c_uint64)),
    "qz_xxh64_state_size": (_S, ()),
    "qz_xxh64_init": (None, (_P, ctypes.c_uint64)),
    "qz_xxh64_update": (None, (_P, _P, _S)),
    "qz_xxh64_digest": (ctypes.c_uint64, (_P,)),
    "qz_block_body": (_S, (_P, _S, _P, _P, _P, _S, _U32, _I, _I, _I, _P,
                           _S)),
    "qz_block_body_external_seqsec": (_S, (_P, _S, _P, _P, _S, _U32,
                                           ctypes.c_char_p, _S, _I, _P,
                                           _S)),
    "qz_find_sequences": (_S, (_P, _S, _S, _I, _I, _I, _P, _P, _P, _S,
                               _P)),
    "qz_find_sequences_hinted": (_S, (_P, _S, _S, _I, _I, _I, _P, _P, _P,
                                      _S, _P, _P, _P, _S, _P)),
    "qz_extend_sequences": (_S, (_P, _S, _S, _P, _P, _P, _S, _P, _S)),
    "qz_fill_gaps": (_S, (_P, _S, _S, _P, _P, _P, _S, _P, _S, _I, _I, _I,
                          _I)),
    "qz_compress_blocks_mt": (None, (_P, _S, _S, _I, _I, _I, _I, _I, _I, _I,
                                     _I, _P, _P)),
    "qz_dec_lz4s": (_S, (_P, _S, _P, _P, _P, _S)),
}
_FAIL = ctypes.c_size_t(-1).value


def _cpu_id() -> bytes:
    """The host CPU's model name and feature flags (what -march=native
    compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(sorted(set(keep))) or os.uname().machine.encode()


def library_path(src: str = SRC) -> str:
    """Where the library for `src`, the flags and this CPU goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode() + b"\0")
    h.update(_cpu_id() + b"\0")
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def build() -> str:
    """Compile qz_entropy.cc unless the library for this source, these
    flags and this CPU exists; returns its path. Processes that need it
    at once (test workers) take a file lock beside it, so one of them
    builds and the others wait and load its library."""
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
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [CXX, *CXX_FLAGS, SRC, "-o", tmp, *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError(f"native host runtime: {CXX} not found; the "
                           "port cannot run without it") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native host runtime: build failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    stats.note("built", True)


def load() -> ctypes.CDLL:
    """The host runtime, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            with stats.span("load.native", built=False):
                lib = ctypes.CDLL(build())
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = list(argtypes)
            _lib = lib
    return _lib


def xxh64(data, seed: int = 0) -> int:
    """XXH64 over bytes or a uint8 numpy array (zero-copy for arrays)."""
    lib = load()
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data, np.uint8)
        return int(lib.qz_xxh64(arr.ctypes.data, arr.size, seed))
    return int(lib.qz_xxh64(data, len(data), seed))


class Xxh64Stream:
    """Incremental XXH64 over the native runtime (copy of
    qat_zstd_plugin_tpu.native.Xxh64Stream): update() in pieces of any
    size, digest() equals xxh64() of their concatenation."""

    def __init__(self, seed: int = 0):
        self._lib = load()
        self._state = ctypes.create_string_buffer(
            self._lib.qz_xxh64_state_size())
        self._lib.qz_xxh64_init(self._state, seed)

    def update(self, data) -> None:
        if isinstance(data, np.ndarray):
            arr = np.ascontiguousarray(data, np.uint8)
            self._lib.qz_xxh64_update(self._state, arr.ctypes.data, arr.size)
        else:
            self._lib.qz_xxh64_update(self._state, data, len(data))

    def digest(self) -> int:
        return int(self._lib.qz_xxh64_digest(self._state))


def block_body(block: np.ndarray, lit_lens: np.ndarray, offsets: np.ndarray,
               match_lens: np.ndarray, last_literals: int,
               allow_custom: bool = True, try_huffman: bool = True,
               first_block: bool = False) -> bytes | None:
    """Compressed block body from sequences; None -> caller emits raw."""
    lib = load()
    block = np.ascontiguousarray(block, np.uint8)
    ll = np.ascontiguousarray(lit_lens, np.uint32)
    of = np.ascontiguousarray(offsets, np.uint32)
    ml = np.ascontiguousarray(match_lens, np.uint32)
    cap = len(block) + 512
    dst = np.empty(cap, np.uint8)
    n = lib.qz_block_body(
        block.ctypes.data, len(block), ll.ctypes.data, of.ctypes.data,
        ml.ctypes.data, len(ll), last_literals, int(allow_custom),
        int(try_huffman), int(first_block), dst.ctypes.data, cap)
    if n == 0:
        return None
    return dst[:n].tobytes()


def block_body_external_seqsec(block: np.ndarray, lit_lens: np.ndarray,
                               match_lens: np.ndarray, last_literals: int,
                               seq_section: bytes,
                               try_huffman: bool = True) -> bytes | None:
    """Body = host literals section + a finished Sequences_Section (the
    device's, in hybrid device entropy); None -> caller emits raw."""
    lib = load()
    block = np.ascontiguousarray(block, np.uint8)
    ll = np.ascontiguousarray(lit_lens, np.uint32)
    ml = np.ascontiguousarray(match_lens, np.uint32)
    cap = len(block) + 512 + len(seq_section)
    dst = np.empty(cap, np.uint8)
    n = lib.qz_block_body_external_seqsec(
        block.ctypes.data, len(block), ll.ctypes.data, ml.ctypes.data,
        len(ll), last_literals, seq_section, len(seq_section),
        int(try_huffman), dst.ctypes.data, cap)
    if n == 0:
        return None
    return dst[:n].tobytes()


def find_sequences_hinted(block: np.ndarray, chain_depth: int, lazy: bool,
                          hint_pos: np.ndarray, hint_len: np.ndarray,
                          hint_off: np.ndarray,
                          cap: int | None = None, ctx_len: int = 0,
                          mml: int = 4):
    """Chain matcher with device-candidate hints competing inside the
    parse (see qz_find_sequences_hinted). hint_pos is block-relative
    ascending match starts, hint_len the claim spans, hint_off the
    device's source distances. Returns (lit, off, ml, last_literals)."""
    lib = load()
    block = np.ascontiguousarray(block, np.uint8)
    hp = np.ascontiguousarray(hint_pos, np.uint32)
    hl = np.ascontiguousarray(hint_len, np.uint32)
    ho = np.ascontiguousarray(hint_off, np.uint32)
    n = len(block) - ctx_len
    if cap is None:
        cap = max(16, n // 3 + 2)
    ll = np.empty(cap, np.uint32)
    of = np.empty(cap, np.uint32)
    ml = np.empty(cap, np.uint32)
    lastlit = ctypes.c_uint32(0)
    got = lib.qz_find_sequences_hinted(
        block.ctypes.data, ctx_len, n, chain_depth, int(lazy), mml,
        hp.ctypes.data, hl.ctypes.data, ho.ctypes.data, len(hp),
        ll.ctypes.data, of.ctypes.data, ml.ctypes.data, cap,
        ctypes.byref(lastlit))
    if got == _FAIL:
        raise OverflowError("sequence capacity exceeded")
    return (ll[:got].astype(np.int64), of[:got].astype(np.int64),
            ml[:got].astype(np.int64), int(lastlit.value))


def extend_sequences(block: np.ndarray, lit: np.ndarray, off: np.ndarray,
                     ml: np.ndarray, last_literals: int,
                     ctx_len: int = 0, max_off: int = 0):
    """Re-extend capped matches with real byte compares (see
    qz_extend_sequences). `block` may carry ctx_len bytes of window
    context at the front; the sequences cover only the trailing block.
    max_off caps offsets the slide probe may synthesize (the frame
    window; 0 = unlimited). Returns (lit, off, ml, last_literals)."""
    lib = load()
    block = np.ascontiguousarray(block, np.uint8)
    ll = np.ascontiguousarray(lit, np.uint32)
    of = np.ascontiguousarray(off, np.uint32)
    mm = np.ascontiguousarray(ml, np.uint32)
    lastlit = ctypes.c_uint32(last_literals)
    # The C pass only shrinks/merges; arrays are modified in place.
    new_n = lib.qz_extend_sequences(
        block.ctypes.data, ctx_len, len(block) - ctx_len, ll.ctypes.data,
        of.ctypes.data, mm.ctypes.data, len(ll), ctypes.byref(lastlit),
        max_off)
    return (ll[:new_n].astype(np.int64), of[:new_n].astype(np.int64),
            mm[:new_n].astype(np.int64), int(lastlit.value))


def fill_gaps(block: np.ndarray, lit: np.ndarray, off: np.ndarray,
              ml: np.ndarray, last_literals: int, ctx_len: int = 0,
              chain_depth: int = 8, mml: int = 6, min_gap: int = 32,
              relaxed: bool = False):
    """Re-match long literal runs against the cross-block window context
    (see qz_fill_gaps). `block` = ctx_len context bytes + the block.
    relaxed=True swaps in the extension walk's cost model (the hash
    levels). Returns (lit, off, ml, last_literals)."""
    lib = load()
    block = np.ascontiguousarray(block, np.uint8)
    n = len(block) - ctx_len
    cap = max(64, len(lit) + n // 8 + 8)
    ll = np.zeros(cap, np.uint32)
    of = np.zeros(cap, np.uint32)
    mm = np.zeros(cap, np.uint32)
    ll[:len(lit)] = lit
    of[:len(off)] = off
    mm[:len(ml)] = ml
    lastlit = ctypes.c_uint32(last_literals)
    new_n = lib.qz_fill_gaps(
        block.ctypes.data, ctx_len, n, ll.ctypes.data, of.ctypes.data,
        mm.ctypes.data, len(lit), ctypes.byref(lastlit), cap, chain_depth,
        mml, min_gap, int(relaxed))
    if new_n == _FAIL:
        return (np.asarray(lit), np.asarray(off), np.asarray(ml),
                last_literals)  # overflow: keep the original parse
    return (ll[:new_n].astype(np.int64), of[:new_n].astype(np.int64),
            mm[:new_n].astype(np.int64), int(lastlit.value))


def dec_lz4s(stream: bytes | np.ndarray, capacity: int | None = None):
    """Decode an LZ4s token stream into (lit, off, ml) arrays: qz_dec_lz4s,
    the native counterpart of the reference's QZSTD_decLz4s
    (src/qatseqprod.c:1013-1091), whose contract lz4s_format.py pins.
    Raises ValueError on a malformed stream or more than `capacity`
    sequences (default: the stream's length + 16)."""
    lib = load()
    arr = (np.ascontiguousarray(stream, np.uint8)
           if isinstance(stream, np.ndarray)
           else np.frombuffer(stream, np.uint8))
    n = len(arr)
    cap = capacity if capacity is not None else n + 16
    ll = np.empty(cap, np.uint32)
    of = np.empty(cap, np.uint32)
    ml = np.empty(cap, np.uint32)
    got = lib.qz_dec_lz4s(arr.ctypes.data, n, ll.ctypes.data,
                          of.ctypes.data, ml.ctypes.data, cap)
    if got == _FAIL:
        raise ValueError("malformed LZ4s stream or capacity exceeded")
    return (ll[:got].astype(np.int64), of[:got].astype(np.int64),
            ml[:got].astype(np.int64))


def find_sequences(block: np.ndarray, chain_depth: int, lazy: bool,
                   cap: int | None = None, ctx_len: int = 0,
                   mml: int = 4):
    """Native hash-chain matcher. `block` = ctx_len context bytes + the
    block itself; matches may reference the context (cross-block window).
    Returns (lit, off, ml, last_literals) covering the block only."""
    lib = load()
    block = np.ascontiguousarray(block, np.uint8)
    n = len(block) - ctx_len
    if cap is None:
        cap = max(16, n // 3 + 2)
    ll = np.empty(cap, np.uint32)
    of = np.empty(cap, np.uint32)
    ml = np.empty(cap, np.uint32)
    lastlit = ctypes.c_uint32(0)
    got = lib.qz_find_sequences(
        block.ctypes.data, ctx_len, n, chain_depth, int(lazy), mml,
        ll.ctypes.data, of.ctypes.data, ml.ctypes.data, cap,
        ctypes.byref(lastlit))
    if got == _FAIL:
        raise OverflowError("sequence capacity exceeded")
    return (ll[:got].astype(np.int64), of[:got].astype(np.int64),
            ml[:got].astype(np.int64), int(lastlit.value))


def compress_blocks_mt(buf: np.ndarray, block_size: int, chain_depth: int,
                       lazy: bool, allow_custom: bool = True,
                       try_huffman: bool = True, window_log: int = 0,
                       mml: int = 4, nthreads: int = 0,
                       frame_start: bool = True) -> list[bytes | None]:
    """Match + extend + entropy for every block of `buf` in one native
    call with an internal thread pool (the software codec). None entries
    => emit raw. window_log > 0 enables cross-block window context
    (offsets reach back up to 1 << window_log into earlier blocks' raw
    bytes). The bodies do not depend on nthreads (0: one a CPU)."""
    lib = load()
    buf = np.ascontiguousarray(buf, np.uint8)
    n = len(buf)
    nblocks = max(1, -(-n // block_size))
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    arena = np.empty(nblocks * block_size, np.uint8)
    sizes = np.zeros(nblocks, np.uint32)
    lib.qz_compress_blocks_mt(
        buf.ctypes.data, n, block_size, chain_depth, int(lazy), mml,
        int(allow_custom), int(try_huffman), window_log, nthreads,
        int(frame_start), arena.ctypes.data, sizes.ctypes.data)
    return [arena[i * block_size:i * block_size + int(sz)].tobytes()
            if sz else None for i, sz in enumerate(sizes)]
