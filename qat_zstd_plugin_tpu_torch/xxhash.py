"""Pure-NumPy XXH64: the zstd frame content checksum without the native
runtime.

Copy of qat_zstd_plugin_tpu.format.xxhash's `xxh64` (format/xxhash.py).
zstd's optional Content_Checksum field is the low 32 bits of
XXH64(content, 0) (RFC 8878 §3.1.1). The decoder (decoder.py) checks it
with this function, so decompress() without libzstd needs no g++ build
either. The bulk of the input is hashed as 4-lane NumPy vectors, the tail
one scalar at a time. tests/test_torch_decoder.py holds it against the
JAX package's and against native.xxh64.
"""

from __future__ import annotations

import numpy as np

_P1 = np.uint64(11400714785074694791)
_P2 = np.uint64(14029467366897019727)
_P3 = np.uint64(1609587929392839161)
_P4 = np.uint64(9650029242287828579)
_P5 = np.uint64(2870177450012600261)

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rotl(x: np.uint64, r: int) -> np.uint64:
    r = np.uint64(r)
    return ((x << r) | (x >> (np.uint64(64) - r))) & _M64


def _round(acc, lane):
    acc = (acc + lane * _P2) & _M64
    acc = _rotl(acc, 31)
    return (acc * _P1) & _M64


def _merge_round(acc, val):
    val = _round(np.uint64(0), val)
    acc = (acc ^ val) & _M64
    acc = (acc * _P1 + _P4) & _M64
    return acc


def xxh64(data: bytes | np.ndarray, seed: int = 0) -> int:
    buf = np.frombuffer(bytes(data) if not isinstance(data, np.ndarray)
                        else data.tobytes(), dtype=np.uint8)
    n = len(buf)
    seed = np.uint64(seed)
    with np.errstate(over="ignore"):
        if n >= 32:
            nstripes = n // 32
            lanes = buf[: nstripes * 32].view("<u8").reshape(nstripes, 4)
            acc = np.array(
                [seed + _P1 + _P2, seed + _P2, seed, seed - _P1],
                dtype=np.uint64)
            # Sequential over stripes (XXH64 accumulators carry), but the
            # multiply/rotate are on 4-lane vectors.
            for s in range(nstripes):
                acc = _round(acc, lanes[s])
            h = (_rotl(acc[0], 1) + _rotl(acc[1], 7)
                 + _rotl(acc[2], 12) + _rotl(acc[3], 18)) & _M64
            for i in range(4):
                h = _merge_round(h, acc[i])
            p = nstripes * 32
        else:
            h = (seed + _P5) & _M64
            p = 0
        h = (h + np.uint64(n)) & _M64
        while p + 8 <= n:
            k1 = _round(np.uint64(0), buf[p:p + 8].view("<u8")[0])
            h = (h ^ k1) & _M64
            h = (_rotl(h, 27) * _P1 + _P4) & _M64
            p += 8
        if p + 4 <= n:
            h = (h ^ (np.uint64(buf[p:p + 4].view("<u4")[0]) * _P1)) & _M64
            h = (_rotl(h, 23) * _P2 + _P3) & _M64
            p += 4
        while p < n:
            h = (h ^ (np.uint64(buf[p]) * _P5)) & _M64
            h = (_rotl(h, 11) * _P1) & _M64
            p += 1
        h = (h ^ (h >> np.uint64(33))) & _M64
        h = (h * _P2) & _M64
        h = (h ^ (h >> np.uint64(29))) & _M64
        h = (h * _P3) & _M64
        h = (h ^ (h >> np.uint64(32))) & _M64
    return int(h)
