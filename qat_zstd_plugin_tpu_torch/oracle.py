"""ctypes over stock libzstd: the port's bit-exactness oracle.

Copy of `available()` and `decompress()` from qat_zstd_plugin_tpu.oracle.
Every frame the port writes must decode bit-exactly through the system
libzstd. The compression path never calls it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache


class ZstdOracleError(RuntimeError):
    pass


@lru_cache(maxsize=1)
def _lib():
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise ZstdOracleError(f"stock libzstd not found: {e}") from e
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except ZstdOracleError:
        return False


def decompress(frame: bytes, expected_size: int | None = None) -> bytes:
    """Decode a zstd frame with stock libzstd. Raises on any decode error,
    and when libzstd is missing."""
    lib = _lib()
    if expected_size is None:
        sz = lib.ZSTD_getFrameContentSize(frame, len(frame))
        # ZSTD_CONTENTSIZE_UNKNOWN == -1, _ERROR == -2 (as unsigned)
        if sz >= 2**64 - 2:
            cap = max(1 << 16, len(frame) * 64)
        else:
            cap = int(sz)
    else:
        cap = expected_size
    # Unknown-content-size frames need a growing guess buffer: retry on
    # dstSize_tooSmall up to 1 GiB.
    while True:
        dst = ctypes.create_string_buffer(max(cap, 1))
        ret = lib.ZSTD_decompress(dst, cap, frame, len(frame))
        if not lib.ZSTD_isError(ret):
            return dst.raw[:ret]
        name = lib.ZSTD_getErrorName(ret).decode()
        if "too small" in name and cap < (1 << 30) \
                and expected_size is None:
            cap *= 8
            continue
        raise ZstdOracleError(f"oracle decode failed: {name}")
