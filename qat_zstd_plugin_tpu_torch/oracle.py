"""ctypes over stock libzstd: the port's bit-exactness oracle and the
libzstd half of its sequence-producer route.

Copy of qat_zstd_plugin_tpu.oracle: `available`, `version`,
`decompress`, `compress` and `roundtrip_ok`; the producer registration
(`ZstdSequence`, `SEQPROD_CFUNC`, the `ZSTD_*` constants,
`compress_with_producer` and `last_producer_stats`); the streaming
compressor with a producer (`ZstdInBuffer`, `ZstdOutBuffer`,
`compress_stream_with_producer`); and the dictionary pair
(`compress_with_producer_and_dict`, `decompress_with_dict`). Every frame
the port writes must decode bit-exactly through the system libzstd; the
port's own compress() never calls it. The producer route needs libzstd
>= 1.5.4 (ZSTD_registerSequenceProducer).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
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
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_int]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except ZstdOracleError:
        return False


def version() -> int:
    """libzstd version number, e.g. 10504 == 1.5.4."""
    return _lib().ZSTD_versionNumber()


def has_sequence_producer() -> bool:
    """Whether this libzstd exports ZSTD_registerSequenceProducer (1.5.4
    and later), which the producer route needs."""
    return hasattr(_lib(), "ZSTD_registerSequenceProducer")


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


def compress(data: bytes, level: int = 1) -> bytes:
    """Stock-libzstd compression: the software baseline."""
    lib = _lib()
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    ret = lib.ZSTD_compress(dst, cap, data, len(data), level)
    if lib.ZSTD_isError(ret):
        raise ZstdOracleError(
            f"oracle compress failed: {lib.ZSTD_getErrorName(ret).decode()}")
    return dst.raw[:ret]


def roundtrip_ok(frame: bytes, original: bytes) -> bool:
    """True iff stock zstd decodes `frame` bit-exactly to `original`."""
    try:
        return decompress(frame, len(original)) == original
    except ZstdOracleError:
        return False


# ---------------------------------------------------------------------------
# Sequence-producer registration: ZSTD_registerSequenceProducer, then
# ZSTD_compress2 or ZSTD_compressStream2 calls the producer once a block.

class ZstdSequence(ctypes.Structure):
    """ZSTD_Sequence (zstd.h): 4 x u32."""
    _fields_ = [("offset", ctypes.c_uint32),
                ("litLength", ctypes.c_uint32),
                ("matchLength", ctypes.c_uint32),
                ("rep", ctypes.c_uint32)]


# size_t (void* state, ZSTD_Sequence* out, size_t cap, const void* src,
#         size_t srcSize, const void* dict, size_t dictSize, int level,
#         size_t windowSize)
SEQPROD_CFUNC = ctypes.CFUNCTYPE(
    ctypes.c_size_t, ctypes.c_void_p, ctypes.POINTER(ZstdSequence),
    ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
    ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t)

ZSTD_SEQUENCE_PRODUCER_ERROR = ctypes.c_size_t(-1).value

ZSTD_c_compressionLevel = 100
ZSTD_c_enableSeqProducerFallback = 1014   # experimentalParam17
ZSTD_c_searchForExternalRepcodes = 1016   # experimentalParam19
ZSTD_ps_enable = 1


@lru_cache(maxsize=1)
def _cctx_lib():
    lib = _lib()
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t]
    lib.ZSTD_registerSequenceProducer.restype = None
    lib.ZSTD_registerSequenceProducer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, SEQPROD_CFUNC]
    return lib


def _producer_callback(produce, calls: dict):
    """The C callback around `produce`: a dictionary, an error (None), more
    triples than libzstd's capacity or an exception return the producer
    error, counted in calls["errors"]; a block's triples are copied into
    libzstd's array, counted in calls["blocks"]."""

    @SEQPROD_CFUNC
    def cb(_state, out_seqs, cap, src, src_size, _dict, dict_size, clevel,
           wsize):
        try:
            if dict_size:  # dictionaries are not supported by a producer
                calls["errors"] += 1
                return ZSTD_SEQUENCE_PRODUCER_ERROR
            block = ctypes.string_at(src, src_size)
            seqs = produce(block, clevel, wsize)
            if seqs is None or len(seqs) > cap:
                calls["errors"] += 1
                return ZSTD_SEQUENCE_PRODUCER_ERROR
            for i, (off, lit, ml) in enumerate(seqs):
                out_seqs[i] = ZstdSequence(off, lit, ml, 0)
            calls["blocks"] += 1
            return len(seqs)
        except Exception:
            calls["errors"] += 1
            return ZSTD_SEQUENCE_PRODUCER_ERROR

    return cb


def _set_parameters(lib, cctx, level: int, fallback: bool,
                    search_repcodes: bool | None) -> None:
    params = [(ZSTD_c_compressionLevel, level),
              (ZSTD_c_enableSeqProducerFallback, int(fallback))]
    if search_repcodes is not None:
        params.append((ZSTD_c_searchForExternalRepcodes,
                       ZSTD_ps_enable if search_repcodes else 0))
    for param, val in params:
        r = lib.ZSTD_CCtx_setParameter(cctx, param, val)
        if lib.ZSTD_isError(r):
            raise ZstdOracleError(
                f"setParameter({param}) failed: "
                f"{lib.ZSTD_getErrorName(r).decode()}")


def compress_with_producer(data: bytes, produce, level: int = 1,
                           fallback: bool = True,
                           search_repcodes: bool = False) -> bytes:
    """ZSTD_compress2 with `produce` registered as the external sequence
    producer: register, enable fallback, compress2.

    produce(block: bytes, level: int, window_size: int) must return a list
    of (offset, lit_length, match_length) triples covering the block (final
    entry literals-only: offset == match_length == 0), or None for
    producer-error (libzstd then matches the block itself when
    `fallback`).
    """
    lib = _cctx_lib()
    calls = {"blocks": 0, "errors": 0}
    cb = _producer_callback(produce, calls)
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise ZstdOracleError("ZSTD_createCCtx failed")
    try:
        _set_parameters(lib, cctx, level, fallback, search_repcodes)
        lib.ZSTD_registerSequenceProducer(cctx, None, cb)
        cap = lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(cap)
        ret = lib.ZSTD_compress2(cctx, dst, cap, data, len(data))
        if lib.ZSTD_isError(ret):
            raise ZstdOracleError(
                f"compress2 failed: {lib.ZSTD_getErrorName(ret).decode()}")
        out = dst.raw[:ret]
    finally:
        lib.ZSTD_freeCCtx(cctx)
    # Per-thread stats (concurrent callers must not clobber each other);
    # the function attribute remains for single-threaded callers.
    _producer_tls.stats = calls
    compress_with_producer.last_stats = calls
    return out


_producer_tls = threading.local()


def last_producer_stats() -> dict | None:
    """Stats of this thread's most recent producer-driven compression."""
    return getattr(_producer_tls, "stats", None)


# ---------------------------------------------------------------------------
# Streaming compression (ZSTD_compressStream2) with the producer registered:
# chunked input pumps, optional explicit flush points, the producer called
# per block, as the zstd command line drives it.

class ZstdInBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class ZstdOutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


ZSTD_e_continue, ZSTD_e_flush, ZSTD_e_end = 0, 1, 2


@lru_cache(maxsize=1)
def _stream_lib():
    lib = _cctx_lib()
    lib.ZSTD_compressStream2.restype = ctypes.c_size_t
    lib.ZSTD_compressStream2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ZstdOutBuffer),
        ctypes.POINTER(ZstdInBuffer), ctypes.c_int]
    lib.ZSTD_CCtx_loadDictionary.restype = ctypes.c_size_t
    lib.ZSTD_CCtx_loadDictionary.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    return lib


def compress_stream_with_producer(data: bytes, produce, level: int = 1,
                                  fallback: bool = True,
                                  chunk_size: int = 64 << 10,
                                  flush_every: int = 0,
                                  search_repcodes: bool = False) -> bytes:
    """ZSTD_compressStream2 with `produce` registered as the external
    sequence producer: `data` is pumped in `chunk_size` pieces with
    ZSTD_e_continue, an explicit ZSTD_e_flush every `flush_every` chunks
    (0 = never), and a final ZSTD_e_end, so that blocks see partial
    windows and flush-forced block boundaries.

    `produce` has the same contract as compress_with_producer's; pass
    None to stream without a producer (stock baseline).
    """
    lib = _stream_lib()
    calls = {"blocks": 0, "errors": 0}
    cb = _producer_callback(produce, calls)
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise ZstdOracleError("ZSTD_createCCtx failed")
    out = bytearray()
    try:
        _set_parameters(lib, cctx, level, fallback, search_repcodes)
        if produce is not None:
            lib.ZSTD_registerSequenceProducer(cctx, None, cb)
        obuf_cap = 1 << 17
        obuf = ctypes.create_string_buffer(obuf_cap)

        def pump(inb, mode) -> None:
            while True:
                ob = ZstdOutBuffer(ctypes.cast(obuf, ctypes.c_void_p),
                                   obuf_cap, 0)
                ret = lib.ZSTD_compressStream2(cctx, ctypes.byref(ob),
                                               ctypes.byref(inb), mode)
                if lib.ZSTD_isError(ret):
                    raise ZstdOracleError(
                        "compressStream2 failed: "
                        f"{lib.ZSTD_getErrorName(ret).decode()}")
                out.extend(obuf.raw[:ob.pos])
                if mode == ZSTD_e_continue:
                    if inb.pos == inb.size:
                        return
                elif ret == 0:  # flush/end complete
                    return

        nchunks = 0
        view = memoryview(data)
        holders = []  # keep chunk buffers alive across the pump
        for s in range(0, max(len(data), 1), chunk_size):
            chunk = bytes(view[s:s + chunk_size])
            holders.append(chunk)
            inb = ZstdInBuffer(
                ctypes.cast(ctypes.c_char_p(chunk), ctypes.c_void_p),
                len(chunk), 0)
            pump(inb, ZSTD_e_continue)
            nchunks += 1
            if flush_every and nchunks % flush_every == 0:
                pump(ZstdInBuffer(None, 0, 0), ZSTD_e_flush)
        pump(ZstdInBuffer(None, 0, 0), ZSTD_e_end)
    finally:
        lib.ZSTD_freeCCtx(cctx)
    _producer_tls.stats = calls
    compress_stream_with_producer.last_stats = calls
    return bytes(out)


def compress_with_producer_and_dict(data: bytes, produce, dictionary: bytes,
                                    level: int = 1,
                                    fallback: bool = True) -> bytes:
    """ZSTD_compress2 with BOTH a loaded dictionary and a registered
    producer that refuses every block, as the reference's producer does
    when it is handed a dictionary (libzstd then matches the blocks
    itself). Raises ZstdOracleError if libzstd itself rejects the
    combination."""
    lib = _stream_lib()
    calls = {"blocks": 0, "errors": 0}

    @SEQPROD_CFUNC
    def cb(_state, out_seqs, cap, src, src_size, _dict, dict_size, clevel,
           wsize):
        calls["errors"] += 1
        return ZSTD_SEQUENCE_PRODUCER_ERROR

    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise ZstdOracleError("ZSTD_createCCtx failed")
    try:
        _set_parameters(lib, cctx, level, fallback, None)
        r = lib.ZSTD_CCtx_loadDictionary(cctx, dictionary, len(dictionary))
        if lib.ZSTD_isError(r):
            raise ZstdOracleError(
                f"loadDictionary failed: "
                f"{lib.ZSTD_getErrorName(r).decode()}")
        lib.ZSTD_registerSequenceProducer(cctx, None, cb)
        cap = lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(cap)
        ret = lib.ZSTD_compress2(cctx, dst, cap, data, len(data))
        if lib.ZSTD_isError(ret):
            raise ZstdOracleError(
                f"compress2 failed: {lib.ZSTD_getErrorName(ret).decode()}")
        out = dst.raw[:ret]
    finally:
        lib.ZSTD_freeCCtx(cctx)
    _producer_tls.stats = calls
    return out


def decompress_with_dict(frame: bytes, dictionary: bytes,
                         expected_size: int) -> bytes:
    """DCtx decode with a loaded dictionary (for dict-mode round-trips)."""
    lib = _stream_lib()
    lib.ZSTD_createDCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_DCtx_loadDictionary.restype = ctypes.c_size_t
    lib.ZSTD_DCtx_loadDictionary.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_decompressDCtx.restype = ctypes.c_size_t
    lib.ZSTD_decompressDCtx.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t]
    dctx = lib.ZSTD_createDCtx()
    try:
        r = lib.ZSTD_DCtx_loadDictionary(dctx, dictionary, len(dictionary))
        if lib.ZSTD_isError(r):
            raise ZstdOracleError("DCtx loadDictionary failed")
        dst = ctypes.create_string_buffer(max(expected_size, 1))
        ret = lib.ZSTD_decompressDCtx(dctx, dst, expected_size, frame,
                                      len(frame))
        if lib.ZSTD_isError(ret):
            raise ZstdOracleError(
                f"decompressDCtx failed: "
                f"{lib.ZSTD_getErrorName(ret).decode()}")
        return dst.raw[:ret]
    finally:
        lib.ZSTD_freeDCtx(dctx)
