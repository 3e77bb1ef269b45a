"""The plain reference against stock libzstd: frames stock libzstd makes
(repeat offsets across blocks, treeless literals, repeated tables) and
frames the program makes on the CPU are judged as libzstd decodes them."""

import ctypes
import ctypes.util

import numpy as np
import pytest

from portbench import reference as ref
from portbench.corpus import make_corpus
from portbench.traffic import rng_for

DATA = make_corpus(1_200_000, rng_for(11, "ref"))


def _libzstd():
    path = ctypes.util.find_library("zstd")
    if not path:
        pytest.skip("no libzstd on this machine")
    z = ctypes.CDLL(path)
    z.ZSTD_compress.restype = z.ZSTD_decompress.restype = ctypes.c_size_t
    z.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_int]
    z.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_void_p, ctypes.c_size_t]
    z.ZSTD_isError.argtypes = [ctypes.c_size_t]
    z.ZSTD_isError.restype = ctypes.c_uint
    return z


def stock_compress(data: bytes, level: int) -> bytes:
    z = _libzstd()
    dst = ctypes.create_string_buffer(len(data) + 65536)
    n = z.ZSTD_compress(dst, len(dst), data, len(data), level)
    assert not z.ZSTD_isError(n)
    return dst.raw[:n]


def stock_decodes(frame: bytes, data: bytes) -> bool:
    z = _libzstd()
    dst = ctypes.create_string_buffer(len(data) + 16)
    n = z.ZSTD_decompress(dst, len(dst), frame, len(frame))
    return not z.ZSTD_isError(n) and dst.raw[:n] == data


def test_xxh64_vectors():
    assert ref.xxh64(b"") == 0xEF46DB3751D8E999
    assert ref.xxh64(b"abc") == 0x44BC2CF5AD770999
    assert ref.xxh64(bytes(range(256)) * 3) == ref.xxh64(
        np.frombuffer(bytes(range(256)) * 3, np.uint8))


@pytest.mark.parametrize("level", [1, 3, 12, 19, -5])
def test_stock_frames(level):
    frame = stock_compress(DATA.tobytes(), level)
    assert stock_decodes(frame, DATA.tobytes())
    assert ref.frame_faults(frame, DATA) == []
    # Blocks read one by one (each its own 128 KiB where stock's layout
    # is that), leaning on earlier blocks where stock's do.
    info = ref.parse_frame(frame)
    if len(info.blocks) == -(-len(DATA) // 131072):
        for k in range(len(info.blocks)):
            ref.check_block(frame, info, k, DATA, 131072)


@pytest.mark.parametrize("at", [0.1, 0.5, 0.9, 0.999])
def test_mutated_stock_frames_agree_with_stock(at):
    frame = bytearray(stock_compress(DATA.tobytes(), 3))
    frame[int(len(frame) * at)] ^= 0x24
    frame = bytes(frame)
    assert (ref.frame_faults(frame, DATA) == []) == \
        stock_decodes(frame, DATA.tobytes())


def test_wrong_input_is_caught():
    frame = stock_compress(DATA.tobytes(), 1)
    other = DATA.copy()
    other[700_000] ^= 1
    assert ref.frame_faults(frame, other) != []


@pytest.mark.parametrize("kw", [{"level": 1},
                                {"level": 9, "device_entropy": "hybrid"}])
def test_program_frames_on_the_cpu(kw):
    import qat_zstd_plugin_tpu_torch as qzt
    frame = qzt.compress(DATA.tobytes(), batch=4, device="cpu", **kw)
    assert stock_decodes(frame, DATA.tobytes())
    assert ref.frame_faults(frame, DATA) == []
    info, faults = ref.layout_faults(frame, DATA, 131072, True)
    assert faults == []
    for k in range(len(info.blocks)):
        ref.check_block(frame, info, k, DATA, 131072)
    assert ref.checksum_ok(info, DATA)
    _, faults = ref.layout_faults(frame, DATA, 65536, True)
    assert faults  # another block layout than the configuration's
