"""The port's StreamCompressor and incremental XXH64 against the JAX
package's, on the CPU.

StreamCompressor(device="cpu") runs the device half's plain-torch twins
on each chunk's full blocks; the JAX package's StreamCompressor
(use_device=True) runs the Pallas kernels in interpret mode. Their
frames must be equal byte for byte and decode through stock libzstd,
one-shot and through its streaming decoder.
"""

import ctypes

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.runtime.stream import StreamCompressor as JaxStream
from qat_zstd_plugin_tpu_torch import StreamCompressor, native, oracle
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072


@pytest.mark.parametrize("pieces", [(0, 1, 40, 77777, 100003),
                                    (0, 31, 32, 33, 100003),
                                    (0, 100003)])
def test_xxh64_stream_equals_one_shot(pieces):
    data = np.random.default_rng(0).integers(0, 256, 100003, np.uint8)
    h = native.Xxh64Stream()
    for a, b in zip(pieces, pieces[1:]):
        h.update(data[a:b] if a % 2 else bytes(data[a:b]))
    assert h.digest() == native.xxh64(data)
    assert native.Xxh64Stream(seed=7).digest() == native.xxh64(b"", 7)


def _stream(sc, data: bytes, chunk: int) -> bytes:
    out = bytearray()
    for s in range(0, len(data), chunk):
        out += sc.compress(data[s:s + chunk])
    return bytes(out + sc.finish())


# level, batch, input bytes, chunk bytes: chunks of 2-3 full blocks leave
# each batch partly padded, and the input ends in a short tail block.
CASES = {"L1_batch8": (1, 8, 10 * BLOCK + 5000, 300000),
         "L3_batch4": (3, 4, 7 * BLOCK + 777, 3 * BLOCK + 11),
         "L1_empty": (1, 8, 0, 1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_frames_equal_reference(case):
    level, batch, nbytes, chunk = CASES[case]
    data = make_corpus(nbytes, seed=level)
    sc = StreamCompressor(level=level, batch=batch, device="cpu")
    got = _stream(sc, data, chunk)
    want = _stream(JaxStream(level=level, batch=batch, use_device=True),
                   data, chunk)
    assert got == want
    assert oracle.decompress(got, len(data)) == data
    assert sc.codec.device_blocks == nbytes // BLOCK
    assert sc.blocks_emitted == max(1, -(-nbytes // BLOCK))


def test_later_chunks_continue_the_repeat_offset_history(monkeypatch):
    """Only the stream's first chunk starts the frame's repeat-offset
    history. The second chunk here is one block of period 4, whose first
    match (offset 4) the spec's initial history would code as a repeat
    offset; coded so in the middle of a frame it decodes to wrong bytes."""
    data = make_corpus(BLOCK, seed=5) + b"wxyz" * (BLOCK // 4)

    def frame():
        return _stream(StreamCompressor(level=1, device="cpu"), data, BLOCK)

    f = frame()
    assert f == _stream(JaxStream(level=1, use_device=True), data, BLOCK)
    assert oracle.decompress(f, len(data)) == data
    bodies = GpuCodec.compress_bodies
    monkeypatch.setattr(GpuCodec, "compress_bodies",
                        lambda self, buf, frame_start: bodies(self, buf))
    assert not oracle.roundtrip_ok(frame(), data)


class _Buf(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _stream_decode(frame: bytes, n: int) -> bytes:
    """Stock libzstd's streaming decoder, which honours the frame's
    declared window."""
    lib = oracle._lib()
    lib.ZSTD_createDStream.restype = ctypes.c_void_p
    lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_Buf), ctypes.POINTER(_Buf)]
    ds = lib.ZSTD_createDStream()
    try:
        src = ctypes.create_string_buffer(frame, len(frame))
        dst = ctypes.create_string_buffer(n + 64)
        inb = _Buf(ctypes.cast(src, ctypes.c_void_p), len(frame), 0)
        outb = _Buf(ctypes.cast(dst, ctypes.c_void_p), n + 64, 0)
        while inb.pos < inb.size:
            r = lib.ZSTD_decompressStream(ds, ctypes.byref(outb),
                                          ctypes.byref(inb))
            assert not lib.ZSTD_isError(r), "streaming decode error"
            if r == 0:
                break
        return dst.raw[:outb.pos]
    finally:
        lib.ZSTD_freeDStream(ds)


def test_stream_window_covers_cross_block_offsets():
    """The header declares a window covering the cross-block offsets the
    blocks take (here about 400 KB back): an under-declared window decodes
    wrong bytes under a streaming decoder, which one-shot decoding
    masks."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, 400_000, np.uint8).tobytes()
    data = base * 2
    sc = StreamCompressor(level=3, device="cpu")
    f = sc.compress(data) + sc.finish()
    assert len(f) < 0.6 * len(data)  # the second copy was matched
    assert _stream_decode(f, len(data)) == data


@pytest.mark.parametrize("seed", range(20, 24))
def test_fuzz_stream_roundtrip(seed):
    """The twin of test_fuzz.py's stream fuzz on the port: adversarial
    chunks at a seeded level and 32 KiB blocks decode."""
    from test_fuzz import _gen
    rng = np.random.default_rng(seed)
    sc = StreamCompressor(level=int(rng.integers(1, 13)), block_size=32768,
                          device="cpu")
    chunks = [_gen(rng) for _ in range(int(rng.integers(1, 6)))]
    out = bytearray()
    for c in chunks:
        out += sc.compress(c)
    out += sc.finish()
    data = b"".join(chunks)
    assert oracle.decompress(bytes(out), len(data)) == data


def test_oracle_decodes_high_ratio_no_content_size_frames():
    """A stream frame has no content size; one beyond the decoder's first
    64x guess must still decode (the oracle grows its buffer)."""
    sc = StreamCompressor(level=1, device="cpu")
    data = b"\x00" * (8 << 20)
    f = sc.compress(data) + sc.finish()
    assert len(f) * 64 < len(data)
    assert oracle.decompress(f) == data
