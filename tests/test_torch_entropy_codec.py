"""The port's device-entropy frames against the JAX package's, on the CPU.

GpuCodec(device_entropy="hybrid", device="cpu") runs the kernels'
plain-torch twins and encodes each block's FSE Sequences_Section in torch;
TpuCodec(device_entropy="hybrid") runs the Pallas kernels in interpret
mode. The host adds the literals section in both through the same native
source, so the frames must be equal byte for byte at the same level,
batch size and max_seq, and stock libzstd must decode them. With
device_entropy=True (full) both also encode the Huffman literals on the
device and the host only wraps the sections. The exceptions are the
reference's two faults, where its frame is corrupt and the port's is not:
B12's fill (test_reference_fault_frame*) and B15's 16384-position window
(test_reference_window_fault_frame).
"""

import functools

import numpy as np
import pytest

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu_torch import GpuCodec, compress
from qat_zstd_plugin_tpu_torch.corpus import make_corpus

BLOCK = 131072
WINDOW = 32768

CASES = {  # level, full blocks, tail bytes, batch, max_seq
    "L1_8_blocks_tail_batch4": (1, 8, 5000, 4, 16384),
    "L4_4_blocks_tail_batch4": (4, 4, 5000, 4, 16384),
    "L5_4_blocks_batch4": (5, 4, 0, 4, 16384),
    "L12_4_blocks_batch4": (12, 4, 0, 4, 16384),
    "L9_max_seq_1024_overflow": (9, 4, 0, 4, 1024),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_frames_equal_tpu_codec(case):
    """Equal frames; every full block went through the device half, and
    each was either re-matched on the host (a compaction or section
    overflow, counted in overflow_blocks), encoded with the device's
    section, or a block of no sequences. With max_seq 1024 every block
    overflows and both codecs re-match it."""
    level, nfull, tail, batch, max_seq = CASES[case]
    data = make_corpus(nfull * BLOCK + tail, level)
    want = TpuCodec(level=level, batch=batch, max_seq=max_seq,
                    device_entropy="hybrid").compress(data)
    codec = GpuCodec(level=level, batch=batch, max_seq=max_seq,
                     device="cpu", device_entropy="hybrid")
    got = codec.compress(data)
    assert got == want
    assert oracle.decompress(got, len(data)) == data
    assert codec.device_blocks == nfull
    assert codec.stats.fallback_blocks == 0
    assert codec.section_blocks + codec.overflow_blocks <= nfull
    if max_seq < 16384:
        assert codec.overflow_blocks == nfull
    else:
        assert codec.section_blocks > 0


def test_compress_entry_point_hybrid():
    """compress(device_entropy="hybrid") is GpuCodec's hybrid frame, not
    the host-entropy one."""
    data = make_corpus(2 * BLOCK + 777, 21)
    hybrid = compress(data, level=5, batch=4, device="cpu",
                      device_entropy="hybrid")
    assert hybrid == GpuCodec(level=5, batch=4, device="cpu",
                              device_entropy="hybrid").compress(data)
    assert hybrid != compress(data, level=5, batch=4, device="cpu")
    assert oracle.decompress(hybrid, len(data)) == data


@pytest.mark.parametrize("value", [True, "full", 1])
def test_full_device_entropy_accepted(value):
    """True, "full" and 1 are full device entropy, as in the reference,
    and give the same frame, which is not the hybrid one (level 5: its
    blocks carry the device's literals)."""
    codec = GpuCodec(level=5, batch=2, device="cpu", device_entropy=value)
    assert codec.device_entropy is True
    data = make_corpus(2 * BLOCK + 999, 3)
    frame = codec.compress(data)
    assert codec.literal_blocks > 0
    assert frame == _l5_frame(True)
    assert frame != _l5_frame("hybrid")
    assert oracle.decompress(frame, len(data)) == data


@functools.lru_cache
def _l5_frame(device_entropy) -> bytes:
    return compress(make_corpus(2 * BLOCK + 999, 3), level=5, batch=2,
                    device="cpu", device_entropy=device_entropy)


@pytest.mark.parametrize("value", ["bogus", 2, "Hybrid", None])
def test_bad_device_entropy_raises(value):
    with pytest.raises(ValueError, match="device_entropy"):
        GpuCodec(level=1, device="cpu", device_entropy=value)


@pytest.mark.parametrize("value", [False, 0, "hybrid"])
def test_accepted_device_entropy(value):
    codec = GpuCodec(level=3, device="cpu", device_entropy=value)
    assert codec.device_entropy == ("hybrid" if value == "hybrid" else False)


def fault_data() -> bytes:
    """Two 64 KiB blocks. Block 0's first segment holds exactly one gram
    below 0xFFFFFFFF (a non-0xFF first byte, 0xFF to the segment's end and
    for the next segment's first three bytes), where the reference's B12
    claims a false match at position 1."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, 2 * 65536, np.uint8)
    x[0] = 0x00
    x[1:WINDOW + 3] = 0xFF
    return x.tobytes()


def test_reference_fault_frame():
    """The port's hybrid frame decodes bit-exactly. The last assertion
    records the JAX package's fault (its B12 reads a missing neighbour as
    a matching gram at position 0): TpuCodec's hybrid frame does not
    decode. Change it if that package is ever repaired."""
    data = fault_data()
    kw = dict(level=1, batch=2, block_size=65536, max_seq=8192)
    codec = GpuCodec(device="cpu", device_entropy="hybrid", **kw)
    got = codec.compress(data)
    assert oracle.decompress(got, len(data)) == data
    assert codec.section_blocks == 2
    ref = TpuCodec(device_entropy="hybrid", **kw).compress(data)
    assert ref != got
    assert not oracle.roundtrip_ok(ref, data)  # the reference's fault


def _words_text(n: int, seed: int) -> bytes:
    """Text of five words in random order (tests/test_tpu_entropy.py's
    end-to-end input)."""
    rng = np.random.default_rng(seed)
    words = [b"device ", b"entropy ", b"coding ", b"zstd ", b"frame "]
    return b"".join(words[int(i)] for i in rng.integers(0, 5, n // 5))[:n]


FULL_CASES = {  # data, level, batch, block size, max_seq
    "L1_words_64K_batch2": (
        lambda: _words_text(200_000, 3) + np.random.default_rng(3).integers(
            0, 256, 30_000, np.uint8).tobytes(), 1, 2, 65536, 8192),
    "L1_corpus_64K_batch2": (lambda: make_corpus(4 * 65536 + 3000, 11), 1,
                             2, 65536, 8192),
    "L5_4_blocks_batch4": (lambda: make_corpus(4 * BLOCK, 5), 5, 4, BLOCK,
                           16384),
}


@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_full_frames_equal_tpu_codec(case):
    """Full device entropy: equal frames (tests/test_tpu_entropy.py's L1
    configuration, and L5), decoded by libzstd; each full block went
    through the device half. On the five-word text every block overflows
    max_seq 8192 and both codecs re-match it on the host; on the corpus
    blocks carry both device sections."""
    make, level, batch, block, max_seq = FULL_CASES[case]
    data = make()
    kw = dict(level=level, batch=batch, block_size=block, max_seq=max_seq)
    want = TpuCodec(device_entropy=True, **kw).compress(data)
    codec = GpuCodec(device="cpu", device_entropy=True, **kw)
    got = codec.compress(data)
    assert got == want
    assert oracle.decompress(got, len(data)) == data
    assert codec.device_blocks == len(data) // block
    assert codec.stats.fallback_blocks == 0
    assert codec.literal_blocks <= codec.section_blocks
    if "words" in case:
        assert codec.overflow_blocks == codec.device_blocks
    else:
        assert codec.literal_blocks > 0


def window_fault_data() -> bytes:
    """Two 128 KiB blocks, each a 40000-byte zero run among random bytes
    and text: the content parse chooses an offset-1 run longer than 16384
    while the block's literals are coded."""
    rng = np.random.default_rng(1)
    blocks = []
    for b in range(2):
        x = rng.integers(0, 256, BLOCK, np.uint8)
        text = np.frombuffer(_words_text(60_000, b), np.uint8)
        x[50_000:50_000 + len(text)] = text
        x[5000 + b * 700:45_000 + b * 700] = 0
        blocks.append(x)
    return np.concatenate(blocks).tobytes()


def test_reference_window_fault_frame():
    """The port's full-mode frame decodes bit-exactly, both blocks with the
    device's literals. The last assertion records the JAX package's fault
    (its literal_keys sees only the last 16384 positions of a match and
    codes the rest of the run as literals): TpuCodec's full-mode frame
    does not decode. Change it if that package is ever repaired."""
    data = window_fault_data()
    kw = dict(level=5, batch=4)
    codec = GpuCodec(device="cpu", device_entropy=True, **kw)
    got = codec.compress(data)
    assert oracle.decompress(got, len(data)) == data
    assert codec.literal_blocks == 2
    ref = TpuCodec(device_entropy=True, **kw).compress(data)
    assert ref != got
    assert not oracle.roundtrip_ok(ref, data)  # the reference's fault


def test_reference_fault_frame_full():
    """The B12 fill fault in full mode: the full-mode path rides the same
    verified hash matcher at level 1, so the port's frame decodes and
    TpuCodec's does not."""
    data = fault_data()
    kw = dict(level=1, batch=2, block_size=65536, max_seq=8192)
    codec = GpuCodec(device="cpu", device_entropy=True, **kw)
    got = codec.compress(data)
    assert oracle.decompress(got, len(data)) == data
    assert codec.section_blocks == 2
    ref = TpuCodec(device_entropy=True, **kw).compress(data)
    assert ref != got
    assert not oracle.roundtrip_ok(ref, data)  # the reference's fault
