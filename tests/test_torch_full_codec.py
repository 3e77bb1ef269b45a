"""The port's full device-entropy frames against the JAX package's, on
the CPU (device_entropy=True: both codecs also encode the Huffman literals
on the device and the host only wraps the sections), and the reference's
B15 window fault, where its frame is corrupt and the port's is not
(test_reference_window_fault_frame).
"""

import functools

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu_torch import GpuCodec, compress
from qat_zstd_plugin_tpu_torch.corpus import make_corpus

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072


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
    # The benchmark's l9full deployment at batch 4: level 9's content
    # matcher, lazy parse and LDM, and a host-matched tail block.
    "L9_corpus_4_blocks_batch4": (lambda: make_corpus(4 * BLOCK + 5000, 9),
                                  9, 4, BLOCK, 16384),
}


@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_full_frames_equal_tpu_codec(case):
    """Full device entropy: equal frames (tests/test_tpu_entropy.py's L1
    configuration, and L5), decoded by libzstd; each full block went
    through the device half. On the five-word text every block overflows
    max_seq 8192 and both codecs re-match it on the host; on the corpus
    blocks carry both device sections (at level 9, 3 of its 4 blocks or
    more)."""
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
    elif case.startswith("L9"):
        assert codec.literal_blocks >= 3
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
