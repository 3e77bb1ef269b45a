"""The port's native runtime and the software producer against the JAX
package's golden CPU codec, on the CPU.

The port keeps no copy of the golden codec (golden/codec.py,
golden/matcher.py) or of its Python entropy encoder: nothing in the port
calls them. What the port runs in their place is its native runtime
(native.find_sequences, native.block_body), so that is what is held
here, byte for byte, to the JAX package's golden codec (the
counterparts of tests/test_native.py's differentials).
SeqProdState(device="host") is the reference's use_device=False producer:
compress_via_libzstd(device="host") equals the JAX package's
compress_via_libzstd(use_device=False). Inputs come from a seed with
numpy.
"""

import numpy as np
import pytest
import torch

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu.format import frame as jframe
from qat_zstd_plugin_tpu.golden import codec as jcodec
from qat_zstd_plugin_tpu.golden import matcher as jmatcher
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import decoder, native, oracle
from qat_zstd_plugin_tpu_torch import format as tformat
from qat_zstd_plugin_tpu_torch.runtime.levels import level_params

torch.set_num_threads(2)  # six test workers share a few cores


def corpus(n: int, seed: int) -> np.ndarray:
    """tests/test_native.py's mix: words, byte runs, a small alphabet and
    random bytes."""
    rng = np.random.default_rng(seed)
    parts = []
    words = [b"the ", b"data ", b"zstd ", b"entropy block ", b"offset "]
    while sum(map(len, parts)) < n:
        k = int(rng.integers(0, 4))
        if k == 0:
            parts.append(b"".join(words[i] for i in rng.integers(0, 5, 50)))
        elif k == 1:
            parts.append(bytes([int(rng.integers(0, 256))]) * 200)
        elif k == 2:
            parts.append(rng.integers(0, 8, 500, np.uint8).tobytes())
        else:
            parts.append(rng.integers(0, 256, 300, np.uint8).tobytes())
    return np.frombuffer(b"".join(parts)[:n], np.uint8)


def _same(got, want) -> None:
    """Two sequence sets equal field by field."""
    assert got.lit_lengths.tolist() == want.lit_lengths.tolist()
    assert got.offsets.tolist() == want.offsets.tolist()
    assert got.match_lengths.tolist() == want.match_lengths.tolist()
    assert got.last_literals == want.last_literals


GOLDEN = {  # level, bytes, block size
    "L1_one_block": (1, 12000, 131072),
    "L5_three_blocks": (5, 9000, 4096),  # a 64-byte-or-less tail: raw
    "L9_two_blocks": (9, 8200, 4096),
    "L1_tiny": (1, 50, 131072),
    "L5_empty": (5, 0, 131072),
}


def native_frame(data: bytes, level: int, block_size: int) -> bytes:
    """The golden codec's compress() from the port's pieces: each block
    of 64 bytes or more matched by native.find_sequences at the level's
    parameters, checked by format.validate_sequences and coded by
    native.block_body (raw where it gives None), then
    format.assemble_frame with a checksum."""
    buf = np.frombuffer(data, np.uint8)
    p = level_params(level)
    bodies = []
    for i in range(max(1, -(-len(buf) // block_size))):
        blk = buf[i * block_size:(i + 1) * block_size]
        if len(blk) < 64:
            bodies.append(None)
            continue
        seqs = native.find_sequences(blk, p.chain_depth, p.lazy, mml=p.mml)
        tformat.validate_sequences(blk, tformat.BlockSequences(*seqs))
        bodies.append(native.block_body(blk, *seqs, p.custom_tables,
                                        p.huffman, first_block=i == 0))
    return tformat.assemble_frame(buf, bodies, block_size, True)


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_native_frame_equals_golden_compress(case):
    """The golden codec's frame is the one the port's native matcher and
    encoder make, byte for byte, and it decodes through libzstd."""
    level, n, block = GOLDEN[case]
    data = corpus(n, level).tobytes()
    want = jcodec.compress(data, level=level, block_size=block)
    got = native_frame(data, level, block)
    assert got == want
    assert oracle.decompress(got, len(data)) == data


@pytest.mark.parametrize("level", [1, 5, 9])
def test_native_matcher_equals_golden_at_each_level(level):
    data = corpus(6000, 10 + level)
    p = level_params(level)
    want = jcodec.compress_block_sequences(data, level)
    got = tformat.BlockSequences(*native.find_sequences(
        data, p.chain_depth, p.lazy, mml=p.mml))
    _same(got, want)
    tformat.validate_sequences(data, got)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_body_equals_golden(seed):
    """test_block_body_byte_identical_to_golden's counterpart."""
    data = corpus(30_000, seed)
    seqs = jmatcher.find_sequences(data, chain_depth=8, lazy=(seed % 2 == 0))
    first = seed == 3
    assert native.block_body(data, seqs.lit_lengths, seqs.offsets,
                             seqs.match_lengths, seqs.last_literals,
                             first_block=first) == \
        jframe.encode_block_body(data, seqs, first_block=first)


def test_block_body_no_custom_no_huffman():
    data = corpus(20_000, 9)
    seqs = jmatcher.find_sequences(data, chain_depth=4)
    for custom in (False, True):
        for huff in (False, True):
            want = jframe.encode_block_body(data, seqs,
                                            allow_custom_tables=custom,
                                            try_huffman=huff)
            assert native.block_body(
                data, seqs.lit_lengths, seqs.offsets, seqs.match_lengths,
                seqs.last_literals, custom, huff) == want, (custom, huff)


def test_native_matcher_identical_to_golden():
    """test_native_matcher_identical_to_golden's counterpart."""
    data = corpus(25_000, 5)
    got = tformat.BlockSequences(*native.find_sequences(data, 16, True))
    _same(got, jmatcher.find_sequences(data, chain_depth=16, lazy=True))


def test_native_sequences_regenerate_the_block():
    """Native sequences, coded by the native runtime into a frame, decode
    back to the block through the port's own decoder and libzstd."""
    data = corpus(7000, 4)
    seqs = native.find_sequences(data, 8, True)
    tformat.validate_sequences(data, tformat.BlockSequences(*seqs))
    body = native.block_body(data, *seqs)
    f = tformat.assemble_frame(data, [body], block_size=131072)
    assert decoder.decompress(f) == data.tobytes()
    assert oracle.decompress(f, len(data)) == data.tobytes()


@pytest.mark.parametrize("level", [1, 4, 9])
def test_compress_via_libzstd_host(level):
    data = corpus(3 * 131072 + 999, level).tobytes()
    want = qz.compress_via_libzstd(data, level=level, use_device=False)
    got = qzt.compress_via_libzstd(data, level=level, device="host")
    assert got == want
    assert oracle.decompress(got, len(data)) == data


def test_compress_stream_via_libzstd_host():
    data = corpus(2 * 131072 + 5000, 7).tobytes()
    kw = dict(level=3, chunk_size=50000, flush_every=2)
    want = qz.compress_stream_via_libzstd(data, use_device=False, **kw)
    got = qzt.compress_stream_via_libzstd(data, device="host", **kw)
    assert got == want
    assert oracle.decompress(got, len(data)) == data


def test_host_producer_builds_no_codec():
    st = qzt.create_seqprod_state(5, device="host")
    assert st.codec is None
    block = corpus(70000, 1)
    out = qzt.sequence_producer(st, block)
    assert out is not qzt.SEQUENCE_PRODUCER_ERROR
    assert st.host_blocks == 1 and st.device_blocks == 0
    ref = qz.create_seqprod_state(5, use_device=False)
    assert out == qz.sequence_producer(ref, block)
    qzt.free_seqprod_state(st)
    assert qzt.sequence_producer(st, block) is qzt.SEQUENCE_PRODUCER_ERROR


@pytest.mark.parametrize("block_size", [0, 131073])
def test_host_producer_refuses_a_block_size_outside_the_format(block_size):
    """The host route has no device geometry, but a block size outside
    1..131072 is refused as on the card's route."""
    with pytest.raises(ValueError, match="block_size"):
        qzt.SeqProdState(level=1, block_size=block_size, device="host")


def test_host_producer_takes_sizes_the_device_route_refuses():
    """4001 bytes at L1 breaks the hash levels' segment rule on the card;
    the host matcher has no segments and takes it."""
    with pytest.raises(ValueError):
        qzt.SeqProdState(level=1, block_size=4001, device="cpu")
    st = qzt.SeqProdState(level=1, block_size=4001, device="host")
    assert st.codec is None and st.host.window_log == level_params(1) \
        .window_log


def test_host_is_never_a_fallback_for_the_card():
    """The default stays "cuda": without a card it raises, and does not
    take the host producer."""
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device")
    with pytest.raises(RuntimeError):
        qzt.create_seqprod_state(1)
    with pytest.raises(RuntimeError):
        qzt.compress_via_libzstd(b"abc" * 1000, level=1)
