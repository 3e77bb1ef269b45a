"""The port's LZ4s contract (lz4s_format, native.dec_lz4s) held against the
JAX package's format/lz4s.py and native.dec_lz4s, case for case as
tests/test_lz4s.py, and the producer's triples written as LZ4s and read
back (chip_smoke.py phase 10 (c) on the CPU).
"""

import os
import sys

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu import native as jax_native
from qat_zstd_plugin_tpu.format import lz4s as jax_lz4s

import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import format as tformat
from qat_zstd_plugin_tpu_torch import lz4s_format as lz4s, native
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.lz4s_format import Lz4sFormatError, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)  # six test workers share a few cores

LZ4S_BLOCK = 65536  # the largest block whose every offset fits 16 bits


def _as_jax(seqs):
    return [jax_lz4s.Sequence(s.offset, s.lit_length, s.match_length)
            for s in seqs]


def _tuples(seqs):
    return [(s.offset, s.lit_length, s.match_length) for s in seqs]


def same_decode(stream, capacity=None):
    """The port's decode(stream) with the JAX package's result or
    exception class; returns the port's sequences (None on a reject)."""
    try:
        want = _tuples(jax_lz4s.decode(stream, capacity))
    except jax_lz4s.Lz4sFormatError:
        with pytest.raises(Lz4sFormatError):
            lz4s.decode(stream, capacity)
        return None
    got = lz4s.decode(stream, capacity)
    assert _tuples(got) == want
    return got


def test_constants_and_classes():
    assert (lz4s.ML_BITS, lz4s.ML_MASK, lz4s.RUN_MASK, lz4s.LZ4_MIN_MATCH) \
        == (jax_lz4s.ML_BITS, jax_lz4s.ML_MASK, jax_lz4s.RUN_MASK,
            jax_lz4s.LZ4_MIN_MATCH)
    assert issubclass(Lz4sFormatError, ValueError)
    assert Sequence(1, 2, 3) == Sequence(offset=1, lit_length=2,
                                         match_length=3)


def test_hand_built_stream():
    stream = bytes([0x35]) + b"abc" + bytes([8, 0])
    seqs = same_decode(stream)
    assert seqs[0] == Sequence(8, 3, 7)
    assert seqs[-1] == Sequence(0, 0, 0)
    assert len(seqs) == 2


def test_literal_run_accumulation():
    stream = (bytes([0x20]) + b"xy" + bytes([0, 0])
              + bytes([0x13]) + b"z" + bytes([4, 0]))
    assert same_decode(stream)[0] == Sequence(4, 3, 5)


def test_length_extensions():
    lit = bytes(range(256)) * 2
    stream = (bytes([0xF7]) + bytes([255, 242]) + lit + bytes([2, 1])
              + bytes([0x00]))
    seqs = same_decode(stream)
    assert (seqs[0].lit_length, seqs[0].match_length, seqs[0].offset) == \
        (512, 9, 258)
    assert seqs[-1] == Sequence(0, 0, 0)


def test_final_literals():
    assert same_decode(bytes([0x40]) + b"tail") == [Sequence(0, 4, 0)]


def _random_sequences(rng, n):
    seqs, lit_total = [], 0
    for _ in range(n - 1):
        lit = int(rng.integers(0, 40)) if rng.integers(0, 4) else \
            int(rng.integers(0, 700))
        seqs.append(Sequence(int(rng.integers(1, 65536)), lit,
                             int(rng.integers(3, 300))))
        lit_total += lit
    final_lit = int(rng.integers(0, 50))
    seqs.append(Sequence(0, final_lit, 0))
    lit_total += final_lit
    return seqs, rng.integers(0, 256, lit_total, np.uint8).tobytes()


@pytest.mark.parametrize("seed", range(20))
def test_roundtrip_random(seed):
    rng = np.random.default_rng((0, seed))
    seqs, literals = _random_sequences(rng, int(rng.integers(1, 30)))
    stream = lz4s.encode(seqs, literals)
    assert stream == jax_lz4s.encode(_as_jax(seqs), literals)
    assert same_decode(stream) == seqs


@pytest.mark.parametrize("stream", [bytes([0xF0]), bytes([0x50]) + b"ab",
                                    bytes([0x03]) + bytes([7]),
                                    bytes([0x0F, 1, 0]),
                                    bytes([0x03, 0, 0, 0x00])],
                         ids=["lit_ext", "lit_overrun", "offset",
                              "match_ext", "zero_offset"])
def test_truncation_errors(stream):
    assert same_decode(stream) is None


def test_capacity_guard():
    stream = bytes([0x03, 1, 0]) * 5 + bytes([0x00])
    assert same_decode(stream, capacity=3) is None
    assert len(same_decode(stream, capacity=10)) == 6
    assert len(same_decode(stream, capacity=5)) == 6  # the final is free


def test_encode_keeps_the_low_16_bits_of_an_offset():
    """An offset past 16 bits is cut to its low 16 in the copy, as in the
    JAX package's encode: LZ4s only holds blocks of up to 64 KiB."""
    seqs = [Sequence(0x1_0005, 0, 4), Sequence(0, 0, 0)]
    stream = lz4s.encode(seqs, b"")
    assert stream == jax_lz4s.encode(_as_jax(seqs), b"")
    assert same_decode(stream)[0] == Sequence(5, 0, 4)


def _native_verdict(mod, stream, capacity=None):
    try:
        return [a.tolist() for a in mod.dec_lz4s(stream, capacity)]
    except ValueError:
        return None


@pytest.mark.parametrize("trial", range(40))
def test_native_decoder_differential(trial):
    """native.dec_lz4s against the port's decode on valid and mutated
    streams (the same triples, the same rejects), and against the JAX
    package's native.dec_lz4s."""
    rng = np.random.default_rng((5, trial))
    nseq = int(rng.integers(1, 40))
    seqs, lits = [], b""
    for _ in range(nseq - 1):
        ll = int(rng.integers(0, 40)) if rng.random() < 0.9 else \
            int(rng.integers(0, 600))
        ml = int(rng.integers(3, 50)) if rng.random() < 0.9 else \
            int(rng.integers(3, 700))
        seqs.append(Sequence(int(rng.integers(1, 65536)), ll, ml))
        lits += bytes(rng.integers(0, 256, ll, np.uint8))
    tail = int(rng.integers(0, 50))
    seqs.append(Sequence(0, tail, 0))
    lits += bytes(rng.integers(0, 256, tail, np.uint8))
    stream = bytearray(lz4s.encode(seqs, lits))
    if trial % 2 and len(stream) > 2:
        k = int(rng.integers(1, 4))
        if k == 1:
            stream = stream[:int(rng.integers(1, len(stream)))]
        elif k == 2:
            stream[int(rng.integers(0, len(stream)))] = int(
                rng.integers(0, 256))
        else:
            stream += bytes(rng.integers(0, 256, int(rng.integers(1, 8)),
                                         np.uint8))
    stream = bytes(stream)
    py = same_decode(stream)
    nat = _native_verdict(native, stream)
    assert nat == _native_verdict(jax_native, stream)
    assert (py is None) == (nat is None), stream.hex()
    if py is not None:
        assert nat == [[s.lit_length for s in py], [s.offset for s in py],
                       [s.match_length for s in py]]
    else:
        assert trial % 2  # only mutated streams are rejected
    arr = np.frombuffer(stream, np.uint8)
    assert _native_verdict(native, arr) == nat


def test_native_decoder_capacity():
    seqs = [Sequence(1, 0, 3) for _ in range(10)] + [Sequence(0, 0, 0)]
    stream = lz4s.encode(seqs, b"")
    with pytest.raises(ValueError):
        native.dec_lz4s(stream, capacity=5)
    ll, of, ml = native.dec_lz4s(stream, capacity=11)
    assert len(ll) == 11
    assert _native_verdict(native, stream, 11) == \
        _native_verdict(jax_native, stream, 11)
    assert _native_verdict(jax_native, stream, 5) is None


@pytest.mark.parametrize("level", [1, 9])
def test_producer_triples_roundtrip(level):
    """chip_smoke.py phase 10 (c) on the CPU: with SeqProdState(...,
    block_size=65536, device="cpu"), each slice's triples, the final
    (0, last_literals, 0) included, written as LZ4s by chip_smoke's
    producer_lz4s come back exactly through decode and native.dec_lz4s,
    and pass format.validate_sequences against the slice."""
    corpus = make_corpus(3 * LZ4S_BLOCK + 777, level)
    state = qzt.SeqProdState(level, block_size=LZ4S_BLOCK, device="cpu")
    for i in range(3):
        block = corpus[i * LZ4S_BLOCK + 777 * (i == 2):][:LZ4S_BLOCK]
        triples = qzt.sequence_producer(state, block)
        assert triples is not qzt.SEQUENCE_PRODUCER_ERROR
        assert len(triples) > 100
        stream, lits = chip_smoke.producer_lz4s(lz4s, block, triples)
        seqs = [jax_lz4s.Sequence(*t) for t in triples]
        assert stream == jax_lz4s.encode(seqs, lits)
        assert _tuples(lz4s.decode(stream)) == triples
        ll, of, ml = native.dec_lz4s(stream)
        assert list(zip(of.tolist(), ll.tolist(), ml.tolist())) == triples
        tformat.validate_sequences(
            np.frombuffer(block, np.uint8),
            tformat.BlockSequences(ll[:-1], of[:-1], ml[:-1], int(ll[-1])))
    assert state.device_blocks == 3 and state.errors == 0
