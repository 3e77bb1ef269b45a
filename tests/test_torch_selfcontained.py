"""The port's own copies of the JAX package's host half, held against it.

The port imports nothing of qat_zstd_plugin_tpu; what it needs it keeps
as a copy. Frames equal the JAX package's only while every copy does:
the C++ runtime's source, both level tables field by field, the version,
frame assembly, the content checksum, the FSE pieces the hybrid
sequence sections need (the code tables, the encode tables, the table
descriptions, the nbSeq header and the closing of the backward stream),
the Huffman pieces the full-mode literals sections need (the tree
description, the weights' FSE compression and normalization, the literals
header), the decoder's pieces (the FSE decode table, the table
description reader, the backward bit reader, the NumPy XXH64), and the
process defaults (utils/config.py).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu import native as jax_native
from qat_zstd_plugin_tpu import oracle as jax_oracle
from qat_zstd_plugin_tpu.format import (bitstream, frame, fse, huffman,
                                        sequences, tables, xxhash)
from qat_zstd_plugin_tpu.golden import codec as golden_codec
from qat_zstd_plugin_tpu.ops import bitpack as jax_bitpack
from qat_zstd_plugin_tpu.runtime import tpu_codec
from qat_zstd_plugin_tpu.utils import config as jax_config
from qat_zstd_plugin_tpu.utils import profiling
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import format as tformat
from qat_zstd_plugin_tpu_torch import (fse_format, huffman_format, native,
                                       oracle)
from qat_zstd_plugin_tpu_torch import xxhash as port_xxhash
from qat_zstd_plugin_tpu_torch.ops import bitpack
from qat_zstd_plugin_tpu_torch.runtime import gpu_codec, levels, stats
from qat_zstd_plugin_tpu_torch.utils import config

torch.set_num_threads(2)  # six test workers share a few cores


def test_native_source_is_a_byte_for_byte_copy():
    ref = os.path.join(os.path.dirname(jax_native.__file__), "qz_entropy.cc")
    with open(ref, "rb") as a, open(native.SRC, "rb") as b:
        assert a.read() == b.read()


def test_native_build_key_names_source_flags_and_cpu(tmp_path):
    """The library's directory changes with the source and the flags."""
    src = tmp_path / "qz_entropy.cc"
    src.write_bytes(open(native.SRC, "rb").read())
    key = native.library_path(str(src))
    assert key == native.library_path()
    assert key.startswith(native.BUILD_ROOT)
    src.write_bytes(src.read_bytes() + b"\n")
    assert native.library_path(str(src)) != key
    assert b"model name" in native._cpu_id() or native._cpu_id()


@pytest.mark.parametrize("table", ["device", "host"])
def test_level_tables_equal_field_by_field(table):
    mine, ref = {
        "device": (levels.TPU_LEVEL_TABLE, tpu_codec.TPU_LEVEL_TABLE),
        "host": (levels.LEVEL_TABLE, golden_codec.LEVEL_TABLE),
    }[table]
    assert sorted(mine) == sorted(ref) == list(range(1, 13))
    for level in ref:
        want = dataclasses.asdict(ref[level])
        assert dataclasses.asdict(mine[level]) == want, level
        assert list(want) == [f.name for f in dataclasses.fields(
            mine[level])]
    for level in (1, 5, 12):
        assert dataclasses.asdict(levels.level_params(level)) == \
            dataclasses.asdict(golden_codec.level_params(level))
    with pytest.raises(ValueError):
        levels.level_params(13)


def test_version_and_constants():
    assert qzt.__version__ == qz.__version__ == qzt.version()
    assert tformat.BLOCK_SIZE_MAX == tables.BLOCK_SIZE_MAX
    assert tformat.MIN_WINDOW_LOG == tables.MIN_WINDOW_LOG
    assert tformat.MAX_WINDOW_LOG == tables.MAX_WINDOW_LOG


@pytest.mark.parametrize("n", [0, 1, 31, 100, 255, 4096, 65791, 300_000])
def test_content_checksum(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    assert tformat.content_checksum(data) == xxhash.content_checksum(data) \
        == xxhash.xxh64(data) & 0xFFFFFFFF
    assert native.xxh64(data.tobytes(), 7) == jax_native.xxh64(data, 7)


@pytest.mark.parametrize("nbytes, block, wlog, checksum", [
    (0, 131072, None, True), (200, 131072, 19, True),
    (5000, 1024, None, False), (300_000, 131072, 21, True),
    (3 * 131072, 131072, 22, False)])
def test_assemble_frame_on_random_bodies(nbytes, block, wlog, checksum):
    """Raw, RLE and compressed bodies (random bytes standing in for the
    entropy coder's output, shorter or longer than the block) give the
    same frame bytes."""
    rng = np.random.default_rng(nbytes + block)
    data = rng.integers(0, 4, nbytes, np.uint8)
    nblocks = max(1, -(-nbytes // block))
    if nblocks > 1:
        data[:block] = 7  # an RLE block
    bodies = []
    for i in range(nblocks):
        size = int(rng.integers(1, block + 8))
        bodies.append(None if i % 3 == 2 else
                      rng.integers(0, 256, size, np.uint8).tobytes())
    got = tformat.assemble_frame(data, bodies, block, checksum,
                                 window_log=wlog)
    assert got == frame.assemble_frame(data, bodies, block, checksum,
                                       window_log=wlog)


def test_block_sequences_and_helpers_match():
    seqs = tformat.BlockSequences(np.array([3, 0]), np.array([5, 5]),
                                  np.array([4, 9]), 2)
    ref = frame.BlockSequences(np.array([3, 0]), np.array([5, 5]),
                               np.array([4, 9]), 2)
    assert seqs.nseq == ref.nseq and seqs.total_span() == ref.total_span()
    lit, off, ml = (np.array(a) for a in ([2, 0, 0, 5], [7, 7, 7, 3],
                                          [16, 16, 9, 4]))
    for got, want in zip(gpu_codec.coalesce_sequences(lit, off, ml),
                         tpu_codec.coalesce_sequences(lit, off, ml)):
        np.testing.assert_array_equal(got, want)
    pos, offs = np.array([4, 20, 33]), np.array([1, 9, 4])
    got = gpu_codec.device_positions_to_claims(pos, offs, 100)
    want = tpu_codec.device_positions_to_claims(pos, offs, 100)
    for f in ("lit_lengths", "offsets", "match_lengths"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.last_literals == want.last_literals
    for level in (5, 7, 12):
        for share in (0.01, 0.1, 0.3, 0.5):
            for ctx in (0, 200_000, 1 << 20):
                assert gpu_codec.deep_parse_pick(level, share, ctx, 131072) \
                    == tpu_codec.deep_parse_pick(level, share, ctx, 131072)


def test_fse_format_constants_equal():
    for name in ("LL_BASELINES", "LL_BITS", "ML_BASELINES", "ML_BITS",
                 "LL_DEFAULT_DIST", "ML_DEFAULT_DIST", "OF_DEFAULT_DIST",
                 "LL_DEFAULT_ACCURACY", "ML_DEFAULT_ACCURACY",
                 "OF_DEFAULT_ACCURACY", "LL_MAX_ACCURACY",
                 "ML_MAX_ACCURACY", "OF_MAX_ACCURACY"):
        assert getattr(fse_format, name) == getattr(tables, name), name


def _norms():
    """The predefined distributions (with -1 entries) and normalized
    counts of random histograms (with zero runs past 24 symbols)."""
    out = [(tables.LL_DEFAULT_DIST, 6), (tables.ML_DEFAULT_DIST, 6),
           (tables.OF_DEFAULT_DIST, 5)]
    rng = np.random.default_rng(3)
    for al, k in ((5, 32), (6, 36), (6, 53), (6, 53)):
        hist = rng.integers(0, 50, k) * (rng.random(k) < 0.6)
        hist[k - 1] = 3  # the last symbol present: no trailing zeros
        out.append((fse.normalize_counts(hist, al), al))
    hist = np.zeros(53, np.int64)
    hist[[0, 30, 52]] = (500, 3, 1)
    out.append((fse.normalize_counts(hist, 6), 6))
    return out


@pytest.mark.parametrize("i", range(8))
def test_fse_tables_and_descriptions_equal(i):
    norm, al = _norms()[i]
    norm = [int(c) for c in norm]
    np.testing.assert_array_equal(fse_format.spread_symbols(norm, al),
                                  fse.spread_symbols(norm, al))
    got = fse_format.build_encode_table(norm, al)
    want = fse.build_encode_table(norm, al)
    assert got.accuracy_log == want.accuracy_log
    for f in ("state_table", "delta_nb_bits", "delta_find_state"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert fse_format.write_ncount(norm, al) == fse.write_ncount(norm, al)


def _outcome(fn, *args):
    """fn(*args), or the class name of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # the verdicts are compared, whatever they are
        return type(e).__name__


@pytest.mark.parametrize("i", range(8))
def test_fse_decode_pieces_equal(i):
    """The decoder's copies: build_decode_table field by field, and
    read_ncount on the table description, on it cut short, with a byte
    changed and with tails, with the JAX package's result or exception."""
    norm, al = _norms()[i]
    norm = [int(c) for c in norm]
    got = fse_format.build_decode_table(norm, al)
    want = fse.build_decode_table(norm, al)
    assert got.accuracy_log == want.accuracy_log
    for f in ("symbol", "nb_bits", "next_state"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    desc = fse.write_ncount(norm, al)
    rng = np.random.default_rng(i)
    cases = [desc, desc + b"\xff\x00", desc[:-1], desc[:1], b"", b"\x0f"]
    for _ in range(40):
        d = bytearray(desc)
        d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
        cases.append(bytes(d))
    for d in cases:
        for max_symbol in (63, 255, len(norm) - 2):
            assert _outcome(fse_format.read_ncount, d, max_symbol) == \
                _outcome(fse.read_ncount, d, max_symbol), (d.hex(),
                                                           max_symbol)
    assert fse_format.read_ncount(desc, 255) == (norm, al, len(desc))


@pytest.mark.parametrize("seed", range(4))
def test_backward_bit_reader_equal(seed):
    """BackwardBitReader on a written stream and on random bytes: the
    same fields, bits_remaining, exhausted and refusals."""
    rng = np.random.default_rng(seed)
    w = bitstream.BackwardBitWriter()
    for _ in range(200):
        nb = int(rng.integers(0, 25))
        w.add(int(rng.integers(0, 1 << nb)), nb)
    streams = [w.close(), rng.integers(0, 256, 37, np.uint8).tobytes(),
               b"\x01", b"\x80", b"", b"\x12\x00"]
    for data in streams:
        mine = _outcome(huffman_format.BackwardBitReader, data)
        ref = _outcome(bitstream.BackwardBitReader, data)
        if isinstance(ref, str):
            assert mine == ref
            continue
        while True:
            nb = int(rng.integers(0, 20))
            a, b = _outcome(mine.read, nb), _outcome(ref.read, nb)
            assert a == b
            assert (mine.bits_remaining, mine.exhausted) == \
                (ref.bits_remaining, ref.exhausted)
            if isinstance(a, str) or mine.exhausted:
                break


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 4096,
                               65791])
def test_numpy_xxh64_equal(n):
    """xxhash.py, the decoder's checksum, against the JAX package's and
    the native runtime's, on bytes and on arrays, at seeds 0 and 7."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    for seed in (0, 7, (1 << 64) - 1):
        want = xxhash.xxh64(data, seed)
        assert port_xxhash.xxh64(data, seed) == want
        assert port_xxhash.xxh64(data.tobytes(), seed) == want
        assert native.xxh64(data, seed) == want


def test_nbseq_header_and_bit_writers_equal():
    for n in (0, 1, 127, 128, 255, 0x7EFF, 0x7F00, 0x7F01, 0x7F00 + 65535):
        assert fse_format.nbseq_header(n) == sequences.nbseq_header(n), n
    rng = np.random.default_rng(4)
    mine, ref = fse_format.ForwardBitWriter(), bitstream.ForwardBitWriter()
    for _ in range(300):
        nb = int(rng.integers(0, 17))
        v = int(rng.integers(0, 1 << nb))
        mine.add(v, nb)
        ref.add(v, nb)
    assert mine.close() == ref.close()
    for bits in (0, 1, 7, 8, 9, 31, 32, 33, 1000, 32 * 40):
        words = rng.integers(0, 1 << 32, 41, dtype=np.uint64) \
            .astype(np.uint32).view(np.int32)
        words[bits // 32 + 1:] = 0
        if bits % 32:
            words[bits // 32] &= (1 << bits % 32) - 1
        else:
            words[bits // 32] = 0
        assert bitpack.backward_stream_bytes(words, bits) == \
            jax_bitpack.backward_stream_bytes(words, bits), bits


def test_block_stats_and_oracle():
    mine, ref = stats.BlockStats(), profiling.BlockStats()
    for s in (mine, ref):
        s.record(131072, 30000, 0.002)
        s.record(5000, None, 0.0001, fallback=True)
    assert mine.summary() == ref.summary()
    with stats.Timer() as tm:
        pass
    assert tm.elapsed >= 0
    data = bytes(range(256)) * 600
    f = qzt.compress(data, level=1, device="cpu")
    assert oracle.available() == jax_oracle.available()
    assert oracle.decompress(f) == jax_oracle.decompress(f) == data
    with pytest.raises(oracle.ZstdOracleError):
        oracle.decompress(f[:-9] + b"\x00" * 9, len(data))


def _huffman_tables(seed: int) -> list:
    """Host Huffman tables of random byte histograms: 2 to 256 symbols,
    flat to skewed, last symbols low and high (short and long weight
    lists, direct and FSE-compressed descriptions)."""
    rng = np.random.default_rng(seed)
    out = []
    for nsym in (2, 3, 5, 12, 40, 100, 129, 200, 256):
        for skew in (0.0, 1.2, 2.5):
            hist = np.zeros(256, np.int64)
            syms = rng.choice(256 if nsym > 40 else 64, nsym, replace=False)
            hist[syms] = (rng.pareto(skew, nsym) * 50 + 1 if skew
                          else rng.integers(1, 300, nsym)).astype(np.int64)
            out.append(huffman.build_table(hist))
    for syms in ((0, 1), (0, 2, 3), (1, 4, 6, 7)):  # too few weights for FSE
        hist = np.zeros(256, np.int64)
        hist[list(syms)] = rng.integers(1, 100, len(syms))
        out.append(huffman.build_table(hist))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_serialize_tree_equal(seed):
    kinds = set()
    for t in _huffman_tables(seed):
        mine = huffman_format.HuffmanTable(t.nb_bits, t.codes, t.max_bits,
                                           t.last_symbol)
        assert huffman_format.weights(mine) == huffman.weights(t)
        got = huffman_format.serialize_tree(mine)
        assert got == huffman.serialize_tree(t)
        ws = huffman.weights(t)
        assert huffman_format._fse_compress_weights(ws) == \
            huffman._fse_compress_weights(ws)
        kinds.add("fse" if got[0] < 128 else "direct")
    assert kinds == {"fse", "direct"}


def test_normalize_counts_and_fse_encoder_equal():
    rng = np.random.default_rng(5)
    for al in (5, 6, 9):
        for _ in range(40):
            k = int(rng.integers(2, 14))
            hist = rng.integers(0, 200, k) * (rng.random(k) < 0.7)
            hist[rng.integers(0, k, 2)] += rng.integers(1, 5000, 2)
            try:
                want = fse.normalize_counts(hist, al)
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    huffman_format.normalize_counts(hist, al)
                continue
            assert huffman_format.normalize_counts(hist, al) == want
            table = fse_format.build_encode_table(want, al)
            syms = [s for s in range(len(want)) if want[s]]
            seq = [int(s) for s in rng.choice(syms, 50)]
            mine, ref = huffman_format.BackwardBitWriter(), \
                bitstream.BackwardBitWriter()
            a = huffman_format.FseEncoder(table, seq[0])
            b = fse.FseEncoder(fse.build_encode_table(want, al), seq[0])
            for s in seq[1:]:
                a.encode(s, mine)
                b.encode(s, ref)
            a.flush(mine)
            b.flush(ref)
            assert mine.close() == ref.close()


@pytest.mark.parametrize("lit_type", [0, 1, 2])
def test_literals_header_equal(lit_type):
    """Every size format of each literals type, at its largest sizes."""
    assert huffman_format.LIT_COMPRESSED == frame.LIT_COMPRESSED
    assert (huffman_format.LIT_RAW, huffman_format.LIT_RLE) == \
        (frame.LIT_RAW, frame.LIT_RLE)
    if lit_type == frame.LIT_COMPRESSED:
        formats = {0: 1024, 1: 1024, 2: 1 << 14, 3: 1 << 18}
    else:
        formats = {0: 32, 1: 4096, 3: 1 << 20}
    rng = np.random.default_rng(lit_type)
    for sf, limit in formats.items():
        for regen in (0, 1, limit - 1, int(rng.integers(0, limit))):
            comp = int(rng.integers(0, limit)) if lit_type == 2 else None
            assert huffman_format.literals_header(lit_type, sf, regen, comp) \
                == frame._literals_header(lit_type, sf, regen, comp)


@pytest.mark.parametrize("level", range(1, 13))
@pytest.mark.parametrize("checksum", [True, False])
def test_stream_frame_header_copy(level, checksum):
    """The stream header and its window per level equal the JAX
    package's StreamCompressor's."""
    from qat_zstd_plugin_tpu.runtime import stream as jax_stream
    from qat_zstd_plugin_tpu_torch.runtime import stream
    wlog = max(tables.MIN_WINDOW_LOG,
               golden_codec.level_params(level).window_log)
    assert stream._stream_frame_header(wlog, checksum) == \
        jax_stream._stream_frame_header(wlog, checksum)
    sc = stream.StreamCompressor(level=level, checksum=checksum,
                                 device="cpu")
    assert sc._header() == stream._stream_frame_header(wlog, checksum)


def test_oracle_producer_abi_copy():
    """The ZSTD_Sequence layout, the callback's signature and the libzstd
    parameter numbers equal the JAX package's oracle's."""
    assert oracle.ZstdSequence._fields_ == jax_oracle.ZstdSequence._fields_
    assert [t.__name__ for t in oracle.SEQPROD_CFUNC._argtypes_] == \
        [t.__name__ for t in jax_oracle.SEQPROD_CFUNC._argtypes_]
    assert oracle.SEQPROD_CFUNC._restype_ == jax_oracle.SEQPROD_CFUNC._restype_
    for name in ("ZSTD_SEQUENCE_PRODUCER_ERROR", "ZSTD_c_compressionLevel",
                 "ZSTD_c_enableSeqProducerFallback",
                 "ZSTD_c_searchForExternalRepcodes", "ZSTD_ps_enable",
                 "ZSTD_e_continue", "ZSTD_e_flush", "ZSTD_e_end"):
        assert getattr(oracle, name) == getattr(jax_oracle, name), name
    assert oracle.version() == jax_oracle.version()
    data = bytes(range(256)) * 64
    assert oracle.compress(data, 3) == jax_oracle.compress(data, 3)


def test_config_defaults_equal_field_by_field(monkeypatch):
    """utils/config.py's Config: every field, in order, with its default,
    and from_env's parse rules (a bad integer keeps the default)."""
    mine = dataclasses.fields(config.Config)
    ref = dataclasses.fields(jax_config.Config)
    assert [(f.name, f.type, f.default) for f in mine] == \
        [(f.name, f.type, f.default) for f in ref]
    for name in ("QZ_BATCH", "QZ_BLOCK_SIZE", "QZ_MAX_SEQ", "QZ_CHECKSUM",
                 "QZ_DEBUG_LEVEL", "QZ_SECOND_PARSE"):
        for value in ("7", "0", "-1", "x", ""):
            monkeypatch.setenv(name, value)
            assert config._env_int(name, 5) == jax_config._env_int(name, 5)
        monkeypatch.delenv(name)
    assert dataclasses.asdict(config.Config.from_env()) == \
        dataclasses.asdict(jax_config.Config.from_env())
