"""The port's own copies of the JAX package's host half, held against it.

The port imports nothing of qat_zstd_plugin_tpu; what it needs it keeps
as a copy. Frames equal the JAX package's only while every copy does:
the C++ runtime's source, both level tables field by field, the version,
frame assembly and the content checksum.
"""

import dataclasses
import os

import numpy as np
import pytest

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu import native as jax_native
from qat_zstd_plugin_tpu import oracle as jax_oracle
from qat_zstd_plugin_tpu.format import frame, tables, xxhash
from qat_zstd_plugin_tpu.golden import codec as golden_codec
from qat_zstd_plugin_tpu.runtime import tpu_codec
from qat_zstd_plugin_tpu.utils import profiling
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import format as tformat
from qat_zstd_plugin_tpu_torch import native, oracle
from qat_zstd_plugin_tpu_torch.runtime import gpu_codec, levels, stats


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
