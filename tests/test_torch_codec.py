"""The port's frames at levels 1-12 against the JAX package's, on the CPU.

GpuCodec(device="cpu") runs the kernels' plain-torch twins; TpuCodec runs
the Pallas kernels in interpret mode. Their host halves are the same code
(the port's own copy), so their frames must be equal byte for byte at the
same batch size, and stock libzstd must decode them.
"""

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu_torch import GpuCodec, compress, decompress, native
from qat_zstd_plugin_tpu_torch.corpus import make_corpus as make_data

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072


CASES = {
    "8_blocks_tail_batch8": (8 * BLOCK + 5000, 8),
    "9_blocks_batch4_padded": (9 * BLOCK, 4),  # last batch: 1 block + 3 pad
    "8_blocks_tail_batch6_no_ldm": (8 * BLOCK + 5000, 6),  # 6 % 4 != 0
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_equal_tpu_codec(case):
    nbytes, batch = CASES[case]
    data = make_data(nbytes, seed=len(case))
    want = TpuCodec(level=1, batch=batch).compress(data)
    codec = GpuCodec(level=1, batch=batch, device="cpu")
    got = codec.compress(data)
    assert got == want
    assert oracle.decompress(got, len(data)) == data
    assert codec.device_blocks == nbytes // BLOCK
    assert codec.overflow_blocks == 0
    assert codec.stats.fallback_blocks == 0


DENSE_CASES = {  # level, full blocks, tail bytes, batch
    "L2_8_blocks_tail_batch8": (2, 8, 5000, 8),
    "L3_8_blocks_tail_batch8": (3, 8, 5000, 8),
    "L4_16_blocks_tail_batch16": (4, 16, 5000, 16),  # LDM over 16 blocks
    "L4_9_blocks_batch8_no_ldm": (4, 9, 0, 8),  # 8 % 16 != 0; padded batch
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_level_frames_equal_tpu_codec(case):
    """Levels 2-4, the full-resolution dense hash path: the frames equal
    TpuCodec's at the same level and batch size and decode."""
    level, nfull, tail, batch = DENSE_CASES[case]
    data = make_data(nfull * BLOCK + tail, seed=level + nfull)
    want = TpuCodec(level=level, batch=batch).compress(data)
    codec = GpuCodec(level=level, batch=batch, device="cpu")
    got = codec.compress(data)
    assert got == want
    assert oracle.decompress(got, len(data)) == data
    assert codec.device_blocks == nfull
    assert codec.overflow_blocks == 0
    assert codec.stats.fallback_blocks == 0


CONTENT_CASES = {  # level, full blocks, tail bytes, batch, max_seq
    "L5_8_blocks_tail_batch4": (5, 8, 5000, 4, 16384),
    "L9_8_blocks_tail_batch4": (9, 8, 5000, 4, 16384),
    "L12_8_blocks_tail_batch8": (12, 8, 5000, 8, 16384),
    "L5_8_blocks_tail_batch6_no_ldm": (5, 8, 5000, 6, 16384),  # 6 % 4
    "L9_max_seq_1024_overflow": (9, 8, 5000, 4, 1024),
}


@pytest.mark.parametrize("case", sorted(CONTENT_CASES))
def test_content_level_frames_equal_tpu_codec(case):
    """Levels 5-12, the exact-LCP content path with the greedy/lazy parse:
    the frames equal TpuCodec's at the same level, batch size and max_seq
    and decode. With max_seq 1024 every block's device output overflows
    and both codecs re-match those blocks on the host."""
    level, nfull, tail, batch, max_seq = CONTENT_CASES[case]
    data = make_data(nfull * BLOCK + tail, seed=level + batch)
    want = TpuCodec(level=level, batch=batch, max_seq=max_seq).compress(data)
    codec = GpuCodec(level=level, batch=batch, max_seq=max_seq, device="cpu")
    got = codec.compress(data)
    assert got == want
    assert oracle.decompress(got, len(data)) == data
    assert codec.device_blocks == nfull
    assert codec.stats.fallback_blocks == 0
    assert (codec.overflow_blocks > 0) == (max_seq < 16384)


def test_compress_entry_point_and_decompress():
    data = make_data(2 * BLOCK + 777, seed=11)
    frame = compress(data, level=1, batch=2, device="cpu")
    assert frame == TpuCodec(level=1, batch=2).compress(data, checksum=True)
    assert decompress(frame, len(data)) == data


def test_short_input_stays_on_host():
    """A tail block (and a whole input shorter than a block) goes to the
    CPU matcher, as in the reference: the format's contract, not a
    fallback."""
    data = make_data(5000, seed=12)
    codec = GpuCodec(level=1, batch=8, device="cpu")
    frame = codec.compress(data)
    assert frame == TpuCodec(level=1, batch=8).compress(data)
    assert codec.device_blocks == 0 and codec.stats.fallback_blocks == 0


def _no_cpu_rematch(codec, monkeypatch):
    """Make a CPU re-match of a full block fail the test; returns the
    blocks the host finished."""
    finished = []
    host = codec.finish_block_host

    def finish(buf, i, seqs, section=None, frame_start=True, **kw):
        if seqs is None and (i + 1) * BLOCK <= len(buf):
            raise AssertionError(f"full block {i} re-matched on the CPU")
        finished.append(i)
        return host(buf, i, seqs, section, frame_start, **kw)

    monkeypatch.setattr(codec, "finish_block_host", finish)
    return finished


@pytest.mark.parametrize("nblocks", [2, 7])
def test_device_error_propagates(nblocks, monkeypatch):
    """TpuCodec re-matches a failed batch on the CPU; GpuCodec raises at
    the first failed submit and re-matches nothing."""
    codec = GpuCodec(level=1, batch=2, device="cpu")
    finished = _no_cpu_rematch(codec, monkeypatch)

    def broken(blocks, lengths):
        raise RuntimeError("device lost")

    monkeypatch.setattr(codec, "_pipeline", lambda: broken)
    with pytest.raises(RuntimeError, match="device lost"):
        codec.compress(make_data(nblocks * BLOCK + 100, seed=13))
    assert finished == [] and codec.device_blocks == 0
    assert codec.stats.fallback_blocks == 0


def test_collect_error_propagates(monkeypatch):
    codec = GpuCodec(level=1, batch=2, device="cpu")
    finished = _no_cpu_rematch(codec, monkeypatch)

    class Lost:
        def cpu(self):
            raise RuntimeError("lost at collect")

    monkeypatch.setattr(codec, "_pipeline", lambda: lambda b, n: Lost())
    with pytest.raises(RuntimeError, match="lost at collect"):
        codec.compress(make_data(7 * BLOCK + 100, seed=14))
    assert finished == []  # batch 0 is collected before the tail is queued
    assert codec.stats.fallback_blocks == 0


def test_error_in_a_later_batch_propagates(monkeypatch):
    """Batches before the failed one finish on the device path; the failed
    batch and those after it are not re-matched on the CPU."""
    codec = GpuCodec(level=1, batch=2, device="cpu")
    finished = _no_cpu_rematch(codec, monkeypatch)
    run = codec._pipeline()
    calls = []

    def flaky(blocks, lengths):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("device lost later")
        return run(blocks, lengths)

    monkeypatch.setattr(codec, "_pipeline", lambda: flaky)
    with pytest.raises(RuntimeError, match="device lost later"):
        codec.compress(make_data(9 * BLOCK, seed=15))
    assert sorted(finished) == [0, 1]  # batch 0, collected before batch 3
    assert codec.device_blocks == 2


def test_requires_native_runtime(monkeypatch, tmp_path):
    """Without a compiler for the port's own host runtime, the codec
    raises; it never goes on without it."""
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native"):
        GpuCodec(level=1, device="cpu")


def test_only_level_1_is_ported():
    """(Named when level 1 alone was ported.) Levels 1-12 construct, with
    host and with hybrid device entropy; 0 and 13 raise ValueError."""
    for level in range(1, 13):
        assert GpuCodec(level=level, device="cpu").level == level
        assert GpuCodec(level=level, device="cpu",
                        device_entropy="hybrid").device_entropy == "hybrid"
    for level in (0, 13):
        with pytest.raises(ValueError):
            GpuCodec(level=level, device="cpu")
