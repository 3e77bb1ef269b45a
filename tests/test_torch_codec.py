"""The port's frames at levels 1-4 against the JAX package's, on the CPU.

GpuCodec(device="cpu") runs the kernels' plain-torch twins; TpuCodec runs
the Pallas kernels in interpret mode. Both share the host half, so their
frames must be equal byte for byte at the same batch size, and stock
libzstd must decode them.
"""

import numpy as np
import pytest

from qat_zstd_plugin_tpu import native, oracle
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu.runtime import device as jax_device
from qat_zstd_plugin_tpu_torch import GpuCodec, compress, decompress
from qat_zstd_plugin_tpu_torch.corpus import make_corpus as make_data

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
    assert codec.fallback_batches == 0
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
    assert codec.fallback_batches == 0
    assert codec.stats.fallback_blocks == 0


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
    """Make a CPU re-match of a full block, or a call into the reference's
    JAX device state, fail the test; returns the blocks the host finished."""
    finished = []
    host = codec.finish_block_host

    def finish(buf, i, seqs, *a, **k):
        if seqs is None and (i + 1) * BLOCK <= len(buf):
            raise AssertionError(f"full block {i} re-matched on the CPU")
        finished.append(i)
        return host(buf, i, seqs, *a, **k)

    def jax_state(*a, **k):
        raise AssertionError("the reference's device state was touched")

    monkeypatch.setattr(codec, "finish_block_host", finish)
    for name in ("note_offload_failure", "stop_device", "start_device"):
        monkeypatch.setattr(jax_device, name, jax_state)
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
    assert finished == [] and codec.fallback_batches == 0
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
    assert codec.fallback_batches == 0


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


def test_requires_native_runtime(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        GpuCodec(level=1, device="cpu")


def test_only_level_1_is_ported():
    """Levels 1-4 (the hash matcher) are ported; the content levels
    5-12 are not."""
    for level in (5, 12):
        with pytest.raises(NotImplementedError):
            GpuCodec(level=level, device="cpu")
