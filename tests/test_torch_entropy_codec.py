"""The port's device-entropy frames against the JAX package's, on the CPU:
hybrid mode at the hash levels 1 and 4 and the content level 5, the
entry point, the option's values, and the reference's B12 fault.

GpuCodec(device_entropy="hybrid", device="cpu") runs the kernels'
plain-torch twins and encodes each block's FSE Sequences_Section in torch;
TpuCodec(device_entropy="hybrid") runs the Pallas kernels in interpret
mode. The host adds the literals section in both through the same native
source, so the frames must be equal byte for byte at the same level,
batch size and max_seq, and stock libzstd must decode them. The exception
is the reference's B12 fill fault (test_reference_fault_frame*), where its
frame is corrupt and the port's is not. Levels 12 and 9 are in
test_torch_entropy_codec_deep.py and full device entropy in
test_torch_full_codec.py, so that no one file holds a test worker for
long.
"""

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu_torch import GpuCodec, compress
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.utils import config

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072
WINDOW = 32768

CASES = {  # level, full blocks, tail bytes, batch, max_seq
    "L1_8_blocks_tail_batch4": (1, 8, 5000, 4, 16384),
    "L4_4_blocks_tail_batch4": (4, 4, 5000, 4, 16384),
    "L5_4_blocks_batch4": (5, 4, 0, 4, 16384),
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


@pytest.mark.parametrize("value", ["bogus", 2, "Hybrid", None])
def test_bad_device_entropy_raises(value, monkeypatch):
    """None takes QZ_DEVICE_ENTROPY's value, here a bad one too."""
    monkeypatch.setenv("QZ_DEVICE_ENTROPY", "bogus")
    config.set(None)
    try:
        with pytest.raises(ValueError, match="device_entropy"):
            GpuCodec(level=1, device="cpu", device_entropy=value)
    finally:
        config.set(None)


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
