"""The port's hybrid device-entropy frames against the JAX package's at
the deep content levels, on the CPU: level 12, and level 9 at max_seq 1024
where every block overflows (see test_torch_entropy_codec.py, whose test
of the same name covers levels 1, 4 and 5).
"""

import pytest
import torch

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu_torch import GpuCodec
from qat_zstd_plugin_tpu_torch.corpus import make_corpus

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072

CASES = {  # level, full blocks, tail bytes, batch, max_seq
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
