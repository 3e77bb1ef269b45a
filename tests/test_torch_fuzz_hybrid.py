"""Seeded fuzz of the port's device entropy against the JAX package, on
the CPU: utils.corpora.adversarial's shapes through GpuCodec with hybrid
device entropy at levels 1, 4 and 9, and with full device entropy at
level 9, at tests/test_fuzz.py's device-pipeline settings (full at
levels 1 and 4: test_torch_fuzz_full.py; the split keeps each file's
JAX compiles under a minute and a half).

Every frame decodes through stock libzstd. It equals TpuCodec's frame at
the same settings, except where the reference's frame is corrupt: there
libzstd must refuse the reference's frame. Those are the two reference
faults the port repairs (ROADMAP.md, section C): B12's fill, which reads
a missing neighbour as a match (hybrid and full), and B15's
16384-position window (full, content levels).
"""

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

from qat_zstd_plugin_tpu_torch import oracle
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec
from qat_zstd_plugin_tpu_torch.utils.corpora import FUZZ_KINDS, adversarial

torch.set_num_threads(2)  # six test workers share a few cores

DEVICE_KW = dict(batch=2, block_size=16384, max_seq=4096)
# A level's inputs: four full blocks (two batches), two and a tail (one
# padded batch), and one short of a block (the host's alone).
SIZES = (65536, 32773, 16383)


def fuzz_device_entropy(entropy, level: int) -> int:
    """The level's inputs, the eight shapes in turn over the levels;
    returns how many frames differ from the reference's (each corrupt)."""
    rng = np.random.default_rng(200 + level + 10 * (entropy is True))
    port = GpuCodec(level=level, device="cpu", device_entropy=entropy,
                    **DEVICE_KW)
    ref = TpuCodec(level=level, device_entropy=entropy, **DEVICE_KW)
    differ = 0
    for j, n in enumerate(SIZES):
        kind = (len(SIZES) * level + j) % len(FUZZ_KINDS)
        data = adversarial(rng, (n,), kind)
        got = port.compress(data)
        assert oracle.decompress(got, len(data)) == data, \
            (FUZZ_KINDS[kind], n)
        want = ref.compress(data)
        if ref.fallback_batches:
            # The reference re-matched a failed device batch on the CPU,
            # so this is not its device frame: take it from a new codec.
            ref = TpuCodec(level=level, device_entropy=entropy, **DEVICE_KW)
            want = ref.compress(data)
            assert not ref.fallback_batches
        if got != want:
            differ += 1
            try:
                ok = oracle.decompress(want, n) == data
            except oracle.ZstdOracleError:
                ok = False
            assert not ok, ("the frames differ where the reference's "
                            f"decodes: {FUZZ_KINDS[kind]}, {n} bytes")
    assert port.stats.fallback_blocks == 0
    assert port.device_blocks == sum(n // 16384 for n in SIZES)
    return differ


@pytest.mark.parametrize("level", [1, 4, 9])
def test_fuzz_hybrid(level):
    fuzz_device_entropy("hybrid", level)


def test_fuzz_full_content_level():
    fuzz_device_entropy(True, 9)
