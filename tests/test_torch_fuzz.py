"""Seeded fuzz of the port against the JAX package, on the CPU: the
counterpart of tests/test_fuzz.py (itself the analog of the reference's
test/fuzzing/qatseqprodfuzzer.c).

The adversarial buffers come from utils.corpora.adversarial, the port's
copy of tests/test_fuzz.py's `_gen` (the same bytes for the same seed).
Each goes through the port's device path with host entropy at every
level, through SoftwareCodec and through StreamCompressor; every frame
equals the JAX package's at the same settings byte for byte and decodes
through stock libzstd. Device entropy's fuzz is in
test_torch_fuzz_entropy.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.runtime.stream import StreamCompressor as JaxStream
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

from qat_zstd_plugin_tpu_torch import StreamCompressor, oracle
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec
from qat_zstd_plugin_tpu_torch.runtime.soft_codec import SoftwareCodec
from qat_zstd_plugin_tpu_torch.utils.corpora import (FUZZ_KINDS, FUZZ_SIZES,
                                                     adversarial)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_fuzz import _gen  # noqa: E402

torch.set_num_threads(2)  # six test workers share a few cores

# tests/test_fuzz.py's device-pipeline settings.
DEVICE_KW = dict(batch=2, block_size=16384, max_seq=4096)


@pytest.mark.parametrize("seed", range(6))
def test_adversarial_draws_gen_bytes(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(6):
        assert adversarial(a) == _gen(b)


def test_adversarial_kinds_and_sizes():
    """A chosen kind at a chosen size: every shape, the sizes asked for."""
    for kind in range(len(FUZZ_KINDS)):
        for n in (0, 1, 131073):
            got = adversarial(np.random.default_rng(kind), (n,), kind)
            assert len(got) == n
    assert max(FUZZ_SIZES) == 200000


@pytest.mark.parametrize("level", range(1, 13))
def test_fuzz_device_pipeline_equals_reference(level):
    """Each of the eight shapes at a size drawn from tests/test_fuzz.py's,
    with validate=True as tests/test_fuzz.py compresses them."""
    rng = np.random.default_rng(100 + level)
    port = GpuCodec(level=level, device="cpu", **DEVICE_KW)
    ref = TpuCodec(level=level, **DEVICE_KW)
    for kind in range(len(FUZZ_KINDS)):
        data = adversarial(rng, kind=kind)
        got = port.compress(data, validate=True)
        assert got == ref.compress(data, validate=True), \
            (level, FUZZ_KINDS[kind], len(data))
        assert oracle.decompress(got, len(data)) == data
    assert port.stats.fallback_blocks == 0


@pytest.mark.parametrize("seed", range(8, 16))
def test_fuzz_software_equals_reference(seed):
    rng = np.random.default_rng(seed)
    level = int(rng.integers(1, 13))
    port = SoftwareCodec(level)
    ref = TpuCodec(level=level, use_device=False)
    for _ in range(8):
        data = adversarial(rng)
        got = port.compress(data)
        assert got == ref.compress(data), (seed, len(data))
        assert oracle.decompress(got, len(data)) == data


def _stream(sc, chunks) -> bytes:
    out = bytearray()
    for c in chunks:
        out += sc.compress(c)
    return bytes(out + sc.finish())


@pytest.mark.parametrize("seed", range(20, 24))
def test_fuzz_stream_equals_reference(seed):
    """Chunks of adversarial shapes and sizes through StreamCompressor:
    the JAX package's stream on its device path gives the same frame."""
    rng = np.random.default_rng(seed)
    level = int(rng.integers(1, 13))
    chunks = [adversarial(rng) for _ in range(int(rng.integers(1, 6)))]
    kw = dict(level=level, block_size=32768, batch=2)
    got = _stream(StreamCompressor(device="cpu", **kw), chunks)
    assert got == _stream(JaxStream(use_device=True, **kw), chunks)
    data = b"".join(chunks)
    assert oracle.decompress(got, len(data)) == data
