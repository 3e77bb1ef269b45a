"""Property-based fuzz of the port (hypothesis) against the JAX package,
on the CPU: the counterparts of tests/test_property_fuzz.py, the
generative side of the reference's libFuzzer round-trip targets.

Arbitrary bytes through the device path (the twins) at levels 1, 2 and 4
with 2048-byte blocks, SoftwareCodec, compress_via_libzstd and the
native extension pass: frames equal the JAX package's and decode through
stock libzstd; the extension's output passes the port's
validate_sequences and the golden one. derandomize=True draws the same
examples every run, so the test count and the work never vary.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu.format.frame import BlockSequences as JaxSeqs
from qat_zstd_plugin_tpu.golden import matcher
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec

import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import native, oracle
from qat_zstd_plugin_tpu_torch.format import (BlockSequences,
                                              validate_sequences)
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec
from qat_zstd_plugin_tpu_torch.runtime.soft_codec import SoftwareCodec

torch.set_num_threads(2)  # six test workers share a few cores


def _settings(n: int):
    return settings(max_examples=n, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _payload():
    """tests/test_property_fuzz.py's strategy: raw bytes, repeated motifs,
    runs, joined."""
    raw = st.binary(min_size=0, max_size=6000)
    motif = st.builds(lambda m, k: m * k,
                      st.binary(min_size=1, max_size=96),
                      st.integers(1, 400))
    run = st.builds(lambda b, k: bytes([b]) * k,
                    st.integers(0, 255), st.integers(1, 5000))
    return st.lists(st.one_of(raw, motif, run), min_size=1, max_size=6) \
        .map(b"".join)


@pytest.mark.parametrize("level", [1, 2, 4])
def test_device_pipeline_equals_reference(level):
    """The hash matchers' device half (the twins) + the native host half,
    many 2048-byte blocks a frame (multi-block framing, context)."""
    kw = dict(level=level, batch=2, block_size=2048)
    port = GpuCodec(device="cpu", **kw)
    ref = TpuCodec(**kw)

    @_settings(40)
    @given(data=_payload())
    def check(data):
        f = port.compress(data)
        assert f == ref.compress(data)
        assert oracle.decompress(f, len(data)) == data

    check()


@pytest.mark.parametrize("level", [1, 3, 5, 9, 12])
def test_software_equals_reference(level):
    port = SoftwareCodec(level)
    ref = TpuCodec(level=level, use_device=False)

    @_settings(40)
    @given(data=_payload())
    def check(data):
        f = port.compress(data)
        assert f == ref.compress(data)
        assert oracle.decompress(f, len(data)) == data

    check()


@_settings(25)
@given(data=_payload())
def test_producer_via_libzstd_equals_reference(data):
    """The reference's deployment shape under generative inputs."""
    f = qzt.compress_via_libzstd(data, level=1, device="cpu")
    assert f == qz.compress_via_libzstd(data, level=1, use_device=True)
    assert oracle.decompress(f, len(data)) == data


@_settings(40)
@given(seqs=st.lists(
    st.tuples(st.integers(0, 300), st.integers(1, 70000),
              st.integers(3, 400)), max_size=40),
    blob=st.binary(min_size=400, max_size=4000))
def test_extend_never_corrupts(seqs, blob):
    """Arbitrary (even nonsensical) claimed sequences through the port's
    verify-extend pass give a byte-faithful, span-complete parse, by the
    port's validate_sequences and the golden one."""
    blk = np.frombuffer(blob, np.uint8)
    ll = np.array([s[0] for s in seqs], np.int64)
    of = np.array([s[1] for s in seqs], np.int64)
    ml = np.array([s[2] for s in seqs], np.int64)
    span = int(ll.sum() + ml.sum())
    if span > len(blk):
        return  # not a plausible device claim shape
    last = len(blk) - span
    ll2, of2, ml2, last2 = native.extend_sequences(blk, ll, of, ml, last)
    assert ll2.sum() + ml2.sum() + last2 == len(blk)
    validate_sequences(blk, BlockSequences(ll2, of2, ml2, last2))
    matcher.validate_sequences(blk, JaxSeqs(ll2, of2, ml2, last2))
