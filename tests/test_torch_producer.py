"""The port's sequence producer and its libzstd-driven modes against the
JAX package's, on the CPU.

The port's producer (device="cpu": the kernels' plain-torch twins at
batch 1) must give the JAX package's device-route triples
(qz.sequence_producer with use_device=True: the Pallas kernels in
interpret mode), and the frames that stock libzstd makes from them,
one-shot and streaming, must be equal byte for byte and decode. Where
they differ by design: an exception in the port's producer is raised to
the caller once libzstd returns.
"""

import numpy as np
import pytest
import torch

import qat_zstd_plugin_tpu as qz
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import oracle
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072
LENGTHS = (131072, 70001, 4097, 64, 63)
DATA = make_corpus(3 * BLOCK + 5000, seed=13)


@pytest.fixture(scope="module")
def jax_states():
    """One JAX device-route state a level, kept for the module (each level
    compiles its batch-1 pipeline once)."""
    states = {}

    def get(level):
        if level not in states:
            states[level] = qz.create_seqprod_state(level, use_device=True)
        return states[level]
    return get


def _spans(triples, n: int) -> bool:
    return sum(lit + ml for _, lit, ml in triples) == n


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("level", [1, 4, 5])
def test_triples_equal_reference(jax_states, level, n):
    block = DATA[BLOCK - 1000:BLOCK - 1000 + n]
    state = qzt.create_seqprod_state(level, device="cpu")
    got = qzt.sequence_producer(state, block)
    assert got == qz.sequence_producer(jax_states(level), block)
    assert _spans(got, n) and got[-1][0] == got[-1][2] == 0
    device = n >= qzt.DEVICE_MIN_BLOCK
    assert (state.device_blocks, state.host_blocks) == (device, not device)
    assert state.errors == state.overflow_blocks == 0


@pytest.mark.parametrize("refusal", ["freed", "too_long", "small_window"])
def test_abi_refusals(refusal):
    state = qzt.create_seqprod_state(1, device="cpu")
    block, window = DATA[:4096], None
    if refusal == "freed":
        qzt.free_seqprod_state(state)
    elif refusal == "too_long":
        block = DATA[:BLOCK + 1]
    else:
        window = 4095
    assert qzt.sequence_producer(state, block, window) \
        is qzt.SEQUENCE_PRODUCER_ERROR
    assert state.errors == 0  # a refusal, not an exception
    assert qzt.sequence_producer(None, block) is qzt.SEQUENCE_PRODUCER_ERROR


@pytest.mark.parametrize("search_repcodes", [False, True])
@pytest.mark.parametrize("level", [1, 5])
def test_compress_via_libzstd_equals_reference(jax_states, level,
                                               search_repcodes):
    jax_states(level)  # compiled outside the frame
    want = qz.compress_via_libzstd(DATA, level=level, use_device=True,
                                   search_repcodes=search_repcodes)
    got = qzt.compress_via_libzstd(DATA, level=level, device="cpu",
                                   search_repcodes=search_repcodes)
    stats = oracle.last_producer_stats()
    assert stats == {"blocks": 4, "errors": 0}
    assert got == want
    assert oracle.decompress(got, len(DATA)) == DATA


@pytest.mark.parametrize("chunk, flush", [(64 * 1024, 0),
                                          (13 * 1024 + 7, 3), (1 << 20, 1)])
def test_stream_via_libzstd_equals_reference(jax_states, chunk, flush):
    jax_states(1)
    want = qz.compress_stream_via_libzstd(DATA, level=1, use_device=True,
                                          chunk_size=chunk,
                                          flush_every=flush)
    got = qzt.compress_stream_via_libzstd(DATA, level=1, device="cpu",
                                          chunk_size=chunk,
                                          flush_every=flush)
    stats = oracle.compress_stream_with_producer.last_stats
    assert stats["blocks"] > 0 and stats["errors"] == 0
    assert got == want
    assert oracle.decompress(got, len(DATA)) == DATA


@pytest.mark.parametrize("n", [0, 1, BLOCK + 1])
def test_stream_via_libzstd_edge_sizes(jax_states, n):
    jax_states(1)
    blob = DATA[:n]
    got = qzt.compress_stream_via_libzstd(blob, level=1, device="cpu",
                                          chunk_size=4096)
    assert got == qz.compress_stream_via_libzstd(
        blob, level=1, use_device=True, chunk_size=4096)
    assert oracle.decompress(got, n) == blob


def test_state_counts_blocks_by_route():
    """Through libzstd's streaming compressor with flushes: every block of
    64 bytes or more went through the device half, the others through the
    host matcher, and the triples of each block span it."""
    state = qzt.create_seqprod_state(1, device="cpu")
    sizes = []

    def produce(block, level, window):
        sizes.append(len(block))
        out = qzt.sequence_producer(state, block, window)
        assert _spans(out, len(block))
        return out

    data = DATA[:300000]
    frame = oracle.compress_stream_with_producer(
        data, produce, level=1, chunk_size=50000 + 40, flush_every=2)
    assert oracle.decompress(frame, len(data)) == data
    assert oracle.last_producer_stats() == {"blocks": len(sizes),
                                            "errors": 0}
    assert state.device_blocks == sum(s >= 64 for s in sizes)
    assert state.host_blocks == sum(s < 64 for s in sizes)
    assert state.errors == state.overflow_blocks == 0


@pytest.mark.parametrize("mode", ["one_shot", "stream"])
def test_device_error_raises(monkeypatch, mode):
    """An exception in the device half returns the producer error to
    libzstd, which would make the frame itself; the port's entry points
    raise it instead."""
    def broken(self, blocks, lengths):
        raise RuntimeError("device half failed")

    monkeypatch.setattr(GpuCodec, "produce_sequences", broken)
    state = qzt.create_seqprod_state(1, device="cpu")
    assert qzt.sequence_producer(state, DATA[:BLOCK]) \
        is qzt.SEQUENCE_PRODUCER_ERROR
    assert state.errors == 1 and "device half" in str(state.last_error)
    with pytest.raises(RuntimeError, match="device half failed"):
        if mode == "one_shot":
            qzt.compress_via_libzstd(DATA, level=1, device="cpu")
        else:
            qzt.compress_stream_via_libzstd(DATA, level=1, device="cpu",
                                            chunk_size=100000, flush_every=2)
    assert oracle.last_producer_stats()["errors"] > 0


@pytest.mark.parametrize("mode", ["one_shot", "stream"])
def test_failing_produce_falls_back_in_oracle(mode):
    """The oracle keeps the ABI's fallback: an always-failing produce
    still gets a valid frame from libzstd's own matcher."""
    data = DATA[:300000]
    if mode == "one_shot":
        frame = oracle.compress_with_producer(data, lambda *a: None,
                                              level=1, fallback=True)
    else:
        frame = oracle.compress_stream_with_producer(
            data, lambda *a: None, level=1, fallback=True,
            chunk_size=50000, flush_every=2)
    assert oracle.last_producer_stats()["errors"] > 0
    assert oracle.decompress(frame, len(data)) == data


def test_dictionary_degrades_cleanly():
    """Dictionary + registered producer: the producer refuses and libzstd
    matches the blocks itself, or libzstd rejects the pair outright;
    either way no corrupt frame."""
    rng = np.random.default_rng(11)
    dictionary = rng.integers(0, 256, 4096, np.uint8).tobytes()
    data = DATA[:200000]
    try:
        f = oracle.compress_with_producer_and_dict(
            data, None, dictionary, level=1, fallback=True)
    except oracle.ZstdOracleError:
        return  # libzstd fails fast: a clean rejection
    try:
        out = oracle.decompress(f, len(data))
    except oracle.ZstdOracleError:
        out = oracle.decompress_with_dict(f, dictionary, len(data))
    assert out == data
    assert oracle.last_producer_stats()["blocks"] == 0


def test_oracle_version_and_stock_baseline():
    assert oracle.version() >= 10504 and oracle.has_sequence_producer()
    stock = oracle.compress(DATA, level=1)
    assert oracle.roundtrip_ok(stock, DATA)
    assert not oracle.roundtrip_ok(stock[:-1], DATA)
