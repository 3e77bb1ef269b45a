"""The port's span recorder (runtime/stats.recording) and GpuCodec's
counters, on the CPU twins at small sizes: frames equal with recording on
and off, a well-formed span tree, exact counters under threads, nothing
made while recording is off, the spans in utils/profiling.trace's
Chrome trace, and full device entropy's literal counters and span. One
`cuda`-marked case drives the card."""

import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu_torch import oracle
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.runtime import stats
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import (COUNTERS,
                                                         QUEUE_DEPTH,
                                                         GpuCodec)
from qat_zstd_plugin_tpu_torch.utils import profiling

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 16384  # a small block, so that the twins take a few seconds
# Level 1 with host entropy (the hash matcher's claims, the extension
# walk) and level 9 with hybrid device entropy (the device's sections).
MODES = [(1, False), (9, "hybrid")]
# A child span lies inside the span that names its first part.
PARENT = {"submit.stage": "submit", "submit.h2d": "submit",
          "submit.enqueue": "submit", "collect.wait": "collect",
          "collect.d2h": "collect", "collect.unpack": "collect",
          "collect.blocks": "collect", "drain": "call", "assemble": "call",
          "submit": "call", "collect": "call"}


def _data(nfull: int, tail: int, seed: int) -> bytes:
    return make_corpus(nfull * BLOCK + tail, seed=seed)


@pytest.mark.parametrize("level,entropy", MODES)
def test_frames_equal_with_recording_on_and_off(level, entropy):
    data = _data(5, 3001, seed=11)
    codec = GpuCodec(level=level, batch=2, block_size=BLOCK, device="cpu",
                     device_entropy=entropy)
    off = codec.compress(data)
    with stats.recording() as spans:
        on = codec.compress(data)
    assert on == off and spans
    assert oracle.decompress(on, len(data)) == data


@pytest.mark.parametrize("level,entropy", MODES)
def test_span_tree(level, entropy):
    """Children lie inside their parent on the same thread and call; one
    submit and one collect a batch; one block.host (and block.queue) a
    block, the tail's included, each with a route; call ids group each
    request, the pool's spans included."""
    sizes = [5 * BLOCK + 3001, 2 * BLOCK + 40]
    codec = GpuCodec(level=level, batch=2, block_size=BLOCK, device="cpu",
                     device_entropy=entropy)
    with stats.recording() as spans:
        for k, n in enumerate(sizes):
            codec.compress(_data(0, n, seed=20 + k))
    calls = [sp for sp in spans if sp.name == "call"]
    assert [sp.attrs["bytes"] for sp in calls] == sizes
    assert len({sp.call for sp in calls}) == 2
    for call, n in zip(calls, sizes):
        mine = [sp for sp in spans if sp.call == call.call]
        names = Counter(sp.name for sp in mine)
        batches = -(-(n // BLOCK) // 2)
        blocks = -(-n // BLOCK)
        assert names["submit"] == names["collect"] == batches
        for child in ("submit.h2d", "submit.enqueue", "collect.wait",
                      "collect.d2h", "collect.unpack", "collect.blocks"):
            assert names[child] == batches, child
        assert names["block.host"] == names["block.queue"] == blocks
        assert names["drain"] == names["assemble"] == 1
        assert sorted(sp.index for sp in mine if sp.name == "block.host") \
            == list(range(blocks))
        assert sorted(sp.index for sp in mine if sp.name == "submit") \
            == list(range(batches))
        routes = {sp.index: sp.attrs["route"] for sp in mine
                  if sp.name == "block.host"}
        assert routes[blocks - 1] == "host_match"  # the tail
        full = {routes[i] for i in range(blocks - 1)}
        assert full <= ({"sections", "sections_literals", "host_match"}
                        if entropy else {"extend", "hinted", "host_match"})
        for sp in mine:
            assert sp.start_ns <= sp.end_ns and sp.cpu_ns >= 0
            if sp.name not in PARENT:
                continue
            up = [p for p in mine if p.name == PARENT[sp.name]
                  and p.thread == sp.thread
                  and p.start_ns <= sp.start_ns <= sp.end_ns <= p.end_ns]
            assert len(up) == 1, sp
            if up[0].name != "call":
                assert sp.index == up[0].index
        assert all(call.start_ns <= sp.start_ns and sp.end_ns <= call.end_ns
                   for sp in mine if sp.name != "block.queue")


@pytest.mark.parametrize("level,entropy", MODES)
def test_counters_exact_with_threads_sharing_a_codec(level, entropy):
    data = _data(5, 3001, seed=31)
    one = GpuCodec(level=level, batch=2, block_size=BLOCK, device="cpu",
                   device_entropy=entropy)
    frame = one.compress(data)
    c1 = one.counters()
    assert c1["batches"] == 3 and c1["batch_rows"] == 5
    assert c1["padded_rows"] == 1 and c1["tail_blocks"] == 1
    assert c1["h2d_bytes"] == 3 * (2 * BLOCK + 2 * 4)
    assert c1["d2h_bytes"] > 0
    assert c1["inflight_sum"] == 1 + 2 + 3  # one caller: depth 1, 2, 3
    assert QUEUE_DEPTH == 3
    shared = GpuCodec(level=level, batch=2, block_size=BLOCK, device="cpu",
                      device_entropy=entropy)
    frames = []
    errors = []

    def work():
        try:
            frames.append(shared.compress(data))
        except Exception as e:  # reported below
            errors.append(e)
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors
    assert frames == [frame] * 4
    c4 = shared.counters()
    for name in COUNTERS:
        if name != "inflight_sum":
            assert c4[name] == 4 * c1[name], name
    # Each submit sees its own batch and at most every other one in flight.
    assert 4 * c1["inflight_sum"] <= c4["inflight_sum"] \
        <= 12 * 4 * QUEUE_DEPTH
    assert shared._inflight == 0


def test_recording_off_makes_nothing(monkeypatch):
    """Off, no span and no CUDA event is made, and nothing is recorded."""
    def refuse(*a, **k):
        raise AssertionError("made while recording is off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(stats.Span, "__init__", refuse)
    monkeypatch.setattr(stats.Recorder, "__init__", refuse)
    data = _data(3, 777, seed=41)
    assert stats.recorder() is None
    frame = GpuCodec(level=1, batch=2, block_size=BLOCK,
                     device="cpu").compress(data)
    assert oracle.decompress(frame, len(data)) == data


def test_recorder_event_and_nesting(monkeypatch):
    """While recording, a CUDA device gets an event recorded after its
    enqueue; a nested recording shares the outer one's list."""
    made = []

    class FakeEvent:
        def record(self):
            made.append(self)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    with stats.recording() as outer:
        rec = stats.recorder()
        assert rec.event(torch.device("cpu")) is None
        ev = rec.event(torch.device("cuda"))
        assert made == [ev]
        with stats.recording() as inner:
            with stats.span("drain"):
                stats.note("route", "x")
        assert inner is outer and stats.recorder() is rec
    assert stats.recorder() is None
    assert [(sp.name, sp.attrs) for sp in outer] == [("drain",
                                                      {"route": "x"})]


def test_spans_in_the_profilers_trace(tmp_path):
    """utils/profiling.trace records the port's spans, which show in its
    Chrome trace as record_function ranges."""
    data = _data(2, 999, seed=51)
    codec = GpuCodec(level=1, batch=2, block_size=BLOCK, device="cpu")
    with profiling.trace(str(tmp_path), device="cpu") as path:
        frame = codec.compress(data)
    assert oracle.decompress(frame, len(data)) == data
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    # The calling thread's spans; the profiler does not record the host
    # pool's threads, which start inside the region.
    assert {"call", "submit", "submit.h2d", "submit.enqueue", "collect",
            "collect.wait", "collect.unpack", "drain", "assemble"} <= names
    assert stats.recorder() is None


def test_loads_are_spans(monkeypatch):
    """A first load is a span "load.native", noting whether it built."""
    from qat_zstd_plugin_tpu_torch import native
    monkeypatch.setattr(native, "_lib", None)
    with stats.recording() as spans:
        native.load()
    assert [(sp.name, sp.attrs) for sp in spans] == [
        ("load.native", {"built": False})]


# Full device entropy: corpus blocks of this size carry 1024 literals or
# more, so that the device codes some of them.
FULL_BLOCK = 32768
LITERAL_COUNTERS = ("literal_blocks", "literal_declined",
                    "literal_unspanned", "literal_unfit")


def _full_data() -> bytes:
    """Four corpus blocks and a tail, the second block all zeros: its
    parse leaves it one literal, fewer than the device's 1024."""
    data = bytearray(make_corpus(4 * FULL_BLOCK + 3001, seed=71))
    data[FULL_BLOCK:2 * FULL_BLOCK] = bytes(FULL_BLOCK)
    return bytes(data)


def _spy_sections(codec) -> list:
    """Wrap codec.collect_batch; the returned list gets each device
    block's (sequences, sections) in block order."""
    got = []
    collect = codec.collect_batch

    def spy(handle):
        out = collect(handle)
        got.extend(out)
        return out
    codec.collect_batch = spy
    return got


@pytest.mark.parametrize("level", [5, 9])
def test_literal_counters_balance_in_full_mode(level):
    """Every block with a device section is counted once: with the
    device's literals section (literal_blocks, its bytes in
    literal_bytes) or under why not; the all-zero block is declined."""
    data = _full_data()
    codec = GpuCodec(level=level, batch=2, block_size=FULL_BLOCK,
                     device="cpu", device_entropy=True)
    got = _spy_sections(codec)
    frame = codec.compress(data)
    assert oracle.decompress(frame, len(data)) == data
    c = codec.counters()
    assert c["section_blocks"] == c["device_blocks"] == len(got) == 4
    assert sum(c[k] for k in LITERAL_COUNTERS) == c["section_blocks"]
    taken = [sec[0] for _, sec in got if sec[0] is not None]
    assert c["literal_blocks"] == len(taken) >= 1
    assert c["literal_bytes"] == sum(map(len, taken)) > 0
    # The zero block keeps the host's literals, and it is declined.
    assert got[1][1][0] is None
    assert c["literal_unspanned"] == c["literal_unfit"] == 0
    assert c["literal_declined"] >= 1


@pytest.mark.parametrize("entropy", ["hybrid", False])
def test_literal_counters_zero_without_full_mode(entropy):
    codec = GpuCodec(level=9, batch=2, block_size=FULL_BLOCK, device="cpu",
                     device_entropy=entropy)
    data = _full_data()
    assert oracle.decompress(codec.compress(data), len(data)) == data
    c = codec.counters()
    assert c["device_blocks"] == 4
    assert all(c[k] == 0 for k in LITERAL_COUNTERS + ("literal_bytes",))


@pytest.mark.parametrize("entropy", [True, "hybrid"])
def test_literals_span_once_a_batch_in_full_mode(entropy):
    """"submit.literals" lies inside each batch's "submit.enqueue" in full
    mode and is never made in hybrid mode; the frame is the same with
    recording on and off."""
    data = _full_data()
    codec = GpuCodec(level=9, batch=2, block_size=FULL_BLOCK, device="cpu",
                     device_entropy=entropy)
    off = codec.compress(data)
    with stats.recording() as spans:
        on = codec.compress(data)
    assert on == off and oracle.decompress(on, len(data)) == data
    lits = [sp for sp in spans if sp.name == "submit.literals"]
    enqueues = [sp for sp in spans if sp.name == "submit.enqueue"]
    assert len(enqueues) == 2
    if entropy == "hybrid":
        assert lits == []
        return
    assert len(lits) == len(enqueues)
    for sp, up in zip(lits, enqueues):
        assert sp.thread == up.thread and sp.index == up.index
        assert up.start_ns <= sp.start_ns <= sp.end_ns <= up.end_ns


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("level,entropy", MODES)
def test_recording_on_the_card(cuda, level, entropy):
    """On the card: the same frame on and off; collect.wait waits on the
    enqueue's event and the copies' bytes are counted; batch rows and
    padding balance."""
    data = _data(9, 5000, seed=61)
    codec = GpuCodec(level=level, batch=4, block_size=BLOCK, device="cuda",
                     device_entropy=entropy)
    off = codec.compress(data)
    before = codec.counters()
    with stats.recording() as spans:
        on = codec.compress(data)
    after = codec.counters()
    assert on == off and oracle.decompress(on, len(data)) == data
    names = Counter(sp.name for sp in spans)
    assert names["collect.wait"] == names["submit"] == 3
    assert after["batch_rows"] - before["batch_rows"] == 9
    assert after["padded_rows"] - before["padded_rows"] == 3
    d2h = sum(sp.attrs["bytes"] for sp in spans if sp.name == "collect.d2h")
    assert d2h == after["d2h_bytes"] - before["d2h_bytes"] > 0
    assert all(np.isfinite(sp.cpu_ns) for sp in spans)
