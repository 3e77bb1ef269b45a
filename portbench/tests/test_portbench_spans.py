"""portbench.spans, the program's spans and counters in a traced run:
its readings, the idle sweep and the clock check on made-up runs, and a
whole run of each cell on the CPU twins."""

import itertools
import random
import types

import pytest

from conftest import small_cell
from portbench.spans import (IDLE_ORDER, clock_check, device_split,
                             idle_by_span, p95_request, readings, traced)
from portbench.loops import Call, Window


def sp(name, start_s, end_s, cpu_s=0.0, call=1, **attrs):
    """A program span as runtime/stats.Span has it, in seconds here."""
    return types.SimpleNamespace(name=name, start_ns=round(start_s * 1e9),
                                 end_ns=round(end_s * 1e9),
                                 cpu_ns=round(cpu_s * 1e9), call=call,
                                 attrs=attrs)


# A window opening at perf_counter 10.0.
SPANS = [
    sp("load.native", 1.0, 1.01, call=0),                    # set-up
    sp("call", 1.005, 1.5, call=3), sp("collect.wait", 5.0, 5.1, call=3),
    sp("call", 10.0, 11.0), sp("submit.h2d", 10.01, 10.03),
    sp("submit.enqueue", 10.03, 10.05), sp("collect", 10.1, 10.3),
    sp("collect.wait", 10.1, 10.101), sp("collect.d2h", 10.101, 10.111),
    sp("collect.unpack", 10.111, 10.2), sp("collect.blocks", 10.2, 10.29),
    sp("block.host", 10.3, 10.5, cpu_s=0.15, route="extend"),
    sp("block.host", 10.3, 10.4, cpu_s=0.05, route="host_match"),
    sp("drain", 10.5, 10.6),
] + [sp(n, s, e, call=2) for n, s, e in [
    ("call", 11.0, 11.9), ("submit.h2d", 11.01, 11.02),
    ("submit.enqueue", 11.02, 11.06), ("collect", 11.1, 11.2),
    ("collect.wait", 11.1, 11.103), ("collect.d2h", 11.103, 11.108),
    ("collect.unpack", 11.108, 11.15), ("collect.blocks", 11.15, 11.19),
    ("drain", 11.3, 11.5)]]
COUNTERS = {"h2d_bytes": 6 * 10**7, "d2h_bytes": 3 * 10**7,
            "tail_blocks": 3, "overflow_blocks": 1, "blocks": 16}


def test_readings():
    idle = dict.fromkeys(IDLE_ORDER + ("between_calls",), 0.0)
    idle.update({"collect.wait": 3.0, "call": 0.5, "between_calls": 0.5})
    got = readings(SPANS, COUNTERS, 10.0, idle)
    want = {"collect_wait_ms_per_batch": 2.0,
            "unpack_ms_per_batch": (0.089 + 0.042 + 0.09 + 0.04) / 2 * 1e3,
            "h2d_gbs": 6 * 10**7 / 0.03 / 1e9,
            "d2h_gbs": 3 * 10**7 / 0.015 / 1e9,
            "enqueue_ms_per_batch": 30.0,
            "host_half_cpu_pct": 100 * 0.2 / 0.3,
            "drain_ms_per_call": 150.0, "host_matched_pct": 25.0,
            "setup_program_s": 0.5 + 0.1, "idle_unexplained_pct": 25.0,
            "collect_ms_per_batch_program": 150.0}
    assert got == pytest.approx(want, rel=1e-6)
    none = readings([], dict(COUNTERS, blocks=0), 10.0, None)
    assert set(none) == set(want)
    assert none["setup_program_s"] == 0
    assert all(v is None for k, v in none.items() if k != "setup_program_s")


def test_p95_request_by_span():
    calls = [Call(b"x" * 5, 0.0, 1.0), Call(b"y" * 7, 1.0, 1.9)]
    got = p95_request(Window(calls, 10.0, 2.0), SPANS)
    assert got["seconds"] == pytest.approx(1.0) and got["bytes"] == 5
    split = got["by_span"]
    assert split["call"] == pytest.approx(1.0)
    assert split["collect"] == pytest.approx(0.2)
    assert split["call_self"] == pytest.approx(1.0 - 0.2 - 0.1)


def test_idle_by_span_order():
    gaps = [[0.0, 1.0], [2.0, 3.0], [4.0, 6.0]]
    prog = [(0.0, 10.0, "call"), (0.2, 0.4, "block.host"),
            (0.3, 0.5, "collect.unpack"), (0.3, 0.35, "submit.enqueue"),
            (0.45, 0.6, "collect"), (2.5, 2.75, "drain"),
            (2.6, 2.7, "block.queue"), (5.0, 7.0, "load.native")]
    got = idle_by_span(gaps, sorted(prog))
    want = {"call": 0.2 + 0.4 + 0.5 + 0.25 + 2.0, "block.host": 0.1,
            "submit.enqueue": 0.05, "collect.unpack": 0.15, "collect": 0.1,
            "drain": 0.25}
    assert sum(got.values()) == pytest.approx(4.0)
    for k in got:
        assert got[k] == pytest.approx(want.get(k, 0.0)), k
    # With no span open at all, the idle time is between calls.
    assert idle_by_span(gaps, [])["between_calls"] == pytest.approx(4.0)


def _idle_by_span_naive(gaps, prog):
    """The same, by testing each piece between every edge against every
    span."""
    points = sorted({x for g in gaps for x in g}
                    | {x for s, e, _ in prog for x in (s, e)})
    out = dict.fromkeys(IDLE_ORDER + ("between_calls",), 0.0)
    for lo, hi in itertools.pairwise(points):
        mid = (lo + hi) / 2
        if not any(a <= mid < b for a, b in gaps):
            continue
        open_now = {n for s, e, n in prog if s <= mid < e}
        key = next((n for n in IDLE_ORDER if n in open_now), "between_calls")
        out[key] += hi - lo
    return out


@pytest.mark.parametrize("seed", range(5))
def test_idle_by_span_matches_the_naive_count(seed):
    rnd = random.Random(seed)
    edges = sorted(rnd.uniform(0, 100) for _ in range(40))
    gaps = [edges[i:i + 2] for i in range(0, 40, 2)]
    names = list(IDLE_ORDER) + ["load.kernels"]
    prog = []
    for _ in range(300):
        s = rnd.uniform(-5, 105)
        prog.append((s, s + rnd.expovariate(0.3), rnd.choice(names)))
    got = idle_by_span(gaps, sorted(prog))
    want = _idle_by_span_naive(gaps, prog)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


# Copies in profiler seconds; each lies inside its host span at offset
# TRUE (perf_counter = profiler + TRUE).
TRUE = 100.0
HOST = [(110.000, 110.010, "submit.h2d"), (110.010, 110.030,
                                           "submit.enqueue"),
        (110.040, 110.060, "collect.d2h"), (110.060, 110.070,
                                            "collect.unpack"),
        (110.100, 110.120, "submit.h2d"), (110.140, 110.150, "collect.d2h"),
        (110.000, 110.030, "submit"), (110.040, 110.080, "collect"),
        (110.100, 110.130, "submit"), (110.140, 110.160, "collect"),
        (109.9, 110.2, "call"), (110.0, 110.2, "block.host")]
COPY = [(10.001, 10.009, "Memcpy HtoD (Pageable -> Device)"),
        (10.020, 10.021, "Memcpy DtoH (Device -> Pageable)"),
        (10.041, 10.058, "Memcpy DtoH (Device -> Pageable)"),
        (10.101, 10.118, "Memcpy HtoD (Pageable -> Device)"),
        (10.141, 10.149, "Memcpy DtoH (Device -> Pageable)"),
        (10.050, 10.090, "some_kernel")]


UNDER = {"DtoH collect.d2h": 2, "DtoH submit.enqueue": 1,
         "HtoD submit.h2d": 2}


def test_clock_check_with_a_sound_mark():
    c = clock_check(COPY, sorted(HOST), TRUE + 20e-6, 109.0, 111.0)
    assert c["copies"] == 5 and c["outside"] == c["outside_at_mark"] == 0
    assert c["under"] == UNDER
    assert c["dtoh"] == c["dtoh_fitted"] == 3 and c["mapped_by"] == "mark"
    assert c["offset_s"] == TRUE + 20e-6 and abs(c["moved_us"]) <= 100


@pytest.mark.parametrize("early_ms", [3, 30])
def test_clock_check_refits_a_wrong_mark(early_ms):
    """A mark some ms early leaves copies outside every span; the DtoH
    copies' best fit inside the spans that make them (not inside
    collect.unpack, say) puts all five back, and the mapping takes it."""
    host = sorted(HOST + [(109.9, 110.0, "collect.unpack")])
    c = clock_check(COPY, host, TRUE - early_ms / 1e3, 109.0, 111.0)
    assert c["outside_at_mark"] > 0 and c["dtoh_fitted"] == 3
    assert c["mapped_by"] == "best_fit" and c["outside"] == 0
    assert c["under"] == UNDER
    assert c["moved_us"] == pytest.approx(1e3 * early_ms, abs=1000)
    again = clock_check(COPY, host, c["offset_s"], 109.0, 111.0)
    assert again["outside"] == 0 and again["mapped_by"] == "mark"


def test_device_split_maps_by_the_best_fit():
    """The first device event is the mark kernel, launched 4 ms before
    its device start: the copies refit the mapping, and every idle
    second of the window is put down to some name."""
    mark_us = 9.999e6
    events = [(mark_us, mark_us + 1, "mark")] + [
        (s * 1e6, e * 1e6, n) for s, e, n in COPY]
    align_ns = round((mark_us / 1e6 + TRUE - 4e-3) * 1e9)
    d = device_split(events, align_ns, 110.0, 110.2, sorted(HOST))
    assert d["clock"]["mapped_by"] == "best_fit"
    assert d["clock"]["outside_at_mark"] > 0 == d["clock"]["outside"]
    # Mapped by the fit: 8 + 1 + 49 (a copy and a kernel) + 17 + 8 ms.
    assert d["busy_s"] == pytest.approx(0.083, abs=1e-3)
    assert sum(d["idle_by_span"].values()) == pytest.approx(
        0.2 - d["busy_s"])


@pytest.mark.parametrize("name", ["l1.bulk", "l9hyb.objects"])
def test_a_traced_window_on_the_cpu(name):
    """A short window of each cell on the twins: every reading that needs
    no card is there, the counters balance against the harness's rows,
    and the program's collect agrees with the harness's."""
    out = traced(small_cell(name), 2 ** 31 + 99, 1.0, device="cpu")
    m = out["metrics"]
    for k in ("collect_wait_ms_per_batch", "unpack_ms_per_batch",
              "h2d_gbs", "d2h_gbs", "enqueue_ms_per_batch",
              "host_half_cpu_pct", "drain_ms_per_call", "setup_program_s",
              "collect_ms_per_batch", "batch_fill_pct"):
        assert m[k] is not None and m[k] > 0, k
    assert m["idle_unexplained_pct"] is None and "clock" not in out
    assert m["collect_ms_per_batch_program"] == pytest.approx(
        m["collect_ms_per_batch"], rel=0.25)
    assert m["batch_fill_pct_program"] == pytest.approx(m["batch_fill_pct"])
    c = out["counters"]
    assert c["batch_rows"] == c["device_blocks"] > 0
    assert c["blocks"] == out["by_span"]["block.host"]["n"]
    assert sum(out["routes"].values()) == c["blocks"]
    assert out["routes"].get("host_match", 0) == \
        c["tail_blocks"] + c["overflow_blocks"]
    assert out["p95_request"]["by_span"]["call"] > 0
