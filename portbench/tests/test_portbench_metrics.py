"""The metric arithmetic on made-up runs: the window's rate, the tail
over all requests, the ratio, the device's busy union and idle gaps, the roofline's
bytes."""

import math
import types

import numpy as np
import pytest
import torch

from portbench.loops import Call, Window
from portbench.run import reader


def run_of(calls, seconds, **kw):
    return types.SimpleNamespace(window=Window(calls, 0.0, seconds), **kw)


def call(n, start, end, out=None):
    return Call(np.zeros(n, np.uint8), start, end,
                b"x" * (out if out is not None else n // 4))


def test_compress_mbs_counts_completed_calls_over_the_window():
    calls = [call(2_000_000, 0, 1.0), call(2_000_000, 1, 2.5),
             Call(np.zeros(10**9, np.uint8), 2.5, None, None)]
    assert reader("compress_mbs")(run_of(calls, 2.5)) == \
        pytest.approx(4_000_000 / 2.5 / 1e6)


def test_request_p95_is_nearest_rank_over_all_requests():
    calls = [call(10, i, i + (i + 1) / 1000) for i in range(100)]
    assert reader("request_p95_ms")(run_of(calls, 100)) == \
        pytest.approx(95.0)
    # A missing request sorts above every other one.
    calls[0] = Call(np.zeros(10, np.uint8), 0, None)
    assert reader("request_p95_ms")(run_of(calls, 100)) == \
        pytest.approx(96.0)
    for c in calls[:6]:
        c.end, c.frame = None, None
    assert reader("request_p95_ms")(run_of(calls, 100)) is None


def test_ratio_counts_every_frame():
    calls = [call(1000, 0.5, 1, 250), call(3000, 1.01, 2, 600),
             Call(np.zeros(10**6, np.uint8), 2, None, None)]
    assert reader("ratio_pct")(run_of(calls, 2)) == pytest.approx(21.25)


def test_span_and_counter_metrics():
    from portbench.trace import Recorder
    rec = Recorder()
    rec.spans = [("collect", 0, 2_000_000), ("collect", 0, 4_000_000),
                 ("submit", 0, 9)]
    rec.batches = [(3, 64, 0), (64, 64, 0), (1, 64, 0)]
    r = types.SimpleNamespace(rec=rec, host_before=(1.0, 10**9),
                              host_after=(3.0, 5 * 10**9))
    assert reader("collect_ms_per_batch.bulk")(r) == pytest.approx(3.0)
    assert reader("batch_fill_pct.objects")(r) == pytest.approx(
        100 * 68 / 192)
    assert reader("host_half_s_per_gb.bulk")(r) == pytest.approx(0.5)


class Ev:
    def __init__(self, name, s, e, cuda=True):
        from torch.autograd import DeviceType
        self.name = name
        self.time_range = types.SimpleNamespace(start=s, end=e)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU


def test_device_activity_union_gaps_and_labels():
    """The first device event (the mark) at profiler microsecond 1000 is
    perf_counter second 10.0."""
    from portbench.trace import Recorder, device_activity
    prof = types.SimpleNamespace(events=lambda: [
        Ev("cpu_op", 0, 5, cuda=False),
        Ev("kernel_a", 1000 + 100_000, 1000 + 300_000),     # 10.1-10.3
        Ev("Memcpy HtoD", 1000 + 200_000, 1000 + 400_000),  # 10.2-10.4
        Ev("kernel_b", 1000 + 700_000, 1000 + 800_000),     # 10.7-10.8
        Ev("mark", 1000, 1000),                             # 10.0
    ])
    rec = Recorder()
    rec.spans = [("call", int(10.0e9), int(11.0e9)),
                 ("collect", int(10.45e9), int(10.65e9))]
    d = device_activity(prof, rec, int(10e9), 10.0, 11.0)
    assert d["busy_s"] == pytest.approx(0.4)
    assert d["kernel_busy_s"] == pytest.approx(0.3)
    assert d["window_s"] == pytest.approx(1.0)
    gaps = sorted((round(s, 6), n) for n, s in d["idle_gaps"])
    assert gaps == [(0.1, "call"), (0.2, "call"), (0.3, "call")]
    assert d["device_ops"][0][0] == "kernel_a"
    r = types.SimpleNamespace(device=d, rec=types.SimpleNamespace(
        batches=[(1, 2, 3.35e12 * 0.3 * 0.01)]), kind="NVIDIA H100 80GB HBM3")
    assert reader("device_idle_pct.bulk")(r) == pytest.approx(60.0)
    assert reader("device_half_roofline_pct.bulk")(r) == pytest.approx(1.0)
    r.kind = "an unknown card"
    assert reader("device_half_roofline_pct.bulk")(r) is None


def test_contract_bytes_count_real_rows_once():
    from portbench.roofline import device_half_bytes, tensor_bytes
    out = (torch.zeros(64, 100, dtype=torch.int32),
           {"a": torch.zeros(64, dtype=torch.int64), "b": None})
    assert tensor_bytes(out) == 64 * 400 + 64 * 8
    assert device_half_bytes(16, 64, 131072, out) == \
        16 * 131072 + (64 * 408) * 16 // 64
    assert math.isclose(device_half_bytes(64, 64, 8, out), 64 * 8 + 64 * 408)
