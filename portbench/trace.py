"""The traced run's instruments: spans the harness wraps around the
program's calls into its layers, and the device's activity from
torch.profiler.

`Recorder` sets wrappers on one codec instance (never on the class) in
the traced run only: `compress` (span "call"), `submit_batch` ("submit",
and the real rows and contract bytes of each batch), `collect_batch`
("collect", which includes the wait for the batch's device work) and
`finish_block_host` ("host_half", on the host pool's threads). Spans are
kept in memory with perf_counter_ns stamps.

`device_activity` reads the profiler's CUDA events (the profiler records
the device alone, which keeps a traced run's cost and reading short):
the union of kernel and copy intervals (busy), of kernel intervals
alone, the device operations with the most time, and the idle gaps
between busy intervals, each labelled by the harness span open on the
host at its start. The profiler's clock is tied to perf_counter by one
small kernel, `mark`, launched on an idle card just before the window.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .roofline import device_half_bytes

# A gap is labelled with the first of these spans open at its start.
LABELS = ("collect", "submit", "host_half", "call")


@dataclass
class Recorder:
    spans: list = field(default_factory=list)    # (name, t0_ns, t1_ns)
    batches: list = field(default_factory=list)  # (rows, batch, bytes)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def span(self, name: str, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **k)
            finally:
                t1 = time.perf_counter_ns()
                with self._lock:
                    self.spans.append((name, t0, t1))
        return wrapped

    def instrument(self, codec) -> None:
        submit = self.span("submit", codec.submit_batch)

        def submit_batch(blocks_np, lengths_np):
            handle = submit(blocks_np, lengths_np)
            rows = handle[0]
            with self._lock:
                self.batches.append((rows, codec.batch, device_half_bytes(
                    rows, codec.batch, blocks_np.shape[1], handle[2])))
            return handle
        codec.submit_batch = submit_batch
        codec.collect_batch = self.span("collect", codec.collect_batch)
        codec.finish_block_host = self.span("host_half",
                                            codec.finish_block_host)
        codec.compress = self.span("call", codec.compress)

    def seconds(self, name: str) -> list[float]:
        return [(t1 - t0) / 1e9 for n, t0, t1 in self.spans if n == name]


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(merged, lo: float, hi: float) -> list[list[float]]:
    return [[max(s, lo), min(e, hi)] for s, e in merged if e > lo and s < hi]


def mark(device) -> int:
    """Launch one small kernel on the idle card; returns the host's
    perf_counter_ns at the launch, which its device start follows within
    microseconds."""
    import torch
    torch.cuda.synchronize(device)
    t = time.perf_counter_ns()
    torch.zeros(1, device=device)
    return t


def device_activity(prof, rec: Recorder, align_ns: int, open_s: float,
                    close_s: float) -> dict | None:
    """Device activity over the window [open_s, close_s] (perf_counter
    seconds), the trace's first device event being `mark`'s kernel; None
    where the profiler saw no device operation."""
    from torch.autograd import DeviceType
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev:
        return None
    # Profiler microseconds -> perf_counter seconds.
    shift = align_ns / 1e9 - dev[0].time_range.start / 1e6
    iv = [(e.time_range.start / 1e6 + shift, e.time_range.end / 1e6 + shift,
           e.name) for e in dev]
    busy = _clip(_union([(s, e) for s, e, _ in iv]), open_s, close_s)
    kern = _clip(_union([(s, e) for s, e, n in iv
                         if not n.startswith(("Memcpy", "Memset"))]),
                 open_s, close_s)
    per_op: dict[str, float] = {}
    for s, e, n in iv:
        if e > open_s and s < close_s:
            per_op[n[:96]] = per_op.get(n[:96], 0.0) + e - s
    edges = [open_s] + [x for iv_ in busy for x in iv_] + [close_s]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted((t0 / 1e9, t1 / 1e9, n) for n, t0, t1 in rec.spans)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy),
        "kernel_busy_s": sum(e - s for s, e in kern),
        "window_s": close_s - open_s,
        "device_ops": sorted(per_op.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[_label(spans, s), e - s] for s, e in longest],
    }


def _label(spans: list[tuple[float, float, str]], t: float) -> str:
    open_now = {n for s, e, n in spans if s <= t < e}
    for name in LABELS:
        if name in open_now:
            return name
    return "between_calls"
