"""Per-block counters of the port: copies of `BlockStats` and `Timer` from
qat_zstd_plugin_tpu.utils.profiling; and the port's span recorder.

The recorder is process-wide and off by default. `recording()` switches
it on for a region and yields the list its spans go to, complete when
the region ends:

    with stats.recording() as spans:
        codec.compress(data)
    for sp in spans:
        print(sp.name, sp.call, sp.index, sp.end_ns - sp.start_ns)

Each span holds its name, a call id (one per GpuCodec.compress, shared
by every span of that request, the host pool's included), a batch or
block index, the thread, its start and end (time.perf_counter_ns), the
thread CPU time it took (time.thread_time_ns) and a few attributes.
While a torch profiler runs, a span that one thread opens and closes is
also a torch.profiler.record_function range, so the profiler's trace
(utils/profiling.trace) shows it on the profiler's own clock; without a
profiler the range, which costs more than the span, is left out. Off, a
site costs one `is None` check: no span, no clock, no event.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
from dataclasses import dataclass, field

# Per-block latency buckets: geometric x1.05 from 1 us, 200 buckets.
_NB_BUCKETS = 200
_GROWTH = 1.05


@dataclass
class BlockStats:
    """Thread-safe per-block accounting with a latency histogram."""
    blocks: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    fallback_blocks: int = 0
    raw_blocks: int = 0
    total_seconds: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    _buckets: list = field(default_factory=lambda: [0] * _NB_BUCKETS,
                           repr=False)

    def record(self, in_bytes: int, out_bytes: int | None,
               seconds: float, fallback: bool = False) -> None:
        us = max(seconds * 1e6, 1.0)
        idx = min(int(math.log(us, _GROWTH)), _NB_BUCKETS - 1)
        with self._lock:
            self.blocks += 1
            self.input_bytes += in_bytes
            if out_bytes is None:
                self.raw_blocks += 1
                self.output_bytes += in_bytes
            else:
                self.output_bytes += out_bytes
            self.total_seconds += seconds
            self._buckets[idx] += 1
            if fallback:
                self.fallback_blocks += 1

    def latency_percentile(self, p: float) -> float:
        """Approximate per-block latency percentile in microseconds
        (bucket upper edge), from the geometric histogram."""
        with self._lock:
            target = self.blocks * p / 100.0
            acc = 0
            for i in range(_NB_BUCKETS):
                acc += self._buckets[i]
                if acc >= target and target > 0:
                    return _GROWTH ** (i + 1)
        return 0.0

    def summary(self) -> dict:
        pcts = {f"P{p}": round(self.latency_percentile(p), 1)
                for p in (50, 99)} if self.blocks else {}
        with self._lock:
            mbs = (self.input_bytes / self.total_seconds / 1e6
                   if self.total_seconds else 0.0)
            return {
                "blocks": self.blocks,
                "ratio": (self.output_bytes / self.input_bytes
                          if self.input_bytes else 1.0),
                "fallback_blocks": self.fallback_blocks,
                "raw_blocks": self.raw_blocks,
                "throughput_mbs": round(mbs, 1),
                "block_latency_us": pcts,
            }


class Timer:
    """Wall time of a region: `elapsed` seconds, and its perf_counter_ns
    stamps `t0` and `t1`, which a span can take."""
    __slots__ = ("t0", "t1", "elapsed")

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        self.elapsed = (self.t1 - self.t0) / 1e9
        return False


class Span:
    """One recorded span (see the module's docstring). index is -1 for a
    span of no batch or block; call is 0 outside a call."""
    __slots__ = ("name", "call", "index", "thread", "start_ns", "end_ns",
                 "cpu_ns", "attrs", "_cpu0", "_range")

    def __init__(self, name: str, call: int, index: int, start_ns: int,
                 end_ns: int, attrs: dict):
        self.name, self.call, self.index = name, call, index
        self.thread = threading.get_ident()
        self.start_ns, self.end_ns, self.cpu_ns = start_ns, end_ns, 0
        self.attrs = attrs

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, call={self.call}, index={self.index}, "
                f"{(self.end_ns - self.start_ns) / 1e6:.3f} ms, {self.attrs})")


class Recorder:
    """The spans of one recording. A span that a thread opens takes the
    call id and index of the innermost span open on that thread unless
    it is given them; a "call" span takes a new call id."""

    def __init__(self):
        from torch.autograd import _profiler_enabled
        from torch.profiler import record_function
        self._range = record_function
        self._profiling = _profiler_enabled
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._calls = itertools.count(1)

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def call_id(self) -> int:
        """The call id of the innermost span open on this thread, or 0."""
        st = self._stack()
        return st[-1].call if st else 0

    def begin(self, name: str, index: int = -1, call: int | None = None,
              **attrs) -> Span:
        st = self._stack()
        if name == "call":
            call = next(self._calls)
        elif call is None:
            call = st[-1].call if st else 0
        if index < 0 and st:
            index = st[-1].index
        sp = Span(name, call, index, 0, 0, attrs)
        sp._range = None
        if self._profiling():
            sp._range = self._range(name)
            sp._range.__enter__()
        st.append(sp)
        sp._cpu0 = time.thread_time_ns()
        sp.start_ns = time.perf_counter_ns()
        return sp

    def end(self, sp: Span, start_ns: int | None = None,
            end_ns: int | None = None) -> None:
        """Close sp, which this thread opened, now or at the given
        perf_counter_ns stamps (a Timer's)."""
        sp.end_ns = time.perf_counter_ns() if end_ns is None else end_ns
        sp.cpu_ns = time.thread_time_ns() - sp._cpu0
        if start_ns is not None:
            sp.start_ns = start_ns
        self._stack().remove(sp)
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        with self._lock:
            self.spans.append(sp)

    @contextlib.contextmanager
    def span(self, name: str, index: int = -1, call: int | None = None,
             **attrs):
        sp = self.begin(name, index, call, **attrs)
        try:
            yield sp
        finally:
            self.end(sp)

    def add(self, name: str, call: int, index: int, start_ns: int,
            end_ns: int, **attrs) -> None:
        """A span timed elsewhere, which may start on one thread and end
        on another (block.queue): no CPU time, no profiler range."""
        sp = Span(name, call, index, start_ns, end_ns, attrs)
        with self._lock:
            self.spans.append(sp)

    def note(self, key: str, value) -> None:
        """Set an attribute of the innermost span open on this thread."""
        st = self._stack()
        if st:
            st[-1].attrs[key] = value

    @staticmethod
    def event(device):
        """A CUDA event recorded now on the current stream, for a later
        span to wait on; None on any other device."""
        if device.type != "cuda":
            return None
        import torch
        ev = torch.cuda.Event()
        ev.record()
        return ev


_recorder: Recorder | None = None
_switch = threading.Lock()
_OFF = contextlib.nullcontext()


def recorder() -> Recorder | None:
    """The recording under way, or None."""
    return _recorder


@contextlib.contextmanager
def recording():
    """Record the process's spans over the region; yields the list they
    go to, complete when the region ends. Nested, it yields the
    enclosing recording's list, which the outermost region ends."""
    global _recorder
    with _switch:
        outer = _recorder
        if outer is None:
            _recorder = Recorder()
        rec = _recorder
    try:
        yield rec.spans
    finally:
        if outer is None:
            with _switch:
                _recorder = None


def span(name: str, index: int = -1, **attrs):
    """A span over a `with` region while recording (the region's value is
    the Span), else a context that does nothing (its value is None)."""
    rec = _recorder
    if rec is None:
        return _OFF
    return rec.span(name, index, **attrs)


def note(key: str, value) -> None:
    """Set an attribute of this thread's innermost open span while
    recording."""
    rec = _recorder
    if rec is not None:
        rec.note(key, value)
