"""Per-block counters of the port: copies of `BlockStats` and `Timer` from
qat_zstd_plugin_tpu.utils.profiling."""

from __future__ import annotations

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
    __slots__ = ("t0", "elapsed")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
