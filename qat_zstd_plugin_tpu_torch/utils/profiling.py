"""Profiling hooks of the port.

Port of qat_zstd_plugin_tpu.utils.profiling: `trace(log_dir, device)`
captures a torch.profiler trace around a region (the JAX function wraps
jax.profiler), and `BlockStats` and `Timer` are re-exported from
runtime/stats.py, where the port keeps its copies of them.

The port's kernels are launched through ctypes on torch's current stream,
not through torch; CUPTI, which torch.profiler reads on "cuda", records
them all the same, under their CUDA function names
(hash_keys_winmin_sync_kernel, ...). `trace` also records the port's
spans (runtime/stats.recording), which show in its Chrome trace as
record_function ranges ("call", "submit.h2d", "collect.wait",
"block.host", ...) on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..runtime import stats
from ..runtime.stats import BlockStats, Timer

__all__ = ["BlockStats", "Timer", "trace"]


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda"):
    """Capture a trace around a region and write it as one Chrome trace
    JSON under log_dir, whose path the context manager yields:

        with trace("build/trace") as path:
            compress(data, device="cuda")

    "cuda" records the CPU and CUDA activities (the card's kernels and
    copies) and synchronises the card before the trace ends; it raises
    when torch sees no CUDA device. "cpu" records the CPU activity (the
    aten ops) only. Either way the port's spans are recorded over the
    region, as ranges of the trace."""
    dev = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"trace(device={str(dev)!r}): torch sees no "
                               "CUDA device")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    elif dev.type != "cpu":
        raise ValueError(f"trace: unsupported device {dev}")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace.{os.getpid()}.{time.time_ns()}.json")
    with stats.recording(), \
            torch.profiler.profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)
