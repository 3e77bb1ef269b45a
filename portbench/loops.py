"""Drive the program with a run's inputs and time every call.

A closed loop: each of `workers` clients calls `compress` on its next
input as soon as its last call has returned, until the window's seconds
have passed; client w takes inputs w, w + workers, w + 2 workers, ...
of the run's list, cycling through it. The calls under way at that
moment complete and count, so the window ends when the last call
returns, and a rate covers all the work and all the time. Every call is
timed from its start to the return of its frame; one that raises is
kept, without a frame, and its client stops.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np


@dataclass
class Call:
    data: np.ndarray
    start: float = 0.0        # seconds after the window opened
    end: float | None = None  # None: never returned or raised
    frame: bytes | None = None
    error: str | None = None


@dataclass
class Window:
    calls: list[Call]
    start: float            # perf_counter at the window's opening
    seconds: float          # its length, to the last return


def _call(compress, c: Call, t0: float) -> None:
    c.start = time.perf_counter() - t0
    try:
        c.frame = compress(c.data)
        c.end = time.perf_counter() - t0
    except Exception as e:  # a failed request is counted, not fatal
        c.error = f"{type(e).__name__}: {e}"


def closed(compress, objects: list[np.ndarray], workers: int,
           seconds: float) -> Window:
    calls: list[Call] = []
    lock = threading.Lock()
    t0 = time.perf_counter()

    def worker(w: int) -> None:
        k = w
        while time.perf_counter() - t0 < seconds:
            c = Call(objects[k % len(objects)])
            with lock:
                calls.append(c)
            _call(compress, c, t0)
            if c.end is None:
                return
            k += workers
    _run(worker, workers)
    ends = [c.end for c in calls if c.end is not None]
    return Window(calls, t0, max(ends, default=seconds))


def together(compress, objects: list[np.ndarray]) -> list[Call]:
    """One call on each input, all at once, each on a thread of its own."""
    calls = [Call(d) for d in objects]
    t0 = time.perf_counter()
    _run(lambda w: _call(compress, calls[w], t0), len(calls))
    return calls


def _run(fn, n: int) -> None:
    threads = [threading.Thread(target=fn, args=(w,), daemon=True,
                                name=f"portbench-worker-{w}")
               for w in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
