"""The program's own spans and counters in a traced run of a cell: the
per-layer split that the benchmark's result line does not carry.

    python3 -m portbench.spans --workload l1.bulk --seed 12345 --seconds 51

from the root of a checkout, on a machine with a CUDA device. It runs the
cell as `python3 -m portbench.run ... --trace 1` does (the codec, the
seeded inputs, the warm-up, the closed loop, torch.profiler on the card
and the harness's wrappers), with the program's span recording
(runtime/stats.recording) on from before the codec is made, and prints
one JSON line:

  metrics       per window: collect_wait_ms_per_batch ("collect.wait",
                the wait for a batch's device work), unpack_ms_per_batch
                ("collect.unpack" + "collect.blocks"), h2d_gbs and d2h_gbs
                (the counters h2d_bytes and d2h_bytes over "submit.h2d"
                and "collect.d2h"), enqueue_ms_per_batch
                ("submit.enqueue"), host_half_cpu_pct (thread CPU over
                wall of "block.host"), drain_ms_per_call ("drain"),
                host_matched_pct (tail_blocks + overflow_blocks over the
                blocks finished), setup_program_s (the union of the
                program's spans before the window: loads and warm-up),
                idle_unexplained_pct (the idle share with no program span
                below "call" open); beside the harness's readings of
                the same, collect_ms_per_batch (its span) and
                batch_fill_pct (its rows), the program's:
                collect_ms_per_batch_program ("collect") and
                batch_fill_pct_program (batch_rows and padded_rows);
  by_span       per span name over the window: count, wall and thread CPU
                seconds (profile_l1.span_totals);
  routes        the host half's routes (block.host's "route") and counts;
  counters      GpuCodec.counters() over the window, and the blocks the
                host half finished;
  p95_request   the nearest-rank p95 call's seconds by span name, and
                what its calling thread spent outside its child spans;
  idle_by_span  every idle second of the window put down to the first
                program span open on any thread in IDLE_ORDER (a child
                before its parent), else "between_calls";
  clock         where the window's copies fall among the program's
                device-path spans (clock_check), and the mapping used.

The frames are not judged here: the benchmark's command does that.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import math
import sys
import time

from . import run as harness
from .trace import Recorder, _clip, _union, mark

# Idle time goes to the first of the program's spans open on any thread
# in this order (a child before its parent); none open: "between_calls".
IDLE_ORDER = ("submit.stage", "submit.h2d", "submit.enqueue", "submit",
              "collect.wait", "collect.d2h", "collect.unpack",
              "collect.blocks", "collect", "drain", "assemble", "block.host",
              "block.queue", "call")
# The program copies to and from the card inside these spans only; its
# pageable DtoH copies, which hold the thread until they are done, come
# from the spans named in SYNC_SPANS.
DEVICE_PATH = ("submit", "collect")
SYNC_SPANS = ("submit.enqueue", "collect.d2h")
COPIES = {"Memcpy HtoD": "HtoD", "Memcpy DtoH": "DtoH"}
SLACK_S = 50e-6      # a copy this close to a span's edge lies inside it
REFIT_S = 100e-6     # map by the copies' best fit if the mark is this far
SEARCH_S = 50e-3     # the best fit is looked for this far around the mark


def idle_by_span(gaps: list, prog: list) -> dict[str, float]:
    """Seconds of the idle `gaps` (sorted, disjoint) under each name of
    IDLE_ORDER, the first open on any thread of the program's spans
    `prog` ((start, end, name) in seconds), else "between_calls"; one
    sweep over the spans' sorted edges."""
    rank = {n: i for i, n in enumerate(IDLE_ORDER)}
    edges = sorted(ev for s, e, n in prog if n in rank and e > s
                   for ev in ((s, 1, rank[n]), (e, -1, rank[n])))
    open_ = [0] * len(IDLE_ORDER)
    out = dict.fromkeys(IDLE_ORDER + ("between_calls",), 0.0)
    g = 0

    def credit(lo: float, hi: float) -> None:
        nonlocal g
        while g < len(gaps) and gaps[g][1] <= lo:
            g += 1
        key = next((IDLE_ORDER[r] for r, k in enumerate(open_) if k),
                   "between_calls")
        j = g
        while j < len(gaps) and gaps[j][0] < hi:
            out[key] += max(0.0, min(hi, gaps[j][1]) - max(lo, gaps[j][0]))
            j += 1

    t = -math.inf
    for at, step, r in edges:
        credit(t, at)
        open_[r] += step
        t = at
    credit(t, math.inf)
    return out


def clock_check(iv: list, prog: list, shift: float, open_s: float,
                close_s: float) -> dict:
    """Where the window's copies (HtoD and DtoH in `iv`, (start, end,
    name) in profiler seconds) fall among the program's device-path spans
    (`prog`, perf_counter seconds). A pageable DtoH copy holds the thread
    that makes it until it is done, so with a sound mapping it lies
    inside the span that made it; a pageable HtoD copy returns once its
    bytes are staged, and its DMA may end a little later. The offset
    that puts the most DtoH copies inside a span of SYNC_SPANS (the one
    nearest the mark's `shift` among equals) is `best_offset_s`;
    `offset_s`, the one the trace is mapped by, is the mark's unless the
    best fit lies more than REFIT_S from it. Under `offset_s`: `under`
    counts each kind of copy by the innermost device-path span holding
    it (within SLACK_S; "none" where no span does: `outside` in all; a
    DtoH under submit.enqueue is a host sync in the device half);
    `outside_at_mark` counts those under the mark's offset, and
    `outside_at_s` gives the first 20 outside copies' seconds into the
    window. `moved_us_halves`: the best fit's distance from the mark for
    the DtoH copies of each half of the window apart (a drift between
    the two clocks shows as a difference)."""
    copies = [(s, e, COPIES[n[:11]]) for s, e, n in iv if n[:11] in COPIES
              and s + shift < close_s and e + shift > open_s]

    def spans_near(names):
        """A lookup of the spans of `names` (first parts or whole names)
        that start in [lo - their longest, hi]."""
        path = sorted((s, e, n) for s, e, n in prog
                      if n in names or n.split(".")[0] in names)
        starts = [s for s, _, _ in path]
        longest = max((e - s for s, e, _ in path), default=0.0)

        def near(lo: float, hi: float):
            i = bisect.bisect_left(starts, lo - longest)
            return path[i:bisect.bisect_right(starts, hi)]
        return near

    near_path, near_sync = spans_near(DEVICE_PATH), spans_near(SYNC_SPANS)

    def inner(a: float, b: float) -> str:
        """The shortest device-path span holding [a, b], within SLACK_S."""
        return min(((se - ss, n) for ss, se, n in near_path(a, a + SLACK_S)
                    if ss - SLACK_S <= a and b <= se + SLACK_S),
                   default=(0, "none"))[1]

    def best_fit(dtoh) -> tuple[float, int]:
        """The offset nearest the mark that puts the most of `dtoh`
        inside a span of SYNC_SPANS, and how many."""
        fits: list[tuple[float, int]] = []
        for s, e in dtoh:
            a, b = s + shift, e + shift
            # The offsets d that put [s + d, e + d] inside a span, unioned.
            ok = sorted((ss - s, se - e) for ss, se, _ in
                        near_sync(a - SEARCH_S, a + SEARCH_S)
                        if se - ss >= e - s and se >= b - SEARCH_S)
            merged: list[list[float]] = []
            for lo, hi in ok:
                if merged and lo <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], hi)
                else:
                    merged.append([lo, hi])
            for lo, hi in merged:
                fits += [(lo, 1), (hi, -1)]
        best, best_n, n = shift, 0, 0
        fits.sort(key=lambda f: (f[0], -f[1]))
        for i, (d, step) in enumerate(fits):
            n += step
            if step == 1 and n >= best_n:
                # [d, next edge] holds n fits: its point nearest the mark.
                hi = fits[i + 1][0] if i + 1 < len(fits) else d
                at = min(max(shift, d), hi)
                if n > best_n or abs(at - shift) < abs(best - shift):
                    best, best_n = at, n
        return best, best_n

    dtoh = [(s, e) for s, e, kind in copies if kind == "DtoH"]
    best, best_n = best_fit(dtoh)
    mid = (open_s + close_s) / 2 - shift
    halves = [best_fit([c for c in dtoh if (c[0] < mid) == first])[0]
              for first in (True, False)]
    moved = best - shift
    offset = best if abs(moved) > REFIT_S else shift
    under: dict[str, int] = {}
    outside_at: list[float] = []
    for s, e, kind in copies:
        key = f"{kind} {inner(s + offset, e + offset)}"
        under[key] = under.get(key, 0) + 1
        if key.endswith(" none"):
            outside_at.append(s + offset - open_s)
    return {"copies": len(copies),
            "outside": sum(v for k, v in under.items()
                           if k.endswith(" none")),
            "under": dict(sorted(under.items())),
            "outside_at_mark": sum(inner(s + shift, e + shift) == "none"
                                   for s, e, _ in copies),
            "mark_offset_s": shift, "best_offset_s": best,
            "dtoh": sum(k == "DtoH" for _, _, k in copies),
            "dtoh_fitted": best_n, "moved_us": 1e6 * moved,
            "moved_us_halves": [1e6 * (h - shift) for h in halves],
            "outside_at_s": outside_at[:20],
            "mapped_by": "best_fit" if offset != shift else "mark",
            "offset_s": offset}


def device_split(events: list, align_ns: int, open_s: float,
                 close_s: float, prog: list) -> dict:
    """The clock check and idle_by_span of the window [open_s, close_s]
    from the profiler's CUDA `events` ((start, end, name) in profiler
    microseconds, the first being the harness's `mark` kernel, launched
    at perf_counter_ns `align_ns`) and the program's spans `prog`."""
    events = sorted(events)
    iv = [(s / 1e6, e / 1e6, n) for s, e, n in events]
    clock = clock_check(iv, prog, align_ns / 1e9 - iv[0][0], open_s,
                        close_s)
    shift = clock["offset_s"]
    busy = _clip(_union([(s + shift, e + shift) for s, e, _ in iv]),
                 open_s, close_s)
    edges = [open_s] + [x for b in busy for x in b] + [close_s]
    gaps = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return {"clock": clock, "idle_by_span": idle_by_span(gaps, prog),
            "busy_s": sum(e - s for s, e in busy)}


def _seconds(spans, name: str) -> list[tuple[float, float]]:
    return [((sp.end_ns - sp.start_ns) / 1e9, sp.cpu_ns / 1e9)
            for sp in spans if sp.name == name]


def _mean_ms(x: list[tuple[float, float]]) -> float | None:
    return 1e3 * sum(t for t, _ in x) / len(x) if x else None


def readings(spans: list, counters: dict, open_s: float,
             idle: dict | None) -> dict:
    """The per-layer readings of the program's `spans` up to the window's
    end (those that start before `open_s` give setup_program_s, the rest
    the window's), the window's change of the counters, and its
    idle_by_span where the card was traced."""
    win = [sp for sp in spans if sp.start_ns / 1e9 >= open_s]
    h2d = sum(t for t, _ in _seconds(win, "submit.h2d"))
    d2h = sum(t for t, _ in _seconds(win, "collect.d2h"))
    host = _seconds(win, "block.host")
    wall = sum(t for t, _ in host)
    n = len(_seconds(win, "collect"))
    unpack = _seconds(win, "collect.unpack") + _seconds(win,
                                                        "collect.blocks")
    total = sum(idle.values()) if idle else 0.0
    before = sorted((sp.start_ns / 1e9, sp.end_ns / 1e9) for sp in spans
                    if sp.start_ns / 1e9 < open_s)
    return {
        "collect_wait_ms_per_batch": _mean_ms(_seconds(win, "collect.wait")),
        "unpack_ms_per_batch": 1e3 * sum(t for t, _ in unpack) / n
        if n else None,
        "h2d_gbs": counters["h2d_bytes"] / h2d / 1e9 if h2d else None,
        "d2h_gbs": counters["d2h_bytes"] / d2h / 1e9 if d2h else None,
        "enqueue_ms_per_batch": _mean_ms(_seconds(win, "submit.enqueue")),
        "host_half_cpu_pct": 100.0 * sum(c for _, c in host) / wall
        if wall else None,
        "drain_ms_per_call": _mean_ms(_seconds(win, "drain")),
        "host_matched_pct": 100.0 * (counters["tail_blocks"]
                                     + counters["overflow_blocks"])
        / counters["blocks"] if counters["blocks"] else None,
        "setup_program_s": sum(e - s for s, e in _union(before)),
        "idle_unexplained_pct": 100.0 * (idle["call"] + idle["between_calls"])
        / total if total else None,
        "collect_ms_per_batch_program": _mean_ms(_seconds(win, "collect")),
    }


def p95_request(window, spans: list) -> dict | None:
    """The nearest-rank p95 call of the window: its seconds, bytes and
    wall seconds by span name (the pool's summed over its threads), and
    call_self, what its calling thread spent outside submit, collect,
    drain and assemble."""
    done = sorted((c.end - c.start, c) for c in window.calls
                  if c.end is not None)
    calls = [sp for sp in spans if sp.name == "call"]
    if not done or not calls:
        return None
    lat, call = done[math.ceil(0.95 * len(done)) - 1]
    t0 = window.start + call.start
    cs = min(calls, key=lambda sp: abs(sp.start_ns / 1e9 - t0))
    split: dict[str, float] = {}
    for sp in spans:
        if sp.call == cs.call:
            split[sp.name] = split.get(sp.name, 0.0) + \
                (sp.end_ns - sp.start_ns) / 1e9
    split["call_self"] = split["call"] - sum(
        split.get(k, 0.0) for k in ("submit", "collect", "drain",
                                    "assemble"))
    return {"seconds": lat, "bytes": len(call.data), "by_span": split}


def traced(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """One traced window of the cell with the program's recording on; the
    line main() prints."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qat_zstd_plugin_tpu_torch.profile_l1 import span_totals
    from qat_zstd_plugin_tpu_torch.runtime import stats

    from .traffic import make_inputs
    cuda = device == "cuda"
    with stats.recording() as spans:
        codec, compress = harness.make_codec(cell.config, device)
        inputs = make_inputs(cell.traffic, seed)
        harness.warm_up(compress, inputs)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - harness.T_START
        rec = Recorder()
        rec.instrument(codec)
        before = {**codec.counters(), "blocks": codec.stats.blocks}
        with profile(activities=[ProfilerActivity.CUDA]) if cuda \
                else contextlib.nullcontext() as prof:
            align_ns = mark(device) if cuda else 0
            window = harness.drive(compress, inputs, seconds)
            if cuda:
                torch.cuda.synchronize()
        after = {**codec.counters(), "blocks": codec.stats.blocks}
    counters = {k: after[k] - v for k, v in before.items()}
    open_s, close_s = window.start, window.start + window.seconds
    mine = [sp for sp in spans if open_s <= sp.start_ns / 1e9 <= close_s]
    dev = None
    if cuda:
        from torch.autograd import DeviceType
        dev = device_split(
            [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA],
            align_ns, open_s, close_s,
            sorted((sp.start_ns / 1e9, sp.end_ns / 1e9, sp.name)
                   for sp in spans))
    got = readings([sp for sp in spans if sp.start_ns / 1e9 <= close_s],
                   counters, open_s, dev and dev["idle_by_span"])
    collect = rec.seconds("collect")
    got["collect_ms_per_batch"] = 1e3 * sum(collect) / len(collect) \
        if collect else None
    rows = rec.batches
    got["batch_fill_pct"] = 100.0 * sum(r for r, _, _ in rows) / sum(
        b for _, b, _ in rows) if rows else None
    got["batch_fill_pct_program"] = 100.0 * counters["batch_rows"] / (
        counters["batch_rows"] + counters["padded_rows"]) \
        if counters["batches"] else None
    return {"workload": cell.name, "seed": seed,
            "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "calls": sum(c.end is not None for c in window.calls),
            "window_s": window.seconds, "setup_s": setup_s,
            "metrics": got, **span_totals(mine, 1), "counters": counters,
            "p95_request": p95_request(window, spans),
            **(dev or {})}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(traced(cell, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
