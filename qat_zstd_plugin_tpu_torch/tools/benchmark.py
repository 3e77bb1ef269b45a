"""Benchmark tool — parity with the reference's test/benchmark.c.

Port of qat_zstd_plugin_tpu.tools.benchmark: the same flags, output lines
and --json keys. Its methodology (test/benchmark.c:74-554): N worker
threads, per-thread codec contexts, chunked compression loops with phase
barriers, a 200-bucket geometric latency histogram (x1.05 growth,
benchmark.c:100-169), P25/P50/P75/P99/avg percentiles, decompress-verify
with PASS/FAIL per thread, and a software-mode A/B baseline (-m0,
benchmark.c:79).

Flags mirror the reference (benchmark.c:171-184): -t threads, -l level,
-c chunk KB, -m mode, -E repcode policy, -L loops. Modes:

  0  software: runtime.soft_codec.SoftwareCodec (the native host codec);
  1  device offload: GpuCodec(level, batch=--batch, device=--device);
  2  stock libzstd (extra A/B);
  3  stock libzstd driving the port's registered sequence producer on
     --device (the reference's deployment shape, test/test.c:103-116,
     where QAT does the matching; the port has no software producer).
     -E maps to ZSTD_c_searchForExternalRepcodes like the reference's
     flag; modes 0/1 emit repcodes natively in their own entropy stage.

--device (cuda, the default, or cpu) is the port's spelling of the JAX
tool's use_device=: "cuda" raises without a card (there is no fallback),
"cpu" runs the kernels' plain-torch twins. Modes 0 and 2 do not use it.

-t uses Python threads: native/entropy calls drop the GIL but the Python
orchestration serializes, so per-thread numbers under -t overlap. For a
true concurrency test use -P/--processes (separate interpreters, each
with its own codec, all on the same card).

    python -m qat_zstd_plugin_tpu_torch.tools.benchmark FILE -m 1 -l 1 --json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import compress_via_libzstd, oracle
from ..runtime.gpu_codec import GpuCodec
from ..runtime.soft_codec import SoftwareCodec

NB_BUCKETS = 200
BUCKET_GROWTH = 1.05
FIRST_BUCKET_US = 1.0
MODULE = "qat_zstd_plugin_tpu_torch.tools.benchmark"  # what -P children run
# The directory that holds the package, put on the -P children's path.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Histogram:
    """Geometric latency histogram (benchmark.c:100-169 semantics)."""

    def __init__(self) -> None:
        self.buckets = np.zeros(NB_BUCKETS, dtype=np.int64)
        self.lock = threading.Lock()
        edges = [FIRST_BUCKET_US]
        for _ in range(NB_BUCKETS - 1):
            edges.append(edges[-1] * BUCKET_GROWTH)
        self.edges = np.asarray(edges)
        self.total_us = 0.0
        self.count = 0

    def add(self, us: float) -> None:
        idx = int(np.searchsorted(self.edges, us))
        idx = min(idx, NB_BUCKETS - 1)
        with self.lock:
            self.buckets[idx] += 1
            self.total_us += us
            self.count += 1

    def percentile(self, p: float) -> float:
        target = self.count * p / 100.0
        acc = 0
        for i in range(NB_BUCKETS):
            acc += int(self.buckets[i])
            if acc >= target and target > 0:
                return float(self.edges[i])
        return float(self.edges[-1])

    def summary(self) -> dict:
        if not self.count:
            return {}
        return {"P25": self.percentile(25), "P50": self.percentile(50),
                "P75": self.percentile(75), "P99": self.percentile(99),
                "avg": self.total_us / self.count}


@dataclass
class ThreadResult:
    comp_mbs: float = 0.0
    decomp_mbs: float = 0.0
    ratio: float = 0.0
    verify_ok: bool = False
    errors: list = field(default_factory=list)
    # Codec-internal per-block stats (modes 0/1: BlockStats summary with
    # block latency percentiles — the inside-the-codec view the chunk
    # histogram above cannot see).
    block_stats: dict = field(default_factory=dict)


def _check_device(device: str) -> None:
    """--device cuda without a card raises before any thread starts."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: torch sees no CUDA device "
                           "(--device cpu runs the plain-torch twins)")


def _worker(tid: int, args, data: bytes, hist: Histogram,
            barrier1: threading.Barrier, barrier2: threading.Barrier,
            results: list) -> None:
    res = ThreadResult()
    try:
        chunk = args.chunk_kb * 1024
        chunks = [data[i:i + chunk] for i in range(0, len(data), chunk)]
        if args.mode == 1:
            codec = GpuCodec(level=args.level, batch=args.batch,
                             device=args.device)
            compress = lambda c: codec.compress(c)  # noqa: E731
        elif args.mode == 0:
            codec = SoftwareCodec(level=args.level)
            compress = lambda c: codec.compress(c)  # noqa: E731
        elif args.mode == 2:
            compress = lambda c: oracle.compress(c, args.level)  # noqa: E731
        else:
            compress = lambda c: compress_via_libzstd(  # noqa: E731
                c, level=args.level, device=args.device,
                search_repcodes=args.repcodes > 0)
        compress(chunks[0])  # warm-up / build outside the timed phase

        try:
            barrier1.wait()
        except threading.BrokenBarrierError:
            raise RuntimeError("aborted: a peer thread failed")
        frames = []
        t0 = time.perf_counter()
        for _ in range(args.loops):
            frames = []
            for c in chunks:
                tc = time.perf_counter()
                frames.append(compress(c))
                hist.add((time.perf_counter() - tc) * 1e6)
        dt = time.perf_counter() - t0
        comp_bytes = sum(map(len, frames))
        res.comp_mbs = len(data) * args.loops / dt / 1e6
        res.ratio = comp_bytes / len(data)

        # Decompress-verify (always software zstd, like the reference).
        ok = all(oracle.decompress(f, len(c)) == c
                 for f, c in zip(frames, chunks))
        res.verify_ok = ok
        try:
            barrier2.wait()
        except threading.BrokenBarrierError:
            raise RuntimeError("aborted: a peer thread failed")
        t0 = time.perf_counter()
        for _ in range(args.loops):
            for f, c in zip(frames, chunks):
                oracle.decompress(f, len(c))
        res.decomp_mbs = len(data) * args.loops / (
            time.perf_counter() - t0) / 1e6
        if args.mode in (0, 1):
            res.block_stats = codec.stats.summary()
    except Exception as e:
        res.errors.append(repr(e))
        # Release peers blocked on the phase barriers (a failed thread
        # would otherwise deadlock the whole run); BrokenBarrierError in
        # the survivors is absorbed below.
        barrier1.abort()
        barrier2.abort()
    results[tid] = res


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="qat_zstd_plugin_tpu_torch benchmark (reference "
                    "test/benchmark.c parity)")
    ap.add_argument("file", help="input file to compress")
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("-l", "--level", type=int, default=1)
    ap.add_argument("-c", "--chunk-kb", type=int, default=128,
                    help="chunk size in KiB (reference -c)")
    ap.add_argument("-m", "--mode", type=int, default=1,
                    help="0=software(native) 1=device 2=stock-libzstd "
                         "3=libzstd+our-producer")
    ap.add_argument("-E", "--repcodes", type=int, default=0,
                    help="mode 3: ZSTD_c_searchForExternalRepcodes "
                         "(reference -E); modes 0/1 always emit repcodes "
                         "natively")
    ap.add_argument("-L", "--loops", type=int, default=1)
    ap.add_argument("-P", "--processes", type=int, default=0,
                    help="aggregate over N separate interpreter processes "
                         "(true concurrency; no GIL sharing)")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON result line (machine readable)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="modes 1 and 3: cuda (the card; raises without "
                         "one) or cpu (the kernels' plain-torch twins)")
    ap.add_argument("--histogram", action="store_true",
                    help="dump the full latency histogram (reference "
                         "DISPLAY_HISTOGRAM parity)")
    ap.add_argument("--sweep", action="store_true",
                    help="run the full L1-L12 level sweep (the reference "
                         "benchmark's per-level loop)")
    args = ap.parse_args(argv)
    if args.mode in (1, 3):
        _check_device(args.device)

    if args.processes > 1:
        return _run_multiprocess(args)

    if args.sweep:
        rc = 0
        for lvl in range(1, 13):
            print(f"=== level {lvl} ===")
            sub = [args.file, "-t", str(args.threads), "-l", str(lvl),
                   "-c", str(args.chunk_kb), "-m", str(args.mode),
                   "-L", str(args.loops), "--batch", str(args.batch),
                   "--device", args.device]
            rc |= run(sub)
        return rc

    with open(args.file, "rb") as f:
        data = f.read()
    hist = Histogram()
    barrier1 = threading.Barrier(args.threads)
    barrier2 = threading.Barrier(args.threads)
    results: list = [None] * args.threads
    threads = [threading.Thread(
        target=_worker, args=(i, args, data, hist, barrier1, barrier2,
                              results)) for i in range(args.threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    ok = True
    for i, r in enumerate(results):
        status = "PASS" if (r and r.verify_ok and not r.errors) else "FAIL"
        ok &= status == "PASS"
        extra = f" errors={r.errors}" if r and r.errors else ""
        print(f"thread {i}: compress {r.comp_mbs:8.1f} MB/s  "
              f"decompress {r.decomp_mbs:8.1f} MB/s  "
              f"ratio {r.ratio*100:5.1f}%  {status}{extra}")
        if r and r.block_stats:
            bs = r.block_stats
            lat = bs.get("block_latency_us", {})
            print(f"  blocks={bs['blocks']} raw={bs['raw_blocks']} "
                  f"fallback={bs['fallback_blocks']} "
                  + " ".join(f"block_{k}={v:.0f}us"
                             for k, v in lat.items()))
    agg = sum(r.comp_mbs for r in results if r)
    print(f"aggregate compress: {agg:.1f} MB/s over {args.threads} threads "
          f"({wall:.1f}s wall)")
    if args.threads > 1:
        print("note: -t threads share the GIL during Python orchestration; "
              "per-thread MB/s overlap. Use -P for process-level "
              "concurrency.")
    if args.json:
        print(json.dumps({
            "ok": ok, "aggregate_mbs": round(agg, 2),
            "ratio": results[0].ratio if results[0] else None,
            "decomp_mbs": round(sum(r.decomp_mbs for r in results if r), 2),
            "latency_us": hist.summary(), "threads": args.threads,
            "block_stats": results[0].block_stats if results[0] else {}}))
    s = hist.summary()
    if s:
        print("chunk latency us: "
              + "  ".join(f"{k}={v:.0f}" for k, v in s.items()))
    if args.histogram and hist.count:
        # Full bucket dump (the reference's -DDISPLAY_HISTOGRAM output,
        # test/benchmark.c:532-545).
        for i in range(NB_BUCKETS):
            if hist.buckets[i]:
                print(f"  <= {hist.edges[i]:10.1f} us: "
                      f"{int(hist.buckets[i])}")
    return 0 if ok else 1


def _run_multiprocess(args) -> int:
    """Aggregate throughput over N independent interpreter processes —
    the reference's 2048-pthread contention test (benchmark.c:439-441,
    514-520) without GIL serialization; on --device cuda every process
    drives the same card. Each child runs the full single-process
    benchmark of this module and reports JSON; the parent sums."""
    cmd_base = [sys.executable, "-m", MODULE, args.file,
                "-t", str(args.threads), "-l", str(args.level),
                "-c", str(args.chunk_kb), "-m", str(args.mode),
                "-E", str(args.repcodes), "-L", str(args.loops),
                "--batch", str(args.batch), "--device", args.device,
                "--json"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd_base, stdout=subprocess.PIPE, env=env)
             for _ in range(args.processes)]
    outs = [p.communicate()[0].decode() for p in procs]
    wall = time.perf_counter() - t0
    ok = all(p.returncode == 0 for p in procs)
    agg = 0.0
    for i, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith("{")]
        r = json.loads(line[-1]) if line else {"ok": False,
                                               "aggregate_mbs": 0}
        ok &= bool(r.get("ok"))
        agg += r.get("aggregate_mbs", 0)
        print(f"process {i}: {r.get('aggregate_mbs', 0):.1f} MB/s "
              f"{'PASS' if r.get('ok') else 'FAIL'}")
    print(f"aggregate compress: {agg:.1f} MB/s over {args.processes} "
          f"processes x {args.threads} threads ({wall:.1f}s wall)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run())
