"""Where the time of a level's main path goes, on one CUDA device.

    python3 -m qat_zstd_plugin_tpu_torch.profile_l1 [--level 1]
        [--device-entropy hybrid|full] [--seed S] [--mb 64] [--reps 3]
        [--trace-dir build/profile]

Run from the repository root on a machine with a CUDA device. By default
it drives the same configuration as chip_smoke.py's level-1 main path
(level 1, 128 KiB blocks, batch 128, the seeded corpus plus a 5000-byte
tail); --level 2..12 --mb 32 drives the level 2-12 ones (batch 64).
--device-entropy hybrid drives the hybrid ones at batch 64, the FSE
sequence sections encoded on the device (GpuCodec(device_entropy=
"hybrid")); --device-entropy full the full ones, the Huffman literals
too (GpuCodec(device_entropy=True)). It prints one JSON object per line:

  card          the card's name and power limit, as nvidia-smi gives them;
  device_half   CUDA-event median ms of the device half (levels 1-4
                find_matches_positions, 5-12 find_matches_packed; hybrid:
                find_matches_with_seqsec_hash / find_matches_with_seqsec,
                with the ms of its first stage, the matcher and the
                coalesced compaction, of its second, the FSE sections
                and bitconcat, and in full mode of its literals stage,
                encode_literals_device) for one batch, its input already
                on the card;
  device_ops    torch.profiler over 10 such batches: the device time of
                each kernel (memcpys included) and its share of the total,
                the device ms and launches a batch of each of the
                port's own kernels (csrc/; B14 is fse_maps_kernel,
                fse_chain_kernel and fse_emit_kernel), and the count of
                PyTorch elementwise kernels a batch;
  chains        levels 1-4 without device entropy: the device ops, the
                elementwise ones among them, and the device ms of one
                call of _unsorted (sort, K2, sort on the first width's
                keys) and of ldm_unsorted (K3, sort, K2, sort), by
                torch.profiler over 10 calls;
  wrappers      the host microseconds a call of the K2 and K3 wrappers
                (neighbor_unsort_keys on one row of the first width's
                sorted keys, ldm_keys on one span): host clock over 1000
                calls and one synchronise, at a size where the card
                finishes each launch before the host has made the next;
  e2e           per repetition, seconds and MB/s of GpuCodec.compress
                and the codec's counters (GpuCodec.counters);
  spans         the port's spans over those e2e calls (runtime/stats
                .recording): for each name, how many a call, and their
                wall and thread CPU seconds a call (summed over threads:
                "block.host" is the host half on the pool, "collect.wait"
                the wait for a batch's device work, "collect.unpack" and
                "collect.blocks" the host unpack, ...), and the routes
                of the blocks' host half;
  e2e_profiled  one more e2e call under torch.profiler: the card's busy
                time (union of its kernel and memcpy intervals) against
                the call's wall time, and the busiest device ops.

The full torch.profiler tables go to <trace-dir>/device_ops.txt and
<trace-dir>/e2e_ops.txt.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import subprocess
import time
from collections import Counter

import numpy as np
import torch

BLOCK = 131072
BATCH = 128  # level 1 (bench.py's headline batch)
DENSE_BATCH = 64  # levels 2-12 (bench.py's device level ladder)
TAIL = 5000


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _device_events(prof) -> list:
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(events) -> float:
    """Length of the union of the events' time intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _top_ops(events, n: int = 8) -> list[dict]:
    """The n device ops with the most device time, and their shares."""
    per: dict[str, float] = {}
    for ev in events:
        name = ev.name[:60]
        per[name] = per.get(name, 0.0) + ev.time_range.elapsed_us()
    total = sum(per.values()) or 1.0
    top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
    return [{"op": k, "ms": v / 1e3, "share": v / total} for k, v in top]


_KERNEL_DEF = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")


def csrc_kernels() -> set[str]:
    """The names of the kernels defined under csrc/."""
    from .ops import _build
    names: set[str] = set()
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu*")):
        with open(path) as f:
            names.update(_KERNEL_DEF.findall(f.read()))
    return names


def _port_kernels(events, batches: int, kernels: set[str]) -> dict:
    """Device ms and launches a batch of each of the named kernels (the
    port's own, csrc_kernels()), by name with template arguments."""
    per: dict[str, dict] = {}
    for ev in events:
        name = ev.name.removeprefix("void ").replace("(anonymous namespace)::",
                                                     "")
        name = name.split("(", 1)[0]
        if name.split("<", 1)[0] not in kernels:
            continue
        k = per.setdefault(name, {"ms": 0.0, "launches": 0})
        k["ms"] += ev.time_range.elapsed_us() / 1e3 / batches
        k["launches"] += 1
    for k in per.values():
        k["launches"] /= batches
    return per


def _elementwise(events) -> int:
    """How many of the device events are PyTorch elementwise kernels."""
    return sum("elementwise" in ev.name for ev in events)


def _ops_a_call(fn, calls: int = 10) -> dict:
    """Device ops, elementwise ones and device ms a call of fn()."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    return {"ops": len(events) / calls,
            "elementwise": _elementwise(events) / calls,
            "device_ms": sum(ev.time_range.elapsed_us()
                             for ev in events) / 1e3 / calls}


def _host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of fn() over `calls` calls and one
    synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def chains(p, blocks) -> tuple[dict, dict]:
    """(chains, wrappers) of a hash level with parameters p on the (B, N)
    blocks on the card: the device ops of one _unsorted and one
    ldm_unsorted call, and the K2 and K3 wrappers' host microseconds."""
    from .ops import glue_kernels as tk
    N = blocks.shape[1]
    w = min(p.window, N)
    pbits = (w - 1).bit_length()
    stride = tk.ldm_stride(p.ldm or 4, N)
    # The main path's keys and minima: K1's flipped keys and LDM samples
    # (K3 at stride 1), whose chains keep the sign bit flipped for K4; B6's
    # flipped keys and plane.
    if p.sync:
        key, minz = tk.hash_keys_winmin_sync(blocks, p.widths[0], p.window,
                                             stride, flip=tk._FLIP,
                                             samples=True)
        pos_mask, lstride = w - 1, 1
    else:
        key, minz = tk.hash_keys_winmin(blocks, p.widths[0], p.window,
                                        stride, flip=tk._FLIP)
        pos_mask, lstride = None, stride
    ops = {"unsorted": _ops_a_call(
        lambda: tk._unsorted(key, pbits, p.neighbors, pos_mask,
                             flipped=True, flip_out=p.sync))}
    span = p.ldm or 4
    if p.ldm and blocks.shape[0] % span == 0:
        ops["ldm_unsorted"] = _ops_a_call(
            lambda: tk.ldm_unsorted(minz, span, 1, lstride,
                                    flip_out=p.sync))
    row = tk._sort_rows(key[:1].contiguous())
    one_span = minz[:span].contiguous()
    host = {"neighbor_unsort_keys": _host_us(
                lambda: tk.neighbor_unsort_keys(row, pbits, p.neighbors,
                                                pos_mask)),
            "ldm_keys": _host_us(lambda: tk.ldm_keys(one_span, span,
                                                     lstride))}
    return ops, host


def _write_table(prof, path: str) -> None:
    with open(path, "w") as f:
        f.write(prof.key_averages().table(row_limit=40,
                                          max_name_column_width=60))


def hybrid_first_stage(codec, blocks, lengths):
    """The first stage of the codec's device-entropy half, with the
    arguments GpuCodec._pipeline gives it: (compaction dict, chosen,
    mlen)."""
    from .ops import match_pipeline
    p = codec.params
    if p.matcher == "hash":
        return match_pipeline.verified_sequences(
            blocks, lengths, 2, codec.max_seq, p.lazy, p.window)
    return match_pipeline.content_sequences(
        blocks, lengths, p.neighbors, codec.max_seq, p.lazy, p.stride,
        p.window)


def span_totals(spans, calls: int) -> dict:
    """Per span name: spans, wall and thread CPU seconds a call; and the
    host half's routes a call."""
    by: dict[str, dict] = {}
    for sp in spans:
        t = by.setdefault(sp.name, {"n": 0, "wall_s": 0.0, "cpu_s": 0.0})
        t["n"] += 1
        t["wall_s"] += (sp.end_ns - sp.start_ns) / 1e9
        t["cpu_s"] += sp.cpu_ns / 1e9
    for t in by.values():
        for k in t:
            t[k] /= calls
    routes = Counter(sp.attrs.get("route") for sp in spans
                     if sp.name == "block.host")
    return {"by_span": by,
            "routes": {k: v / calls for k, v in routes.items()}}


def profile(seed: int, mb: int, reps: int, trace_dir: str,
            level: int = 1, device_entropy: str | bool = False) -> None:
    from .corpus import make_corpus
    from .ops import _build, literals_kernel, match_pipeline
    from .runtime import stats
    from .runtime.gpu_codec import GpuCodec

    sections = bool(device_entropy)  # hybrid or full
    # bench.py's rows: L1 at batch 128, levels 2-12 and device entropy
    # at 64.
    batch = BATCH if level == 1 and not sections else DENSE_BATCH

    def emit(what: str, **fields) -> None:
        print(json.dumps({"what": what, **fields}), flush=True)

    os.makedirs(trace_dir, exist_ok=True)
    emit("card", card=card_line(), cpus=os.cpu_count(), level=level,
         batch=batch, device_entropy=device_entropy)
    _build.load()
    dev = torch.device("cuda")
    corpus = make_corpus((mb << 20) + TAIL, seed)
    buf = np.frombuffer(corpus, np.uint8)
    codec = GpuCodec(level=level, batch=batch, device="cuda",
                     device_entropy=device_entropy)
    run = codec._pipeline()
    content = codec.params.matcher != "hash"

    # Device half alone, input on the card.
    blocks = torch.from_numpy(buf[:batch * BLOCK].reshape(batch, BLOCK)
                              .copy()).to(dev)
    lengths = torch.full((batch,), BLOCK, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: run(blocks, lengths))
    split = {}
    if sections:
        out, chosen, mlen = hybrid_first_stage(codec, blocks, lengths)
        split = {
            "first_stage_ms": cuda_ms(
                lambda: hybrid_first_stage(codec, blocks, lengths)),
            "sections_ms": cuda_ms(lambda: match_pipeline.sections(
                out, custom_tables=codec.params.custom_tables))}
        if device_entropy is True:
            split["literals_ms"] = cuda_ms(
                lambda: literals_kernel.encode_literals_device(
                    blocks, lengths, chosen, mlen))
        del out, chosen, mlen
    emit("device_half", batch=batch, ms=ms, mbs=batch * BLOCK / ms / 1e3,
         **split)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run(blocks, lengths)
        torch.cuda.synchronize()
    _write_table(prof, os.path.join(trace_dir, "device_ops.txt"))
    events = _device_events(prof)
    emit("device_ops", batches=10, ops=_top_ops(events),
         port_kernels=_port_kernels(events, 10, csrc_kernels()),
         elementwise=_elementwise(events) / 10)
    if not content and not sections:
        ops, host = chains(codec.params, blocks)
        emit("chains", **ops)
        emit("wrappers", host_us=host, calls=1000)
    del blocks, lengths

    # End to end.
    kw = dict(level=level, batch=batch, device="cuda",
              device_entropy=device_entropy)
    GpuCodec(**kw).compress(corpus[:BLOCK + TAIL])  # warm-up
    with stats.recording() as spans:
        for rep in range(reps):
            c = GpuCodec(**kw)
            t0 = time.perf_counter()
            frame = c.compress(corpus)
            seconds = time.perf_counter() - t0
            emit("e2e", rep=rep, seconds=seconds,
                 mbs=len(corpus) / seconds / 1e6,
                 ratio=len(frame) / len(corpus), **c.counters())
    emit("spans", calls=reps, **span_totals(spans, reps))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        GpuCodec(**kw).compress(corpus)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    _write_table(prof, os.path.join(trace_dir, "e2e_ops.txt"))
    events = _device_events(prof)
    busy = _busy_us(events) / 1e6
    emit("e2e_profiled", seconds=seconds, card_busy_s=busy,
         busy_share=busy / seconds, ops=_top_ops(events))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--level", type=int, default=1, choices=range(1, 13))
    ap.add_argument("--device-entropy", choices=("off", "hybrid", "full"),
                    default="off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=64,
                    help="corpus size in MiB (plus a tail)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace-dir", default=os.path.join("build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_l1: torch sees no CUDA device")
    profile(args.seed, args.mb, args.reps, args.trace_dir, args.level,
            {"off": False, "hybrid": "hybrid",
             "full": True}[args.device_entropy])


if __name__ == "__main__":
    main()
