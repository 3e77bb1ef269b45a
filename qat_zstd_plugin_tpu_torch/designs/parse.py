"""B10 parse_greedy beside its parent and other designs, on one CUDA device.

    python3 -m qat_zstd_plugin_tpu_torch.designs.parse [--seed S]
        [--parent DIR] [--designs NAMES]

Run from the repository root on a machine with a CUDA device. It builds
csrc/'s content_kernels.cu once for each design (csrc's source with a
few edits, DESIGNS below: other constants, the shared-memory carveout,
no look-back), once as it is and once with a timeline (below), and, with
--parent, the same source of the tree at DIR (e.g. the parent commit
unpacked from `git archive` under build/), all at once, and times each
over 20 back-to-back calls behind a 2 ms spin on the card (the median of
5 runs, as chip_smoke.py's stream_ms), at B=64 blocks of 128 KiB, on the
inputs of chip_smoke.py's phase 2 (`parse_inputs`): the L5 and L12
candidate lengths of the corpus, the crafted rows, and the rows where
chains from different starts never meet (every length 4, 5 or 7), each
at psegs 1, 2, 4 and 8, lazy off and on. The parent runs first and last,
csrc's kernel (through the wrapper) second and second to last. Every
output must equal csrc's (but the "no look-back" design's, which parses
each chunk from its own start to show what the chain costs), and csrc's
the twin's, or the run fails. --designs takes a comma-separated subset
of DESIGNS ("" for none). It prints the card's name and power limit,
each design's CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
one JSON object per timing, each with the case's bound (4 bytes a
visited position and 1 a position, at 3.35 TB/s) and the design's floor
(5 bytes a position), and for TIMELINE_CASES one call's timeline: the
SM cycles of each CTA's maps, look-back and walk (median and 90th
percentile), when the look-back of each chunk index ended (median over
rows, ns from the first CTA's start), the CTAs an SM held at once and
the span.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

BLOCK = 131072
BATCH = 64
HBM_BYTES_PER_S = 3.35e12
PSEGS = (1, 2, 4, 8)
SOURCES = ("common.cuh", "content_kernels.cu")


def _const(name: str, value: int) -> tuple:
    """An edit that sets csrc's constant `name`."""
    return (rf"constexpr int {name} = \w+;", f"constexpr int {name} = {value};")


def _insert(anchor: str, text: str, after: bool = False) -> tuple:
    """An edit that puts text before (or after) the one line `anchor`."""
    return (re.escape(anchor), anchor + text if after else text + anchor)


# name: edits of content_kernels.cu (regex, replacement), each matching
# exactly once; csrc's other code kept.
DESIGNS = {
    "256 threads and pieces of 16": [_const("kParseThreads", 256),
                                     _const("kParsePiece", 16)],
    "chunks of 2048": [_const("kParseThreads", 64)],
    "chunks of 8192": [_const("kParseThreads", 256)],
    "pieces of 64": [_const("kParseThreads", 64), _const("kParsePiece", 64)],
    "status words packed": [_const("kParseStatusStride", 1)],
    "read-ahead 1": [_const("kParseAhead", 1)],
    "read-ahead 16": [_const("kParseAhead", 16)],
    "carveout max shared": [_insert(
        "                                      : parse_greedy_kernel<false, "
        "false>);\n",
        "    cudaFuncSetAttribute(kernel,\n"
        "        cudaFuncAttributePreferredSharedMemoryCarveout,\n"
        "        int(cudaSharedmemCarveoutMaxShared));\n", after=True)],
    # Each chunk parsed from its own start: what the chain costs (its
    # output differs from csrc's and is not checked).
    "no look-back": [(re.escape("        int entry = 0;\n"),
                      "        int entry = base;\n"),
                     (re.escape("        if (k > 0) {\n"),
                      "        if (false) {\n")],
}
UNCHECKED = {"no look-back"}
# The timeline: thread 0 of each CTA records %globaltimer and clock64 at
# its start, when its maps are done, after its look-back and at its end,
# and its SM, as 9 u64 at word TIMELINE_AT of the scratch (ticket order).
TIMELINE_AT = 1 << 22
_TIMELINE = [
    _insert("template <bool kLazy, bool kTrunc>\n"
            "__global__ void __launch_bounds__(kParseThreads)\n",
            "__device__ __forceinline__ uint64_t probe_ns() {\n"
            "    uint64_t t;\n"
            "    asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
            "    return t;\n}\n\n"
            "__device__ __forceinline__ uint32_t probe_sm() {\n"
            "    uint32_t s;\n"
            "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(s));\n"
            "    return s;\n}\n\n"),
    _insert("    const int k = ticket / rows, r = ticket - k * rows;"
            "  // chunk-major\n",
            f"    uint64_t* rec = reinterpret_cast<uint64_t*>(scratch + "
            f"{TIMELINE_AT}) + size_t(ticket) * 9;\n"
            "    if (tid == 0) rec[0] = probe_ns(), rec[4] = clock64(),"
            " rec[8] = probe_sm();\n", after=True),
    _insert("    // (b) The entry from the chunk before",
            "    if (tid == 0) rec[1] = probe_ns(), rec[5] = clock64();\n"),
    _insert("    // (c) The pieces' entries",
            "    if (tid == 0) rec[2] = probe_ns(), rec[6] = clock64();\n"),
    _insert("            if (ps + i < end) c[ps + i] = uint8_t(word[i / 4] >>"
            " (8 * (i & 3)));\n    }\n",
            "    __syncthreads();\n"
            "    if (tid == 0) rec[3] = probe_ns(), rec[7] = clock64();\n",
            after=True),
]
# Each design's library also exports its kernel's occupancy (CTAs an SM).
_PROBE = """#include "content_kernels.cu"

extern "C" int qz_parse_occupancy() {
    const auto kernel = parse_greedy_kernel<true, false>;
    if (kParseSmem > 48 * 1024)
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kParseSmem));
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                  kParseThreads, kParseSmem);
    return blocks;
}
"""
# Cases the timeline reads.
TIMELINE_CASES = ("L5 candidates, psegs 1, lazy=True",
                  "L5 candidates, psegs 8, lazy=True",
                  "every length 4, psegs 1, lazy=False")
# The smallest chunk and the widest status stride a design may take: the
# scratch this harness allocates holds their status words.
MIN_CHUNK, MAX_STRIDE = 1024, 32
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"qz_parse_greedy": (_P, _P, _P) + (_I,) * 5 + (_P,)}
# The entry point of the earlier kernel (a CTA a row): no scratch.
PARENT_SIGNATURES = {"qz_parse_greedy": (_P, _P) + (_I,) * 4 + (_P,)}


def crafted_lengths(B: int, N: int, rng) -> np.ndarray:
    """Candidate lengths for B10 (B >= 16, N a multiple of 4096 above
    65536): all-zero rows, rows with every length >= 4, every length 7, 4
    and 5 (lazy ties; chains from different starts that never meet),
    matches across the 4096-position chunk edges, look-aheads on the
    next chunk, matches that end exactly at N or pass it, rising runs, a
    65535-long match over whole chunks, chains that exit exactly on each
    chunk edge or on the next one, and one match over the whole row."""
    m = np.where(rng.random((B, N)) < 0.3, rng.integers(0, 40, (B, N)), 0)
    m = m.astype(np.int32)
    edges = np.arange(4096, N, 4096)
    m[0] = 0
    m[1] = rng.integers(4, 9, N)
    m[2, :] = 7                                  # lazy ties everywhere
    m[3, edges - 5] = 30                         # crosses the chunk edge
    m[4, edges - 1] = 4                          # look-ahead on the next chunk
    m[4, edges] = 5
    m[5, N - 20] = 20                            # ends exactly at N
    m[6, N - 3:] = 60                            # passes N
    m[7, :] = np.arange(N) % 64                  # rising runs
    m[8, :] = 4                                  # 4 chains that never meet
    m[9, :] = 5                                  # 5 of them
    m[10, :3] = 0
    m[10, 3] = 65535                             # over 15 whole chunks
    m[11:16] = 0
    m[11, edges - 8] = 8                         # exits on each chunk edge
    m[12, edges - 1] = 4                         # lazy looks across the edge
    m[12, edges] = 9
    m[13, 0] = N                                 # one match, the whole row
    m[14, edges[::2] - 2] = 4096 + 2             # lands on the next edge
    m[15, 1::8192] = 8191                        # 2-chunk jumps
    return m


def visited(torch, chosen, mlen, psegs: int = 1) -> int:
    """Positions the parse's cursor visits: all but the interiors of the
    chosen matches (the data-dependent reads of B10), each match cut at
    its row's end: the block's, or with psegs > 1 its parse segment's."""
    B, N = mlen.shape
    chosen = chosen.reshape(B * psegs, N // psegs)
    mlen = mlen.reshape(B * psegs, N // psegs)
    N //= psegs
    pos = torch.arange(N, device=mlen.device)
    inner = torch.where(chosen, torch.clamp(pos + mlen, max=N) - pos - 1, 0)
    return int(chosen.numel() - inner.sum())


def parse_inputs(torch, corpus, rng) -> dict:
    """{case: (B, N) int32 lengths on corpus's device}: the L5 and L12
    candidates of the (B, N) corpus bytes, crafted_lengths, and every
    length 4, 5 and 7."""
    from ..ops import match_pipeline as mp
    from ..runtime.levels import TPU_LEVEL_TABLE, level_params
    B, N = corpus.shape
    dev = corpus.device
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    out = {}
    for level in (5, 12):
        p = TPU_LEVEL_TABLE[level]
        out[f"L{level} candidates"] = mp.content_candidates(
            corpus, lengths, p.neighbors, p.stride, p.window, p.ldm,
            1 << level_params(level).window_log)[0]
    out["crafted rows"] = torch.from_numpy(crafted_lengths(B, N, rng)).to(dev)
    for d in (4, 5, 7):
        out[f"every length {d}"] = torch.full((B, N), d, dtype=torch.int32,
                                              device=dev)
    return out


def _sources(csrc: str, edits=()) -> dict:
    """The sources of csrc, with a design's edits made."""
    out = {}
    for name in SOURCES:
        with open(os.path.join(csrc, name)) as f:
            out[name] = f.read()
    for pattern, text in edits:
        out["content_kernels.cu"], hits = re.subn(
            pattern, lambda _: text, out["content_kernels.cu"])
        if hits != 1:
            raise SystemExit(f"content_kernels.cu: {pattern!r} matches "
                             f"{hits} times")
    return out


def _libraries(builds: dict) -> dict:
    """Build each {label: sources} into its own shared library (one nvcc
    per build, all at once); returns {label: path}."""
    from ..ops import _build
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for label, srcs in sorted(builds.items()):
        h.update(label.encode() + b"".join(s.encode() for s in
                                           srcs.values()))
    root = os.path.join(_build.BUILD_ROOT, f"parse-{h.hexdigest()[:16]}")
    paths, cmds = {}, []
    for i, (label, srcs) in enumerate(builds.items()):
        d = os.path.join(root, str(i))
        paths[label] = os.path.join(d, "libqz_parse.so")
        if os.path.exists(paths[label]):
            continue
        os.makedirs(d, exist_ok=True)
        for name, text in srcs.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        main = "content_kernels.cu"
        if "kParseSmem" in srcs[main]:  # the occupancy probe includes it
            main = "probe.cu"
            with open(os.path.join(d, main), "w") as f:
                f.write(_PROBE)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     paths[label], os.path.join(d, main)])
    _build._run(cmds)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", help="root of a tree whose csrc/ has B10 "
                    "(with or without the scratch argument)")
    ap.add_argument("--designs", default=",".join(DESIGNS),
                    help="comma-separated names of DESIGNS to build")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from ..corpus import make_corpus
    from ..ops import _build
    from ..ops import parse_kernel as pk
    from .k2_k3 import stream_ms
    from .winmin import _load
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    designs = [d for d in args.designs.split(",") if d]
    for d in designs:
        if d not in DESIGNS:
            raise SystemExit(f"no design {d!r}; designs: {list(DESIGNS)}")
    builds = {d: _sources(_build.CSRC, DESIGNS[d]) for d in designs}
    builds["csrc"] = _sources(_build.CSRC)
    builds["timeline"] = _sources(_build.CSRC, _TIMELINE)
    if args.parent:
        builds["parent"] = _sources(os.path.join(
            args.parent, "qat_zstd_plugin_tpu_torch", "csrc"))
    old_entry = args.parent and "scratch_words" not in \
        builds["parent"]["content_kernels.cu"]
    libs = {label: _load(path, PARENT_SIGNATURES
                         if label == "parent" and old_entry else SIGNATURES)
            for label, path in _libraries(builds).items()}
    for label, lib in libs.items():
        if hasattr(lib, "qz_parse_occupancy"):
            print(json.dumps({"kernel": "B10", "design": label,
                              "ctas_an_sm": lib.qz_parse_occupancy()}),
                  flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    data = make_corpus(BATCH * BLOCK, args.seed)
    corpus = torch.from_numpy(np.frombuffer(data, np.uint8)
                              .reshape(BATCH, BLOCK).copy()).cuda()
    inputs = parse_inputs(torch, corpus, np.random.default_rng(args.seed + 3))
    cases, want = {}, {}
    for what, mlen in inputs.items():
        for psegs in PSEGS:
            for lazy in (False, True):
                case = f"{what}, psegs {psegs}, lazy={lazy}"
                cases[case] = (mlen, psegs, lazy)
                want[case] = pk.parse_greedy(mlen, lazy, psegs)
                if not torch.equal(want[case],
                                   pk.parse_greedy_twin(mlen, lazy, psegs)):
                    raise SystemExit(f"B10 csrc ({case}) differs from its "
                                     "twin")

    def emit(case, design, fn, out=None):
        """Time fn; out: the tensor it wrote, to hold against csrc's."""
        mlen, psegs, lazy = cases[case]
        if out is not None:
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want[case]):
                raise SystemExit(f"B10 {design} ({case}) differs from csrc")
        moved = 4 * visited(torch, want[case], mlen, psegs) + mlen.numel()
        print(json.dumps({
            "kernel": "B10", "case": case, "design": design,
            "stream_ms": stream_ms(torch, fn),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "floor_ms": 5 * mlen.numel() / HBM_BYTES_PER_S * 1e3}),
            flush=True)

    def caller(label):
        fn = libs[label].qz_parse_greedy

        def call(*a):
            rc = fn(*[t.data_ptr() if isinstance(t, torch.Tensor) else t
                      for t in a], stream)
            if rc:
                raise RuntimeError(f"qz_parse_greedy ({label}): CUDA error "
                                   f"{rc}")
        return call

    def run_lib(label, only=None):
        call = caller(label)
        for case, (mlen, psegs, lazy) in cases.items():
            if only is not None and case not in only:
                continue
            out = torch.empty_like(want[case])
            B, N = mlen.shape
            rows, n = B * psegs, N // psegs
            flags = (int(lazy), int(psegs > 1))
            if label == "parent" and old_entry:
                emit(case, label, lambda: call(mlen, out, rows, n, *flags),
                     out)
            else:
                chunks = rows * -(-n // MIN_CHUNK)
                scratch = torch.empty(
                    TIMELINE_AT + 18 * chunks if label == "timeline"
                    else (chunks + 1) * MAX_STRIDE,
                    dtype=torch.int32, device=mlen.device)
                emit(case, label, lambda: call(mlen, out, scratch,
                                               scratch.numel(), rows, n,
                                               *flags),
                     None if label in UNCHECKED else out)

    def timeline(case):
        """One call of the timeline build after a warm-up: its CTAs'
        phases in SM cycles (median, 90th percentile), the chain's pace
        (the median look-back end of chunk k, k = 0 .. last), the CTAs an
        SM held at once (most, median over SMs) and the span."""
        mlen, psegs, lazy = cases[case]
        B, N = mlen.shape
        rows, n = B * psegs, N // psegs
        chunks = rows * -(-n // pk.PARSE_CHUNK)
        scratch = torch.zeros(TIMELINE_AT + 18 * chunks, dtype=torch.int32,
                              device=mlen.device)
        out = torch.empty_like(want[case])
        call = caller("timeline")
        for _ in range(2):
            call(mlen, out, scratch, scratch.numel(), rows, n, int(lazy),
                 int(psegs > 1))
        torch.cuda.synchronize()
        if not torch.equal(out, want[case]):
            raise SystemExit(f"B10 timeline ({case}) differs from csrc")
        rec = scratch[TIMELINE_AT:].cpu().numpy().view(np.uint64) \
            .reshape(chunks, 9).astype(np.int64)
        ns, clk, sm = rec[:, :4], rec[:, 4:8], rec[:, 8]
        ns = ns - ns[:, 0].min()
        phases = {name: [int(np.median(v)), int(np.percentile(v, 90))]
                  for name, v in (("maps", clk[:, 1] - clk[:, 0]),
                                  ("look_back", clk[:, 2] - clk[:, 1]),
                                  ("walk", clk[:, 3] - clk[:, 2]),
                                  ("cta", clk[:, 3] - clk[:, 0]))}
        k = np.arange(chunks) // rows  # tickets: chunk-major
        pace = [int(np.median(ns[k == i, 2])) for i in range(k.max() + 1)]
        held = []
        for s_ in np.unique(sm):
            iv = ns[sm == s_][:, [0, 3]]
            ev = sorted([(a, 1) for a in iv[:, 0]] + [(b, -1) for b in iv[:, 1]])
            held.append(max(np.cumsum([e for _, e in ev])))
        print(json.dumps({"kernel": "B10", "case": case,
                          "design": "timeline", "cycles": phases,
                          "look_back_end_ns": pace,
                          "ctas_held": [int(max(held)),
                                        int(np.median(held))],
                          "sms": len(held), "span_ns": int(ns[:, 3].max())}),
              flush=True)

    def run_csrc():
        for case, (mlen, psegs, lazy) in cases.items():
            emit(case, "csrc", lambda: pk.parse_greedy(mlen, lazy, psegs))

    if args.parent:
        run_lib("parent")
    run_csrc()
    for d in designs:
        run_lib(d)
    run_csrc()
    if args.parent:
        run_lib("parent")
    run_lib("timeline", TIMELINE_CASES)
    for case in TIMELINE_CASES:
        timeline(case)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
