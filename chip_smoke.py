#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the CUDA kernels
and the host runtime, checks each kernel against its plain-torch twin,
drives levels 1-4 (the hash matcher) and 5, 9 and 12 (the content
matcher) end to end, levels 1 and 9 with hybrid device entropy (the FSE
sequence sections encoded on the card) and with full device entropy (the
Huffman literals sections too), drives the reference's deployment shape
(stock libzstd calling the port's sequence producer once a block, one-shot
and streaming, and the port's StreamCompressor), drives the block-parallel
scale-out (parallel.pipeline.compress_mesh) in an NCCL world of one and
with two gloo ranks sharing the card, and checks every frame with stock
libzstd.

    python3 chip_smoke.py [--seed S] [--mb 64]

Run from the repository root on a machine with one CUDA device. Phases
(each raises on failure; nothing is caught):

  1. card and build: the card's name and power limit, the nvcc build of
     qat_zstd_plugin_tpu_torch/csrc/ and the g++ build of the port's
     native host runtime, libzstd's version and whether it has
     ZSTD_registerSequenceProducer;
  2. kernel vs twin: each of the nineteen kernels against its plain-torch
     twin on the card, exactly equal, with median CUDA-event times of
     both and the least time the card could take (the bytes the function
     must move at 3.35 TB/s): K1-K4 at level 1's shapes (B=128 blocks of
     128 KiB), B5-B14 at the level 2-12 shapes (B=64 blocks of 128 KiB,
     bench.py's device level ladder and its hybrid row), on the corpus
     and on random bytes; K1 with the LDM samples (the main path's) and
     with the full plane, K2, K3 and K4 with flip 0 and with the sign
     flip of the main path's signed row sorts, every case also over 20
     back-to-back calls (stream_ms): K1 on corpus, random and mixed
     bytes at B=128, on 37 rows of 65536 and on 64 rows of 4100 (there at
     every stride from 1 to 4096 and 0); K4 on level 1's pair rows with
     ragged lengths, with the LDM rows of span 4 (the estimates computed
     in the kernel) and without; K2 on level 1's pair rows and LDM
     rows and one pair row at neighbors 1, on full-resolution rows at
     neighbors 2, 3, 7 and 100, on rows of 4100 and 4097 words, and on
     crafted rows whose equal hashes straddle the kernel's chunks at
     neighbors 1, 3 and 100, with a clone of its input beside it
     (copy_ms); K3 at span 4 (B=128) on K1's samples (the main path's)
     and on its plane, at spans 8 and 16 (B=64), on one span, two spans
     and 1027 samples a block, with its sector floor (on a plane one
     32-byte sector read a sample) and on a plane the same sampled words
     copied out by torch (gather_ms); B5 at widths 4, 5, 6 and 8, B6 and
     B9 at every
     power-of-two stride from 1 to 4096, each on corpus, random and
     mixed bytes, on 37 rows of 65536, 64 rows of 4100 and one row of 8
     bytes (B5 and B6 with flip 0 and with the sign flip), each case also
     over 20 back-to-back calls (stream_ms) beside torch's widening copy
     of the same bytes (copy_ms: to int32 for B5 and B9, to int64 for
     B6); B10 on the L5 and L12 candidate lengths of
     the B=64 batch and on crafted rows, lazy on and off, each case also
     back to back (stream_ms, as B11, B12, B17 and B18); B11 and B13
     (full and ragged lengths) on corpus, random and mixed bytes; B7 and
     B13 also timed on corpus, random and mixed bytes apart, and at
     B=37 x 65536 and B=64 x 4100 with ragged lengths, each B7 and B13
     case also over 20 back-to-back calls (stream_ms); B12 at
     neighbors 1 and 2; B14 on the L1 and L9 sequences of the batch and
     on crafted blocks of 0, 1, 2, 16383 and 16384 sequences, and on 37
     crafted blocks at S = 2048 with codes outside a table, custom tables
     on and off, each case with its chain length and the split design's
     operation floor (its twin is a Python loop over the steps, timed in
     its one checking run); B8 on level 4's claims of the mixed bytes,
     LDM spans 0, 4 and 16, caps 24 and 32; B15 and B16 on the L1 and L9
     parses of the batch and on crafted rows of long chosen matches (to
     65535, across the kernel's steps and tiles, to the row's end) with
     full and ragged lengths, B15 also on one match from position 0 to the
     row's end in every row, 200 calls in a row, each exact (every tile's
     keys rest on the first tile's carry); B8, B15 and B16 each case also
     over 20 back-to-back calls (stream_ms), B15 and B16 beside their
     library yardsticks (library_ms: torch.cummax of B15's int32 match
     ends alone; B16's twin's scatter_add_ into (B, 257) alone); B17 and
     B18 on the parsed branch's parse at level 2's parameters, lazy off
     and on (B17 also on a dense mlen >= 4 mask); B19 on B=64 rows of
     1024, 8192, 16384, 32768 and 131072 and 4 rows of 262144, with 0 and
     1 payloads, random keys, heavy duplicates and duplicate (key, pos)
     pairs, with its bound from bytes or compare-exchanges and torch.sort
     as its library yardstick;
  3. device half: the composed output of each level's device half from
     the kernels on the card against the twins on the CPU, with the ms
     per batch: level 1 at B=128 (LDM on) and B=6 (no whole number of
     LDM spans: LDM off), levels 2, 3 and 4 at B=64 (LDM on), level 4 at
     B=8 (LDM off), levels 5, 9 and 12 at B=64 (LDM on), level 5 at
     B=6 (LDM off), and the producer's shapes: levels 1, 4 and 9 at B=1
     (no LDM) on one block of 131072, 70001, 4097 and 64 bytes
     zero-padded to 128 KiB; with hybrid device entropy, levels 1 and 9
     at B=64 (packed sequences, section words and bits, overflow flags and the
     table plan); with full device entropy the same and every field of
     the literals dict; then the paths of the kernels no level takes, each
     run once with its launches counted toward phase 4's totals:
     find_matches_positions(dense=False) at B=64 (widths (6,), LDM 4,
     greedy; widths (5, 8), LDM 8, lazy: B10 and B17), compact_fast_glue
     on its parse (B18, every dict field) and bitonic_sort as the
     byte-verified matcher's (gram, pos) row sort (B19);
  4. main paths: compress(level=1, batch=128, device="cuda") on a --mb MiB
     corpus plus a 5000-byte tail, then compress(level=L, batch=64) for
     L = 2, 3, 4, 5, 9, 12 on a 32 MiB corpus plus a tail. The launch
     counts are reset just before and read just after each; every frame
     is decoded bit-exactly by stock libzstd, no block may have fallen
     back to the CPU matcher (a content-level block whose device output
     overflows is re-matched on the host by the format's contract and
     counted apart), and each level's kernels must have launched; then
     compress(level=L, batch=64, device_entropy="hybrid") for L = 1 and
     9 on the 32 MiB corpus, where at least one block must carry the
     card's sequence section (a block whose compaction or section
     overflows is re-matched on the host, the reference's contract); and
     the same with device_entropy=True, where at least one block must
     carry the card's literals section as well. Every one of the
     nineteen kernels must have launched on these paths or phase 3's;
  5. port on card vs port on CPU, frames equal: level 1 at batch 8 on 8
     blocks + tail, level 4 at batch 16 on 16 blocks + tail, level 3 at
     batch 8 on 9 blocks (a padded partial batch), level 5 at batch 8 on
     9 blocks and level 12 at batch 4 on 4 blocks + tail; in hybrid
     and in full mode level 1 at batch 8 on 8 blocks + tail and level 5
     at batch 4 on 4 blocks + tail; sequence_producer's triples at levels
     1, 4 and 9 on phase 3's four ragged blocks, and
     compress_via_libzstd(level=1)'s frame on 8 blocks + tail;
  6. producer and streams: compress_via_libzstd(level=1, device="cuda")
     on the --mb corpus plus the tail, at levels 4 and 9 on the 32 MiB
     one, compress_stream_via_libzstd(level=1) on 16 MiB in chunks of
     100000 bytes with a flush every 2 (ragged blocks), and
     StreamCompressor(level=1, batch=8) fed the --mb corpus in 1 MiB
     chunks. The launch counts are reset just before and read just after
     each; every frame is decoded bit-exactly by stock libzstd; no
     producer error; every block of 64 bytes or more went through the
     device half (every full block, for StreamCompressor); each level's
     kernels launched. Each run prints its ratio and MB/s beside stock
     libzstd's at the same level on the same bytes, and the producer
     runs each call's latency (p50, p99, max), timed by a wrapper here
     around the package's sequence_producer;
  7. scale-out: compress_mesh(level=1, device="cuda") on the --mb corpus
     plus the tail in this process, an NCCL process group of one (made
     here: parallel.distributed.init joins nothing for a world of one);
     then two spawned ranks in a gloo group, each driving this one card,
     run compress_mesh at level 1 on the same bytes and at levels 4 and 9
     on the 32 MiB corpus plus the tail. The launch counts are reset just
     before and read just after each run, in each process. Every frame
     must equal GpuCodec(level=L, batch=B).compress(data) on the card,
     B being compress_mesh's row count (the full blocks padded to a
     multiple of lcm(ranks, LDM span)), on every rank; each decodes
     bit-exactly through stock libzstd; each level's kernels launched on
     every rank. Each run prints its ratio and MB/s beside phase 4's
     GpuCodec.compress at its batch. Two ranks on one card measure the
     orchestration (the split, the context spans, the gather), not
     scaling: NCCL across cards is not exercised on one card.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a result
when there is no CUDA device or the port is not beside this script.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import multiprocessing
import os
import socket
import sys
import time
import traceback
from queue import Empty

import numpy as np

BLOCK = 131072
BATCH = 128  # bench.py's L1 headline batch
DENSE_BATCH = 64  # bench.py's device level ladder batch (levels 2-12)
DENSE_MB = 32  # level 2-12 corpus size in MiB (plus a tail)
DENSE_LEVELS = (2, 3, 4)
CONTENT_LEVELS = (5, 9, 12)
TAIL = 5000
WINDOW = 32768
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # SMs x int32 lanes x boost clock
L1_SRC = "qat_zstd_plugin_tpu_torch/csrc/l1_kernels.cu"
DENSE_SRC = "qat_zstd_plugin_tpu_torch/csrc/dense_kernels.cu"
CONTENT_SRC = "qat_zstd_plugin_tpu_torch/csrc/content_kernels.cu"
VERIFIED_SRC = "qat_zstd_plugin_tpu_torch/csrc/verified_kernels.cu"
FSE_SRC = "qat_zstd_plugin_tpu_torch/csrc/fse_kernels.cu"
LITERALS_SRC = "qat_zstd_plugin_tpu_torch/csrc/literals_kernels.cu"
PARSED_SRC = "qat_zstd_plugin_tpu_torch/csrc/parsed_kernels.cu"
SORT_SRC = "qat_zstd_plugin_tpu_torch/csrc/sort_kernels.cu"
REF = "qat_zstd_plugin_tpu/ops/glue_kernels.py"
LIT_REF = "qat_zstd_plugin_tpu/ops/literals_kernel.py"
HYBRID_LEVELS = (1, 9)  # hybrid device entropy: the hash and content paths
WINMIN_STRIDES = tuple(1 << s for s in range(13))  # B6's and B9's: 1-4096
MAX_SEQ = 16384  # GpuCodec's max_seq, bench.py's hybrid row
# The producer's shapes: one block a call (batch 1, no LDM), zero-padded
# to 128 KiB, at a full length, ragged ones (a flush-forced or the last
# block) and the device half's least.
PRODUCER_LEVELS = (1, 4, 9)
PRODUCER_LENGTHS = (131072, 70001, 4097, 64)
STREAM_MB = 16  # compress_stream_via_libzstd's input in MiB
STREAM_CHUNK, STREAM_FLUSH = 100000, 2
FEED_CHUNK = 1 << 20  # StreamCompressor's chunks
# Phase 7: compress_mesh's levels (the --mb corpus at level 1, the 32 MiB
# one at 4 and 9) and the gloo ranks sharing the card.
MESH_LEVELS = (1, 4, 9)
MESH_RANKS = 2
MESH_TIMEOUT_S = 600
# Each CUDA kernel: its source and the Pallas kernel it replaces.
KERNELS = {
    "hash_keys_winmin_sync": (L1_SRC, f"{REF}:192"),
    "neighbor_unsort_keys": (L1_SRC, f"{REF}:490"),
    "ldm_keys": (L1_SRC, f"{REF}:1127"),
    "compact_slots_sync": (L1_SRC, f"{REF}:1379"),
    "hash_keys": (DENSE_SRC, f"{REF}:106"),
    "hash_keys_winmin": (DENSE_SRC, f"{REF}:148"),
    "finalize_candidates": (DENSE_SRC, f"{REF}:559"),
    "compact_slots_dense": (DENSE_SRC, f"{REF}:1289"),
    "ldm_winmin": (CONTENT_SRC, f"{REF}:1088"),
    "parse_greedy": (CONTENT_SRC,
                     "qat_zstd_plugin_tpu/ops/parse_kernel.py:35"),
    "gram_pos_planes": (VERIFIED_SRC, f"{REF}:282"),
    "neighbor_verify_keys": (VERIFIED_SRC, f"{REF}:335"),
    "finalize_verified": (VERIFIED_SRC, f"{REF}:382"),
    "fse_state": (FSE_SRC, "qat_zstd_plugin_tpu/ops/fse_kernel.py:102"),
    "literal_keys": (LITERALS_SRC, f"{LIT_REF}:41"),
    "byte_hist": (LITERALS_SRC, f"{LIT_REF}:94"),
    "compact_slots": (PARSED_SRC, f"{REF}:988"),
    "compact_operands": (PARSED_SRC, f"{REF}:668"),
    "bitonic_sort": (SORT_SRC, "qat_zstd_plugin_tpu/ops/sort_kernel.py:91"),
}
# The kernels each level's main path must launch.
_DENSE = ("hash_keys_winmin", "neighbor_unsort_keys", "ldm_keys",
          "finalize_candidates", "compact_slots_dense")
_CONTENT = ("ldm_winmin", "ldm_keys", "neighbor_unsort_keys", "parse_greedy")
LEVEL_KERNELS = {
    1: ("hash_keys_winmin_sync", "neighbor_unsort_keys", "ldm_keys",
        "compact_slots_sync"),
    2: _DENSE,  # one width: no hash_keys
    3: _DENSE + ("hash_keys",),
    4: _DENSE + ("hash_keys",),
    **dict.fromkeys(CONTENT_LEVELS, _CONTENT),
}
# With hybrid device entropy (no LDM in that mode).
HYBRID_KERNELS = {
    1: ("gram_pos_planes", "neighbor_verify_keys", "finalize_verified",
        "parse_greedy", "fse_state"),
    9: ("parse_greedy", "fse_state"),
}
# With full device entropy: the hybrid kernels and the literals' two.
FULL_KERNELS = {level: kernels + ("literal_keys", "byte_hist")
                for level, kernels in HYBRID_KERNELS.items()}


_T0 = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One JSON line; t_s is the seconds since the script started."""
    print(json.dumps({"phase": name, **fields,
                      "t_s": round(time.perf_counter() - _T0, 1)}),
          flush=True)


def exact(torch, got, want, what: str) -> int:
    """Max |got - want| over the words; raises unless 0."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"{what}: kernel differs from twin "
                             f"(max abs err {err})")
    return err


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(moved: int) -> dict:
    """The least time for a function that must move `moved` bytes: every
    kernel here does a few integer operations per byte, far below the
    card's 67 TFLOP/s (fp32) per 3.35 TB/s, so bytes bound each."""
    return {"bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None}


def _ragged(torch, rng, B: int, N: int, dev):
    lengths = rng.integers(0, N + 1, B).astype(np.int32)
    lengths[0] = N
    return torch.from_numpy(lengths).to(dev)


def kernels_vs_twins(torch, tk, blocks_np: np.ndarray, seed: int,
                     results: dict) -> None:
    """Phase 2, K1 and K4 against their twins on the card, every case also
    back to back (stream_ms). K1 with the LDM samples and with the plane,
    flip 0 and the sign flip, at stride 32 on corpus, random and mixed
    bytes at B=128 x 128 KiB and on 37 rows of 65536 and 64 of 4100 mixed
    bytes (a row ending inside a warp's tile), and at every stride from 1
    to 4096 and 0 on the rows of 4100; its main case is the main path's,
    the samples with the flip on the corpus. K4 on level 1's pair rows of
    the corpus with ragged lengths, with the LDM rows of span 4 and
    without, flip 0 and the sign flip; its main case the main path's (span
    4, the flip). K2 and K3, which make K4's inputs, are checked in
    unsort_kernels_vs_twins."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    B, N = blocks_np.shape
    width, span = 6, 4
    stride = tk.ldm_stride(span, N)
    pbits = (WINDOW - 1).bit_length()
    blocks = torch.from_numpy(blocks_np).to(dev)
    rand, mixed = _test_bytes(torch, blocks, rng)
    ragged = _ragged(torch, rng, B, N, dev)
    case = Cases(results)
    flips = (0, tk._FLIP)

    def k1(what, x, s, main_case=False):
        err = 0
        for samples in (True, False):
            for f in flips:
                got = tk.hash_keys_winmin_sync(x, width, WINDOW, s, f,
                                               samples)
                want = tk.hash_keys_winmin_sync_twin(x, width, WINDOW, s, f,
                                                     samples)
                err = max(err, exact(torch, got[0], want[0],
                                     f"hash_keys_winmin_sync keys ({what})"),
                          0 if s == 0 else exact(
                              torch, got[1], want[1],
                              f"hash_keys_winmin_sync minima ({what}, "
                              f"samples={samples})"))
        for samples in (True, False) if s else (True,):
            run = lambda: tk.hash_keys_winmin_sync(x, width, WINDOW, s,
                                                   tk._FLIP, samples)
            out = run()
            case("hash_keys_winmin_sync",
                 f"{what}, stride {s}, samples={samples}, flip", err,
                 nbytes(x, *out), run,
                 lambda: tk.hash_keys_winmin_sync_twin(
                     x, width, WINDOW, s, tk._FLIP, samples),
                 main=main_case and samples, stream_ms=stream_ms(torch, run))

    for what, x in (("corpus bytes", blocks), ("random bytes", rand),
                    ("mixed bytes", mixed),
                    ("B=37, N=65536", mixed[:37, :65536].contiguous())):
        k1(what, x, stride, main_case=what == "corpus bytes")
    small = mixed[:64, :4100].contiguous()
    for s in (0,) + WINMIN_STRIDES:
        k1("B=64, N=4100", small, s)

    # K4 on the main path's pair rows and LDM rows.
    key, samples = tk.hash_keys_winmin_sync(blocks, width, WINDOW, stride,
                                            samples=True)
    su = tk._unsorted(key, pbits, 1, WINDOW - 1)
    su_l = tk.ldm_unsorted(samples, span, 1, stride=1)
    for sp in (4, 0):
        rows = su_l if sp else None
        want = tk.compact_slots_sync_twin(su, WINDOW, ragged, width, rows, sp)
        err = max(exact(torch, tk.compact_slots_sync(
                      a, WINDOW, ragged, width, r, sp, flip=f), want,
                      f"compact_slots_sync (LDM span {sp}, flip {f:#x})")
                  for a, r, f in ((su, rows, 0),
                                  (su ^ tk._SIGN, None if rows is None
                                   else rows ^ tk._SIGN, tk._FLIP)))
        a, r = su ^ tk._SIGN, None if rows is None else rows ^ tk._SIGN
        run = lambda: tk.compact_slots_sync(a, WINDOW, ragged, width, r, sp,
                                            flip=tk._FLIP)
        # K4 reads the span's half of each LDM row.
        ldm_read = 0 if r is None else nbytes(r) // 2
        case("compact_slots_sync", f"LDM span {sp}, flip, ragged lengths",
             err, nbytes(a, ragged, want) + ldm_read, run,
             lambda: tk.compact_slots_sync_twin(a, WINDOW, ragged, width, r,
                                                sp, flip=tk._FLIP),
             main=sp == 4, stream_ms=stream_ms(torch, run))
    torch.cuda.synchronize()


def _crafted_unsort_rows(rng, w: int = 8192) -> np.ndarray:
    """Three rows of K2 input (hash << 13 | pos, pbits 13) whose runs of
    equal hashes straddle every chunk edge: sorted with 4 hash values,
    sorted with one, and unsorted with 4 (earlier entries with larger
    positions claim nothing)."""
    pos = rng.permutation(w).astype(np.int64)
    rows = [np.sort((rng.integers(0, 4, w) << 13) | pos),
            np.sort((7 << 13) | pos),
            (rng.integers(0, 4, w) << 13) | rng.integers(0, w, w)]
    return np.stack(rows).astype(np.uint32).view(np.int32)


def unsort_kernels_vs_twins(torch, tk, blocks_np: np.ndarray,
                            dense_np: np.ndarray, seed: int,
                            results: dict) -> None:
    """Phase 2, K2 and K3: every case against its twin with flip 0 (the
    public wrappers) and with the sign flip (the main path's signed row
    sorts), timed through the public wrapper, one call (ms) and back to
    back (stream_ms). K2's main case is level 1's pair rows and K3's level
    1's span 4, both at B=128 x 128 KiB; beside them, back to back, what
    torch takes to move the same bytes: copy_ms, a clone of K2's input,
    and gather_ms, K3's sampled words copied out of the plane (the same
    sector reads, half its writes)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 5)
    pbits = (WINDOW - 1).bit_length()
    case = Cases(results)
    sign = tk._SIGN

    def k2(what, sk, pb, nb, pmask=None, main=False):
        err = max(exact(torch,
                        tk.neighbor_unsort_keys(x, pb, nb, pmask, flip=f),
                        tk.neighbor_unsort_keys_twin(x, pb, nb, pmask, f),
                        f"neighbor_unsort_keys ({what}, flip {f:#x})")
                  for x, f in ((sk, 0), (sk ^ sign, tk._FLIP)))
        run = lambda: tk.neighbor_unsort_keys(sk, pb, nb, pmask)
        extra = {"copy_ms": stream_ms(torch, sk.clone)} if main else {}
        case("neighbor_unsort_keys", what, err, 2 * nbytes(sk), run,
             lambda: tk.neighbor_unsort_keys_twin(sk, pb, nb, pmask),
             main=main, stream_ms=stream_ms(torch, run), **extra)

    def k3(what, minz, span, main=False, stride=None):
        stride = stride or tk.ldm_stride(span, minz.shape[1])
        err = max(exact(torch, tk.ldm_keys(minz, span, stride, flip=f),
                        tk.ldm_keys_twin(minz, span, stride, f),
                        f"ldm_keys ({what}, flip {f:#x})")
                  for f in (0, tk._FLIP))
        run = lambda: tk.ldm_keys(minz, span, stride, flip=tk._FLIP)
        out = run()
        samples = minz.shape[0] * (minz.shape[1] // stride)
        extra = {"gather_ms": stream_ms(
            torch, lambda: minz[:, ::stride].contiguous())} \
            if stride > 1 else {}
        case("ldm_keys", what, err, 4 * samples + nbytes(out), run,
             lambda: tk.ldm_keys_twin(minz, span, stride, tk._FLIP),
             main=main, stream_ms=stream_ms(torch, run), **extra,
             sector_floor_ms=((32 if stride > 1 else 4) * samples
                              + nbytes(out)) / HBM_BYTES_PER_S * 1e3)

    # Level 1: the pair rows and the LDM rows of the B=128 batch.
    blocks = torch.from_numpy(blocks_np).to(dev)
    N = blocks.shape[1]
    key, m = tk.hash_keys_winmin_sync(blocks, 6, WINDOW, tk.ldm_stride(4, N))
    samples = tk.hash_keys_winmin_sync(blocks, 6, WINDOW,
                                       tk.ldm_stride(4, N), samples=True)[1]
    sk = tk._sort_rows(key)
    lk = tk._sort_rows(tk.ldm_keys(m, 4, tk.ldm_stride(4, N)))
    k2("pair rows, neighbors 1", sk, pbits, 1, WINDOW - 1, main=True)
    k2("LDM rows, neighbors 1", lk, (lk.shape[1] - 1).bit_length(), 1)
    k2("one pair row", sk[:1].contiguous(), pbits, 1, WINDOW - 1)
    # Full-resolution rows of the B=64 batch (level 4 takes neighbors 2);
    # 7 and 100 take the kernel's far-neighbor instantiation.
    corpus = torch.from_numpy(dense_np).to(dev)
    _, mixed = _test_bytes(torch, corpus, rng)
    full = tk._sort_rows(tk.hash_keys(mixed, 4, WINDOW))
    for nb in (2, 3, 7):
        k2(f"full-resolution rows, neighbors {nb}", full, pbits, nb)
    k2("16 full-resolution rows, neighbors 100", full[:16].contiguous(),
       pbits, 100)
    # A row that ends in a part of a CTA (4100 words: 4 CTAs of 1024 and
    # one thread's 4) and a width that is no multiple of 4 (the scalar
    # path).
    for w in (4100, 4097):
        k2(f"rows of {w}, neighbors 2", full[:, :w].contiguous(), pbits, 2)
    crafted = torch.from_numpy(_crafted_unsort_rows(rng)).to(dev)
    for nb in (1, 3, 100):
        k2(f"crafted rows across chunk edges, neighbors {nb}", crafted, 13,
           nb)

    # K3 at level 1's span 4 on K1's samples (the main path's, stride 1)
    # and on its plane, levels 3 and 4's spans 8 and 16 on the B=64
    # planes, one span (all context the fill), two spans, and 1027 samples
    # a block (a part of a CTA).
    k3("span 4, K1's samples", samples, 4, main=True, stride=1)
    k3("span 4, K1's plane", m, 4)
    for span in (8, 16):
        stride = tk.ldm_stride(span, N)
        k3(f"span {span}", tk.hash_keys_winmin(mixed, 4, WINDOW, stride)[1],
           span)
    k3("one span", m[:4].contiguous(), 4)
    k3("two spans", m[:8].contiguous(), 4)
    k3("1027 samples a block", m[:8, :32 * 1027].contiguous(), 4)
    torch.cuda.synchronize()


class Cases:
    """Phase 2 cases of the B=64 kernels: one line per case with its
    times; the case marked main is the kernel's row in the results. Of a
    case's extra fields only the measured times (MEASURED) go into that
    row; a computed one (a floor, a chain length) stays on the case's
    line."""

    MEASURED = ("stream_ms", "copy_ms", "gather_ms")

    def __init__(self, results: dict):
        self.results = results

    def __call__(self, kernel: str, name: str, err: int, moved: int,
                 kernel_fn, twin_fn, main: bool = False, library_fn=None,
                 **extra) -> None:
        """twin_fn is the twin to time, or its time in ms when the check
        already timed it (B14's twin runs for seconds); library_fn the
        PyTorch call timed as the kernel's library yardstick."""
        from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
        r = {"max_abs_err": err, "ms": cuda_ms(kernel_fn),
             "plain_ms": twin_fn if isinstance(twin_fn, float)
             else cuda_ms(twin_fn), **bound(moved)}
        if library_fn is not None:
            r["library_ms"] = cuda_ms(library_fn)
        phase("kernel_case", kernel=kernel, case=name, **r, **extra)
        prev = self.results.get(kernel)
        if main or prev is None:
            self.results[kernel] = {
                **r, **{k: v for k, v in extra.items()
                        if k in self.MEASURED},
                "max_abs_err": max(err, prev["max_abs_err"] if prev else 0)}
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)


def _test_bytes(torch, corpus, rng):
    """Random bytes, and the corpus with an all-same block and runs past
    the caps (16383 and 65535), one across a segment boundary and one to
    the row's end."""
    B, N = corpus.shape
    rand = torch.from_numpy(rng.integers(0, 256, (B, N), np.uint8)) \
        .to(corpus.device)
    mixed = corpus.clone()
    mixed[1] = 0x41
    mixed[2, 20000:60000] = 7
    mixed[3, N - 20000:] = 9
    mixed[4, 1000:70000] = 0xC3
    return rand, mixed


def _winmin_inputs(torch, corpus, rand, mixed):
    """(what, blocks) of B5's, B6's and B9's cases: corpus, random and
    mixed bytes at B=64 x 128 KiB, then 37 rows of 65536 and 64 rows of
    4100 mixed bytes (a row ending inside a warp's tile) and one row of
    8 bytes."""
    return [("corpus bytes", corpus), ("random bytes", rand),
            ("mixed bytes", mixed),
            ("B=37, N=65536", mixed[:37, :65536].contiguous()),
            ("B=64, N=4100", mixed[:, :4100].contiguous()),
            ("one row of 8 bytes", mixed[:1, :8].contiguous())]


SPIN_CYCLES = 4_000_000  # about 2 ms of the card's clock (1.98 GHz)


def stream_ms(torch, fn, calls: int = 20) -> float:
    """Milliseconds a call over `calls` back-to-back calls of fn(), the
    median of 5 runs by CUDA events: the card's time alone. The calls are
    queued behind a 2 ms spin on the card (torch.cuda._sleep), so no
    launch waits for the wrapper's host time, even where that is longer
    than the kernel; `ms` (one call between two events) adds the host
    time before the launch."""
    import statistics
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _edge_lengths(torch, rng, B: int, N: int, dev):
    """Ragged lengths with N, 0, 1, 3, 4 and N - 10 among them."""
    lengths = rng.integers(0, N + 1, B).astype(np.int32)
    lengths[:6] = (N, 0, 1, 3, 4, N - 10)
    return torch.from_numpy(lengths).to(dev)


def _finalize_inputs(torch, rng, corpus, rand, mixed, lengths):
    """(what, blocks, lengths) of B7's and B13's cases besides their main
    ones: corpus, random and mixed bytes apart at the main lengths, then
    B=37 rows of 65536 mixed bytes (an all-same row, runs past the cap,
    one to the row's end) and 64 rows of 4100, ragged lengths."""
    B = corpus.shape[0]
    small = [(37, 65536), (B, 4100)]
    return [("corpus bytes", corpus, lengths), ("random bytes", rand, lengths),
            ("mixed bytes", mixed, lengths)] + [
        (f"B={b}, N={n}, ragged", mixed[:b, :n].contiguous(),
         _edge_lengths(torch, rng, b, n, corpus.device)) for b, n in small]


def dense_kernels_vs_twins(torch, tk, blocks_np: np.ndarray, seed: int,
                           results: dict) -> None:
    """Phase 2, the level 2-4 kernels (and K2, K3 at their level 2-4
    arguments) against their twins on the card, at B=64 × 128 KiB."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 2)
    B, N = blocks_np.shape
    pbits = (WINDOW - 1).bit_length()
    corpus = torch.from_numpy(blocks_np).to(dev)
    rand, mixed = _test_bytes(torch, corpus, rng)
    ragged = _ragged(torch, rng, B, N, dev)
    case = Cases(results)

    # B5 at every width and B6 at every stride, on corpus, random and
    # mixed bytes and the ragged shapes, in both flip modes; timed on the
    # mixed bytes with the main path's flip, beside torch's widening copy
    # of the same bytes (B5: n read, 4n written; B6: n read, 8n written).
    inputs = _winmin_inputs(torch, corpus, rand, mixed)
    flips = (0, tk._FLIP)
    for width in (4, 5, 6, 8):
        err = max(exact(torch, tk.hash_keys(x, width, WINDOW, flip=f),
                        tk.hash_keys_twin(x, width, WINDOW, f),
                        f"hash_keys width {width} ({what}, flip {f:#x})")
                  for what, x in inputs for f in flips)
        run = lambda: tk.hash_keys(mixed, width, WINDOW, flip=tk._FLIP)
        case("hash_keys", f"width {width}", err, 5 * nbytes(mixed), run,
             lambda: tk.hash_keys_twin(mixed, width, WINDOW, tk._FLIP),
             main=width == 6, stream_ms=stream_ms(torch, run),
             copy_ms=stream_ms(torch, lambda: mixed.to(torch.int32)))

    # B6 at every stride (32 and 64 are spans 4/8 and 16's): its main case
    # is level 4's stride 64.
    minz = {}
    for stride in WINMIN_STRIDES:
        err = 0
        for what, x in inputs:
            for f in flips:
                k, m = tk.hash_keys_winmin(x, 4, WINDOW, stride, flip=f)
                tw_k, tw_m = tk.hash_keys_winmin_twin(x, 4, WINDOW, stride, f)
                err = max(err, exact(torch, k, tw_k,
                                     f"hash_keys_winmin keys {stride} "
                                     f"({what}, flip {f:#x})"),
                          exact(torch, m, tw_m,
                                f"hash_keys_winmin minz {stride} ({what})"))
        minz[stride] = tk.hash_keys_winmin(mixed, 4, WINDOW, stride)[1]
        run = lambda: tk.hash_keys_winmin(mixed, 4, WINDOW, stride,
                                          flip=tk._FLIP)
        case("hash_keys_winmin", f"stride {stride}", err, 9 * nbytes(mixed),
             run,
             lambda: tk.hash_keys_winmin_twin(mixed, 4, WINDOW, stride,
                                              tk._FLIP),
             main=stride == 64, stream_ms=stream_ms(torch, run),
             copy_ms=stream_ms(torch, lambda: mixed.to(torch.int64)))

    # The LDM estimates of spans 4 and 16 for B8.
    ests = {span: tk._ldm_est(tk.ldm_unsorted(
        minz[tk.ldm_stride(span, N)], span), ragged, N, span, 1 << 19)
        for span in (4, 16)}

    # B7 at each level's widths, ragged lengths, on the mixed corpus and
    # on random bytes; the twin chunks two widths per pass.
    for widths, nb in (((6,), 1), ((5, 8), 1), ((4, 5, 6, 8), 2)):
        err = 0
        for x in (rand, mixed):
            sus = [tk._unsorted(tk.hash_keys(x, w, WINDOW), pbits, nb)
                   for w in widths]
            ml, mo = tk.finalize_candidates(sus, x, ragged, widths, WINDOW)
            tw_ml, tw_mo = tk.finalize_candidates_twin(sus, x, ragged,
                                                       widths, WINDOW)
            err = max(err,
                      exact(torch, ml, tw_ml, f"finalize mlen {widths}"),
                      exact(torch, mo, tw_mo, f"finalize moff {widths}"))
        run = (lambda: tk.finalize_candidates(sus, x, ragged, widths,
                                              WINDOW))
        case("finalize_candidates", f"widths {widths}", err,
             nbytes(*sus, x, ragged, ml, mo), run,
             lambda: tk.finalize_candidates_twin(sus, x, ragged, widths,
                                                 WINDOW),
             main=len(widths) == 4, stream_ms=stream_ms(torch, run))
    mixed_claims = ml, mo  # B8's input: level 4's claims on the mixed rows
    # B7 at four widths on each kind of bytes apart (its time should not
    # depend on them), then B=37 rows of 65536 and 64 rows of 4100 (one
    # segment) with ragged lengths, 0, 1, 3, 4 and N - 10 among them.
    for what, x, lens in _finalize_inputs(torch, rng, corpus, rand, mixed,
                                          ragged):
        pb = (min(WINDOW, x.shape[1]) - 1).bit_length()
        sus = [tk._unsorted(tk.hash_keys(x, w, WINDOW), pb, 2)
               for w in widths]
        ml, mo = tk.finalize_candidates(sus, x, lens, widths, WINDOW)
        tw_ml, tw_mo = tk.finalize_candidates_twin(sus, x, lens, widths,
                                                   WINDOW)
        err = max(exact(torch, ml, tw_ml, f"finalize mlen ({what})"),
                  exact(torch, mo, tw_mo, f"finalize moff ({what})"))
        run = lambda: tk.finalize_candidates(sus, x, lens, widths, WINDOW)
        case("finalize_candidates", f"widths {widths}, {what}", err,
             nbytes(*sus, x, lens, ml, mo), run,
             lambda: tk.finalize_candidates_twin(sus, x, lens, widths,
                                                 WINDOW),
             stream_ms=stream_ms(torch, run))
    ml, mo = mixed_claims

    # B8 on the level-4 claims of the mixed corpus, with and without LDM
    # estimates (spans 4 and 16), at both local caps.
    for cap in (24, 32):
        for span in (0, 4, 16):
            est, off = ests[span] if span else (None, None)
            err = exact(
                torch, tk.compact_slots_dense(ml, mo, WINDOW, est, off, cap),
                tk.compact_slots_dense_twin(ml, mo, WINDOW, est, off, cap),
                f"compact_slots_dense cap {cap} span {span}")
            run = lambda: tk.compact_slots_dense(ml, mo, WINDOW, est, off,
                                                 cap)
            case("compact_slots_dense", f"cap {cap}, LDM span {span}", err,
                 nbytes(ml, mo, est, off) + nbytes(ml) // 4, run,
                 lambda: tk.compact_slots_dense_twin(ml, mo, WINDOW, est,
                                                     off, cap),
                 main=(cap, span) == (32, 16),
                 stream_ms=stream_ms(torch, run))
    torch.cuda.synchronize()


def _crafted_lengths(B: int, N: int, rng) -> np.ndarray:
    """Candidate lengths for B10: all-zero rows, rows with every length
    >= 4, matches across the kernel's 4096-position chunk edges, lazy ties,
    strictly longer look-aheads, and matches that end exactly at N or
    pass it."""
    m = np.where(rng.random((B, N)) < 0.3, rng.integers(0, 40, (B, N)), 0)
    m = m.astype(np.int32)
    m[0] = 0
    m[1] = rng.integers(4, 9, N)
    m[2, :] = 7                                   # lazy ties everywhere
    for edge in range(4096, N, 4096):
        m[3, edge - 5] = 30                      # crosses the staging edge
        m[4, edge - 1] = 4                       # look-ahead on the next chunk
        m[4, edge] = 5
    m[5, N - 20] = 20                            # ends exactly at N
    m[6, N - 3:] = 60                            # passes N
    m[7, :] = np.arange(N) % 64                  # rising runs
    return m


def _visited(torch, chosen, mlen) -> int:
    """Positions the parse's cursor visits: all but the interiors of the
    chosen matches (the data-dependent reads of B10)."""
    N = mlen.shape[1]
    pos = torch.arange(N, device=mlen.device)
    inner = torch.where(chosen, torch.clamp(pos + mlen, max=N) - pos - 1, 0)
    return int(chosen.numel() - inner.sum())


def content_kernels_vs_twins(torch, tk, pk, mp, blocks_np: np.ndarray,
                             seed: int, results: dict) -> None:
    """Phase 2, the level 5-12 kernels against their twins on the card, at
    B=64 × 128 KiB."""
    from qat_zstd_plugin_tpu_torch.runtime.levels import (TPU_LEVEL_TABLE,
                                                          level_params)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 3)
    B, N = blocks_np.shape
    corpus = torch.from_numpy(blocks_np).to(dev)
    rand, mixed = _test_bytes(torch, corpus, rng)
    case = Cases(results)

    # B9 at every stride on corpus, random and mixed bytes and the ragged
    # shapes; timed on the mixed bytes beside torch's widening copy (n
    # read, 4n written). Its main case is spans 4 and 8's stride 32.
    inputs = _winmin_inputs(torch, corpus, rand, mixed)
    for stride in WINMIN_STRIDES:
        err = max(exact(torch, tk.ldm_winmin(x, stride),
                        tk.ldm_winmin_twin(x, stride),
                        f"ldm_winmin stride {stride} ({what})")
                  for what, x in inputs)
        run = lambda: tk.ldm_winmin(mixed, stride)
        case("ldm_winmin", f"stride {stride}", err, 5 * nbytes(mixed), run,
             lambda: tk.ldm_winmin_twin(mixed, stride), main=stride == 32,
             stream_ms=stream_ms(torch, run),
             copy_ms=stream_ms(torch, lambda: mixed.to(torch.int32)))

    # B10 on the L5 and L12 parse inputs of the batch and on crafted rows.
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    inputs = {}
    for level in (5, 12):
        p = TPU_LEVEL_TABLE[level]
        inputs[f"L{level} candidates"] = mp.content_candidates(
            corpus, lengths, p.neighbors, p.stride, p.window, p.ldm,
            1 << level_params(level).window_log)[0]
    inputs["crafted rows"] = torch.from_numpy(
        _crafted_lengths(B, N, rng)).to(dev)
    for what, mlen in inputs.items():
        for lazy in (False, True):
            chosen = pk.parse_greedy(mlen, lazy)
            err = exact(torch, chosen, pk.parse_greedy_twin(mlen, lazy),
                        f"parse_greedy {what} lazy={lazy}")
            run = lambda: pk.parse_greedy(mlen, lazy)
            case("parse_greedy", f"{what}, lazy={lazy}", err,
                 4 * _visited(torch, chosen, mlen) + nbytes(chosen), run,
                 lambda: pk.parse_greedy_twin(mlen, lazy),
                 main=(what, lazy) == ("L5 candidates", True),
                 stream_ms=stream_ms(torch, run))
    torch.cuda.synchronize()


def _crafted_sequences(torch, rng, B: int, dev, S: int = MAX_SEQ) -> dict:
    """Compacted sequences for B14: blocks of 0, 1, 2, S - 1 and S
    sequences and counts in between, literal and match lengths past 65535,
    offsets up to 2^17."""
    nseq = rng.integers(0, S + 1, B).astype(np.int32)
    nseq[:5] = (0, 1, S, S - 1, 2)
    ll = rng.integers(0, 300, (B, S)).astype(np.int32)
    ll[:, ::7] = rng.integers(0, 70000, (B, -(-S // 7)))
    ml = rng.integers(3, 40, (B, S)).astype(np.int32)
    ml[:, ::11] = rng.integers(3, 70000, (B, -(-S // 11)))
    of = rng.integers(1, 1 << 17, (B, S)).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in (
        ("lit_len", ll), ("offset", of), ("match_len", ml), ("nseq", nseq))}


def _timed_once(torch, fn):
    """(fn(), its ms on the card by CUDA events), one run, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _fse_moved(torch, args) -> int:
    """The bytes B14 must move for these inputs: the codes of the active
    steps (1 <= j < nseq) read, the tables, initial states and counts
    read, both (S+1, B) item planes written."""
    codes, tables, inits, nseq = args
    active = int(torch.clamp(nseq.to(torch.int64) - 1, min=0).sum())
    return (12 * active + nbytes(*(t for tb in tables for t in tb), *inits,
                                 nseq) + 2 * nbytes(codes[0]))


def _fse_floor_ms(torch, args) -> float:
    """The split design's own operation floor: each active step of a block
    is walked once from every entry state of the three streams (66 + 34 +
    66 table steps), at the card's int32 rate."""
    nseq = args[3].to(torch.int64)
    active = int(torch.clamp(nseq - 1, min=0).sum())
    return 166 * active / INT32_OPS_PER_S * 1e3


def hybrid_kernels_vs_twins(torch, tk, fk, blocks_np: np.ndarray,
                            seed: int, results: dict) -> None:
    """Phase 2, the hybrid device-entropy kernels (B11-B14) against their
    twins on the card, at B=64 x 128 KiB."""
    from qat_zstd_plugin_tpu_torch import GpuCodec
    from qat_zstd_plugin_tpu_torch.profile_l1 import hybrid_first_stage
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 4)
    B, N = blocks_np.shape
    pbits = (WINDOW - 1).bit_length()
    corpus = torch.from_numpy(blocks_np).to(dev)
    rand, mixed = _test_bytes(torch, corpus, rng)
    ragged = _ragged(torch, rng, B, N, dev)
    full = torch.full((B,), N, dtype=torch.int32, device=dev)
    case = Cases(results)

    # B11 on random, mixed and corpus bytes.
    err = 0
    for x in (rand, mixed, corpus):
        g, p = tk.gram_pos_planes(x, WINDOW)
        tw_g, tw_p = tk.gram_pos_planes_twin(x, WINDOW)
        err = max(err, exact(torch, g, tw_g, "gram_pos_planes grams"),
                  exact(torch, p, tw_p, "gram_pos_planes positions"))
    run = lambda: tk.gram_pos_planes(corpus, WINDOW)
    case("gram_pos_planes", "corpus, random and mixed bytes", err,
         nbytes(corpus, g, p), run,
         lambda: tk.gram_pos_planes_twin(corpus, WINDOW), main=True,
         stream_ms=stream_ms(torch, run))

    # B12 at neighbors 1 and 2 on the (gram, pos)-sorted rows.
    rows = {name: tk._sort_rows2(*tk.gram_pos_planes(x, WINDOW), pbits)
            for name, x in (("mixed", mixed), ("corpus", corpus))}
    sg, sp = rows["corpus"]
    for neighbors in (1, 2):
        err = max(exact(torch, tk.neighbor_verify_keys(a, b, pbits,
                                                       neighbors),
                        tk.neighbor_verify_keys_twin(a, b, pbits, neighbors),
                        f"neighbor_verify_keys {name} rows, neighbors "
                        f"{neighbors}") for name, (a, b) in rows.items())
        run = lambda: tk.neighbor_verify_keys(sg, sp, pbits, neighbors)
        case("neighbor_verify_keys", f"neighbors {neighbors}", err,
             nbytes(sg, sp, sg), run,
             lambda: tk.neighbor_verify_keys_twin(sg, sp, pbits, neighbors),
             main=neighbors == 2, stream_ms=stream_ms(torch, run))

    # B13 with full and ragged lengths.
    err = 0
    for name, x in (("mixed", mixed), ("corpus", corpus)):
        su = tk._sort_rows(tk.neighbor_verify_keys(*rows[name], pbits, 2))
        for lens in (full, ragged):
            ml, mo = tk.finalize_verified(su, x, lens)
            tw_ml, tw_mo = tk.finalize_verified_twin(su, x, lens)
            err = max(err, exact(torch, ml, tw_ml,
                                 f"finalize_verified mlen ({name})"),
                      exact(torch, mo, tw_mo,
                            f"finalize_verified moff ({name})"))
    run = lambda: tk.finalize_verified(su, corpus, full)
    case("finalize_verified", "corpus and mixed, full and ragged lengths",
         err, nbytes(su, corpus, full, ml, mo), run,
         lambda: tk.finalize_verified_twin(su, corpus, full), main=True,
         stream_ms=stream_ms(torch, run))
    # B13 on each kind of bytes apart at full lengths (its time should not
    # depend on them), then at B=37 x 65536 and 64 x 4100, ragged.
    for what, x, lens in _finalize_inputs(torch, rng, corpus, rand, mixed,
                                          full):
        pb = (min(WINDOW, x.shape[1]) - 1).bit_length()
        sux = tk._sort_rows(tk.neighbor_verify_keys(
            *tk._sort_rows2(*tk.gram_pos_planes(x, WINDOW), pb), pb, 2))
        ml, mo = tk.finalize_verified(sux, x, lens)
        tw_ml, tw_mo = tk.finalize_verified_twin(sux, x, lens)
        err = max(exact(torch, ml, tw_ml, f"finalize_verified mlen ({what})"),
                  exact(torch, mo, tw_mo, f"finalize_verified moff ({what})"))
        run = lambda: tk.finalize_verified(sux, x, lens)
        case("finalize_verified", what, err, nbytes(sux, x, lens, ml, mo),
             run, lambda: tk.finalize_verified_twin(sux, x, lens),
             stream_ms=stream_ms(torch, run))

    # B14 on the L1 and L9 sequences of the batch and on crafted blocks,
    # custom tables on and off; then a batch of 37 blocks (not a multiple
    # of a CTA's blocks) with the nseq edge cases at S = 2048, codes outside
    # a table in two steps.
    batches = {f"L{level} sequences": hybrid_first_stage(
        GpuCodec(level=level, batch=B, max_seq=MAX_SEQ,
                 device_entropy="hybrid"), corpus, full)[0]
        for level in HYBRID_LEVELS}
    batches["crafted"] = _crafted_sequences(torch, rng, B, dev)
    batches["crafted B=37, S=2048"] = _crafted_sequences(torch, rng, 37, dev,
                                                         2048)
    for what, out in batches.items():
        seqs = (out["lit_len"], out["offset"], out["match_len"], out["nseq"])
        for custom in (False, True):
            args = fk.prepare_sections(*seqs, custom=custom)["state_args"]
            if what.startswith("crafted B=37"):
                codes = [c.clone() for c in args[0]]
                codes[0][5] = 70
                codes[1][7] = -3
                args = (codes, *args[1:])
            lo, nb = fk.run_state_kernel(*args)
            (tw_lo, tw_nb), twin_ms = _timed_once(
                torch, lambda: fk.run_state_kernel_twin(*args))
            err = max(exact(torch, lo, tw_lo, f"fse_state items ({what})"),
                      exact(torch, nb, tw_nb, f"fse_state bits ({what})"))
            case("fse_state", f"{what}, custom={custom}", err,
                 _fse_moved(torch, args), lambda: fk.run_state_kernel(*args),
                 twin_ms, main=(what, custom) == ("L1 sequences", True),
                 chain_steps=int(args[3].max()),
                 op_floor_ms=_fse_floor_ms(torch, args))
    torch.cuda.synchronize()


def literals_kernels_vs_twins(torch, lk, blocks_np: np.ndarray, seed: int,
                              results: dict) -> None:
    """Phase 2, the full device-entropy kernels (B15, B16) against their
    twins on the card, at B=64 x 128 KiB: on the L1 and L9 parses of the
    batch and on crafted rows, with full and ragged lengths."""
    from qat_zstd_plugin_tpu_torch import GpuCodec
    from qat_zstd_plugin_tpu_torch.designs.slots_literals import \
        crafted_parse
    from qat_zstd_plugin_tpu_torch.profile_l1 import hybrid_first_stage
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 5)
    B, N = blocks_np.shape
    corpus = torch.from_numpy(blocks_np).to(dev)
    _, mixed = _test_bytes(torch, corpus, rng)
    full = torch.full((B,), N, dtype=torch.int32, device=dev)
    ragged = _ragged(torch, rng, B, N, dev)
    case = Cases(results)
    inputs = {}
    for level in HYBRID_LEVELS:
        _, chosen, mlen = hybrid_first_stage(
            GpuCodec(level=level, batch=B, max_seq=MAX_SEQ,
                     device_entropy=True), corpus, full)
        inputs[f"L{level} parse"] = (corpus, chosen, mlen)
    inputs["crafted long matches"] = (mixed, *crafted_parse(torch, rng, B,
                                                            N, dev))
    gp = torch.arange(N, dtype=torch.int32, device=dev)
    for what, (x, chosen, mlen) in inputs.items():
        ends = torch.where(chosen, gp + mlen, 0)  # the library call's input
        for lens_name, lens in (("full", full), ("ragged", ragged)):
            name = f"{what}, {lens_name} lengths"
            keys = lk.literal_keys(x, lens, chosen, mlen)
            err = exact(torch, keys, lk.literal_keys_twin(x, lens, chosen,
                                                          mlen),
                        f"literal_keys {name}")
            main = (what, lens_name) == ("L1 parse", "full")
            run = lambda: lk.literal_keys(x, lens, chosen, mlen)
            case("literal_keys", name, err,
                 nbytes(x, lens, chosen, mlen, keys), run,
                 lambda: lk.literal_keys_twin(x, lens, chosen, mlen),
                 main=main, library_fn=lambda: torch.cummax(ends, 1),
                 literals=int((keys != -1).sum()),
                 stream_ms=stream_ms(torch, run))
            hist = lk.byte_hist(keys)
            err = exact(torch, hist, lk.byte_hist_twin(keys),
                        f"byte_hist {name}")
            idx = torch.where(keys != -1, keys.to(torch.int64) & 0xFF, 256)
            bins = torch.zeros((B, 257), dtype=torch.int32, device=dev)
            ones = torch.ones_like(idx, dtype=torch.int32)
            run = lambda: lk.byte_hist(keys)
            case("byte_hist", name, err, nbytes(keys, hist), run,
                 lambda: lk.byte_hist_twin(keys), main=main,
                 library_fn=lambda: bins.scatter_add_(1, idx, ones),
                 stream_ms=stream_ms(torch, run))

    # One match from position 0 to the row's end in every row (every
    # other one ends a position short): every tile's keys rest on the
    # first tile's carry, through the look-back. 200 calls in a row.
    chosen = torch.zeros((B, N), dtype=torch.bool, device=dev)
    chosen[:, 0] = True
    mlen = torch.zeros((B, N), dtype=torch.int32, device=dev)
    mlen[:, 0] = N
    mlen[1::2, 0] = N - 1
    want = lk.literal_keys_twin(corpus, full, chosen, mlen)
    err = max(exact(torch, lk.literal_keys(corpus, full, chosen, mlen), want,
                    f"literal_keys carry from the first tile, call {i}")
              for i in range(200))
    run = lambda: lk.literal_keys(corpus, full, chosen, mlen)
    case("literal_keys", "one match from 0 to the row's end, 200 calls",
         err, nbytes(corpus, full, chosen, mlen, want), run,
         lambda: lk.literal_keys_twin(corpus, full, chosen, mlen),
         stream_ms=stream_ms(torch, run))
    torch.cuda.synchronize()


def _sort_bound(n: int, moved: int, rows: int) -> dict:
    """B19's least time: the larger of its bytes at 3.35 TB/s and its
    compare-exchanges (rows * n/2 * log2(n) * (log2(n) + 1) / 2, one
    integer operation each) at the card's int32 rate."""
    m = n.bit_length() - 1
    ops = rows * n // 2 * m * (m + 1) // 2
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _sort_rows_of(kind: str, rng, B: int, n: int):
    """(key, pos) rows for B19: random keys with pos the column, heavy
    duplicate keys, or duplicate (key, pos) pairs (the network's ties)."""
    if kind == "random keys":
        key = rng.integers(-2**31, 2**31, (B, n), np.int64)
        pos = np.broadcast_to(np.arange(n), (B, n))
    elif kind == "heavy duplicates":
        key = rng.integers(0, 17, (B, n))
        pos = np.broadcast_to(np.arange(n), (B, n))
    else:
        key = rng.integers(-2, 2, (B, n))
        pos = rng.integers(-3, 3, (B, n))
    return (np.ascontiguousarray(key, np.int32),
            np.ascontiguousarray(pos, np.int32))


def parsed_kernels_vs_twins(torch, tk, tsk, blocks_np: np.ndarray,
                            seed: int, results: dict) -> None:
    """Phase 2, the kernels no level reaches (B17-B19) against their twins
    on the card: B17 and B18 on the parsed branch's parse at level 2's
    parameters (widths (6,), LDM spans of 4), lazy off and on, at B=64 x
    128 KiB, B17 also on a dense mlen >= 4 mask; B19 at B=64 rows of 1024,
    8192, 16384 (one CTA), 32768 (a cluster of 2) and 131072 (a full
    cluster) and at 4 rows of 262144 (device-memory passes between cluster
    launches), with 0 and 1 payloads, on random keys, heavy duplicates and
    duplicate (key, pos) pairs, with torch.sort of the same order as its
    library yardstick, and the clusters of 8 CTAs the card holds at once."""
    from qat_zstd_plugin_tpu_torch.ops import _build
    from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 6)
    B, N = blocks_np.shape
    corpus = torch.from_numpy(blocks_np).to(dev)
    full = torch.full((B,), N, dtype=torch.int32, device=dev)
    case = Cases(results)
    for lazy in (False, True):
        chosen, mlen, moff = tk.parsed_claims(corpus, full, (6,), 1, WINDOW,
                                              4, 1 << 19, lazy)
        for what, ch in (("parse", chosen), ("dense mlen >= 4 mask",
                                             mlen >= 4)):
            out = tk.compact_slots(ch, moff, WINDOW)
            err = exact(torch, out, tk.compact_slots_twin(ch, moff, WINDOW),
                        f"compact_slots {what} lazy={lazy}")
            run = lambda: tk.compact_slots(ch, moff, WINDOW)
            case("compact_slots", f"L2 {what}, lazy={lazy}", err,
                 nbytes(ch, moff, out), run,
                 lambda: tk.compact_slots_twin(ch, moff, WINDOW),
                 main=(what, lazy) == ("parse", False),
                 claims=int((out != -1).sum()),
                 stream_ms=stream_ms(torch, run))
        ops = tk.compact_operands(chosen, mlen, moff, WINDOW)
        err = max(exact(torch, g, w, f"compact_operands lazy={lazy}")
                  for g, w in zip(ops, tk.compact_operands_twin(
                      chosen, mlen, moff, WINDOW)))
        run = lambda: tk.compact_operands(chosen, mlen, moff, WINDOW)
        case("compact_operands", f"L2 parse, lazy={lazy}, nseg 4", err,
             nbytes(chosen, mlen, moff, *ops), run,
             lambda: tk.compact_operands_twin(chosen, mlen, moff, WINDOW),
             main=not lazy, stream_ms=stream_ms(torch, run))
    phase("bitonic_sort_clusters", n=BLOCK, active_clusters=_build.load()
          .qz_bitonic_active_clusters(BLOCK))
    for n, rows in ((1024, B), (8192, B), (16384, B), (32768, B), (BLOCK, B),
                    (2 * BLOCK, 4)):
        for npay in (0, 1):
            err = 0
            for kind in ("heavy duplicates", "duplicate (key, pos) pairs",
                         "random keys"):
                key, pos = (torch.from_numpy(a).to(dev)
                            for a in _sort_rows_of(kind, rng, rows, n))
                pay = [torch.from_numpy(rng.integers(
                    -2**31, 2**31, (rows, n), np.int64).astype(np.int32))
                    .to(dev) for _ in range(npay)]
                got = tsk.bitonic_sort(key, pos, *pay)
                err = max([err] + [exact(torch, g, w, f"bitonic_sort n={n} "
                                         f"{kind}, {npay} payloads")
                                   for g, w in zip(got, tsk.bitonic_sort_twin(
                                       key, pos, *pay))])
            # Timed on the random keys (the last kind); the library call
            # sorts one int64 word of the same order, then gathers.
            word = ((key ^ -0x80000000).to(torch.int64) << 32) \
                | (pos.to(torch.int64) + (1 << 31))

            def library():
                order = torch.sort(word, dim=1).indices
                return [a.gather(1, order) for a in (key, pos, *pay)]

            moved = 2 * nbytes(key, pos, *pay)
            r = {"max_abs_err": err,
                 "ms": cuda_ms(lambda: tsk.bitonic_sort(key, pos, *pay)),
                 "plain_ms": cuda_ms(lambda: tsk.bitonic_sort_twin(
                     key, pos, *pay), reps=5),
                 **_sort_bound(n, moved, rows),
                 "library_ms": cuda_ms(library)}
            phase("kernel_case", kernel="bitonic_sort",
                  case=f"{rows} rows of n={n}, {npay} payloads", **r)
            if (n, npay) == (BLOCK, 1):  # every case equal, or it raised
                results["bitonic_sort"] = r
    torch.cuda.synchronize()


def _numpy(x):
    """Tensors, also inside tuples and dicts, as numpy arrays: what passes
    between the processes."""
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_numpy(v) for v in x)
    return None if x is None else x.numpy()


def _tensors(torch, x):
    """The inverse of _numpy."""
    if isinstance(x, dict):
        return {k: _tensors(torch, v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_tensors(torch, v) for v in x)
    return None if x is None else torch.from_numpy(x)


def _worker_init() -> None:
    """Each of the two CPU workers takes half the host's cores."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))


def _lengths(B: int, length: int | None):
    """A batch's lengths: every block full, or one block of `length`."""
    return np.full(B, BLOCK if length is None else length, np.int32)


def ragged_bytes(corpus: bytes, n: int) -> bytes:
    """The n-byte block of the producer checks: from 1000 bytes before the
    second block, where even the 4097- and 64-byte blocks hold matches."""
    return corpus[BLOCK - 1000:BLOCK - 1000 + n]


def ragged_block(corpus: bytes, n: int) -> np.ndarray:
    """A (1, 128 KiB) row holding ragged_bytes(corpus, n), zero-padded, as
    sequence_producer hands a block to the device half."""
    row = np.zeros((1, BLOCK), np.uint8)
    row[0, :n] = np.frombuffer(ragged_bytes(corpus, n), np.uint8)
    return row


def cpu_device_half(level: int, blocks_np: np.ndarray, device_entropy=False,
                    length: int | None = None):
    """The CPU side of a phase 3 check, in the worker process: the level's
    device half from the twins, as numpy arrays."""
    import torch
    import qat_zstd_plugin_tpu_torch as qzt
    B = len(blocks_np)
    pipe = qzt.GpuCodec(level=level, batch=B, device="cpu",
                        device_entropy=device_entropy)._pipeline()
    return _numpy(pipe(torch.from_numpy(blocks_np),
                       torch.from_numpy(_lengths(B, length))))


def cpu_triples(level: int, blocks: list) -> list:
    """The CPU side of a phase 5 producer check, in the worker process:
    sequence_producer's triples of each block on a device="cpu" state."""
    import qat_zstd_plugin_tpu_torch as qzt
    state = qzt.create_seqprod_state(level, device="cpu")
    return [qzt.sequence_producer(state, b) for b in blocks]


def cpu_libzstd_frame(level: int, data: bytes) -> bytes:
    """The CPU side of a phase 5 libzstd-driven check, in the worker."""
    import qat_zstd_plugin_tpu_torch as qzt
    return qzt.compress_via_libzstd(data, level=level, device="cpu")


def cpu_parsed_slots(blocks_np: np.ndarray, kw: dict) -> np.ndarray:
    """The CPU side of a parsed-branch check, in the worker process."""
    import torch
    from qat_zstd_plugin_tpu_torch.ops import match_pipeline as mp
    B, N = blocks_np.shape
    return mp.find_matches_positions(
        torch.from_numpy(blocks_np), torch.full((B,), N, dtype=torch.int32),
        **kw).numpy()


def cpu_frame(level: int, batch: int, data: bytes,
              device_entropy=False) -> bytes:
    """The CPU side of a phase 5 check, in the worker process."""
    import qat_zstd_plugin_tpu_torch as qzt
    return qzt.compress(data, level=level, batch=batch, device="cpu",
                        device_entropy=device_entropy)


def hybrid_device_half(torch, qzt, level: int, blocks_np: np.ndarray,
                       device_entropy, want) -> dict:
    """Phase 3 with device entropy: the device half's outputs (packed
    sequences, section words and bits, overflow flags, table plan, and in
    full mode every field of the literals dict), kernels on the card vs
    `want`, the twins' outputs on the CPU (cpu_device_half), and the
    median ms of one batch on the card."""
    from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
    B = len(blocks_np)
    on_card = qzt.GpuCodec(device="cuda", level=level, batch=B,
                           device_entropy=device_entropy)._pipeline()
    dev = torch.device("cuda")
    blocks = torch.from_numpy(blocks_np).to(dev)
    lengths = torch.full((B,), BLOCK, dtype=torch.int32, device=dev)
    got = on_card(blocks, lengths)
    want = _tensors(torch, want)
    what = f"{device_entropy} device half L{level}"
    for name, g, w in zip(("packed", "words", "bits", "sec_over"), got,
                          want):
        exact(torch, g.cpu(), w, f"{what} {name}")
    for name, g, w in (("plan", got[4], want[4]),
                       ("literals", got[5] or {}, want[5] or {})):
        if sorted(g) != sorted(w):
            raise AssertionError(f"{what}: {name} keys")
        for k in w:
            exact(torch, g[k].cpu(), w[k], f"{what} {name} {k}")
    if (want[5] is None) != (device_entropy == "hybrid"):
        raise AssertionError(f"{what}: literals dict in the wrong mode")
    ms = cuda_ms(lambda: on_card(blocks, lengths))
    packed = want[0]
    over = (packed[:, 0, 1] & 1).bool() | want[3]
    lits = {} if want[5] is None else {
        "literals": int(want[5]["n_lit"].sum()),
        "literals_ok_blocks": int((want[5]["ok"] & ~over).sum()),
        "literal_bits": int(want[5]["bits"].reshape(B, 4)[
            want[5]["ok"] & ~over].sum())}
    return {"level": level, "batch": B, "device_entropy": device_entropy,
            "sequences": int(packed[:, 0, 0].sum()),
            "overflow_blocks": int(over.sum()),
            "section_bits": int(want[2][~over].sum()), **lits, "ms": ms,
            "mbs": B * BLOCK / ms / 1e3}


def device_half(torch, qzt, level: int, blocks_np: np.ndarray,
                want: np.ndarray, length: int | None = None) -> dict:
    """Phase 3: the composed output of `level`'s device half, kernels on
    the card vs `want`, the twins' output on the CPU (cpu_device_half),
    every block full or one block of `length`. Returns its size and the
    median time of the kernels' composition on the card, input already on
    the card."""
    from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
    B = len(blocks_np)
    on_card = qzt.GpuCodec(level=level, batch=B, device="cuda")._pipeline()
    dev = torch.device("cuda")
    blocks = torch.from_numpy(blocks_np).to(dev)
    lengths = torch.from_numpy(_lengths(B, length)).to(dev)
    got = on_card(blocks, lengths).cpu()
    exact(torch, got, torch.from_numpy(want),
          f"device half L{level} B={B} length {length or BLOCK}")
    ms = cuda_ms(lambda: on_card(blocks, lengths))
    if level >= 5:  # packed sequences: [nseq, last_literals << 1 | overflow]
        size = {"sequences": int(got[:, 0, 0].sum()),
                "overflow_blocks": int((got[:, 0, 1] & 1).sum())}
    else:  # slot words
        size = {"claims": int((got != -1).sum())}
    return {"level": level, "batch": B, "length": length or BLOCK, **size,
            "ms": ms, "mbs": B * (length or BLOCK) / ms / 1e3}


def _on_card_counted(torch, tk, fn):
    """(fn(), the launch counts of that one run): counts set to 0 just
    before and read just after."""
    tk.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(tk.launches)


# find_matches_positions(dense=False) in phase 3: level 2's parameters
# (greedy) and level 3's with the lazy parse.
PARSED_CASES = (dict(widths=(6,), window=WINDOW, ldm=4, dense=False,
                     lazy=False),
                dict(widths=(5, 8), window=WINDOW, ldm=8, dense=False,
                     lazy=True))


def parsed_paths(torch, tk, mp, tsk, blocks_np: np.ndarray, wants,
                 launches: dict) -> None:
    """Phase 3, the paths that reach B17-B19, each run once on the card with
    its launches counted (added to `launches`), its output held against
    the same path on the CPU (the twins), then timed:
      * find_matches_positions(dense=False), PARSED_CASES, against `wants`
        (cpu_parsed_slots): B10 and B17;
      * compact_fast_glue on the first one's parse: B18, every dict field;
      * bitonic_sort as the (gram, pos) row sort of the byte-verified
        matcher (B11's planes of the batch, 256 rows of 32768), against the
        matcher's own sort on the CPU (one unique int64 word a row): B19.
    """
    from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
    dev = torch.device("cuda")
    B, N = blocks_np.shape
    host = (torch.from_numpy(blocks_np), torch.full((B,), N,
                                                    dtype=torch.int32))
    card = tuple(x.to(dev) for x in host)

    def count(fn):
        out, n = _on_card_counted(torch, tk, fn)
        for k, v in n.items():
            launches[k] += v
        return out

    for kw, want in zip(PARSED_CASES, wants):
        got = count(lambda: mp.find_matches_positions(*card, **kw))
        exact(torch, got.cpu(), torch.from_numpy(want),
              f"parsed slot words {kw}")
        phase("device_half", equal=True, path="find_matches_positions",
              batch=B, **kw, claims=int((got != -1).sum()),
              ms=cuda_ms(lambda: mp.find_matches_positions(*card, **kw)))

    ch, ml, mo = tk.parsed_claims(*card, (6,), 1, WINDOW, 4, 1 << 19, False)
    got = count(lambda: tk.compact_fast_glue(ch, ml, mo, card[1], MAX_SEQ,
                                             WINDOW))
    want = tk.compact_fast_glue(ch.cpu(), ml.cpu(), mo.cpu(), host[1],
                                MAX_SEQ, WINDOW)
    if sorted(got) != sorted(want):
        raise AssertionError("compact_fast_glue: dict keys differ")
    for k, v in want.items():
        exact(torch, got[k].cpu(), v, f"compact_fast_glue {k}")
    phase("device_half", equal=True, path="compact_fast_glue", batch=B,
          max_seq=MAX_SEQ, sequences=int(want["nseq"].sum()),
          overflow_blocks=int(want["overflow"].sum()),
          ms=cuda_ms(lambda: tk.compact_fast_glue(ch, ml, mo, card[1],
                                                  MAX_SEQ, WINDOW)))

    pbits = (WINDOW - 1).bit_length()
    g, p = tk.gram_pos_planes(card[0], WINDOW)
    sg, sp = count(lambda: tsk.bitonic_sort(g, p))
    want = tk._sort_rows2(g.cpu(), p.cpu(), pbits)
    exact(torch, sg.cpu(), want[0], "bitonic_sort (gram, pos) grams")
    exact(torch, sp.cpu(), want[1], "bitonic_sort (gram, pos) positions")
    phase("device_half", equal=True, path="bitonic_sort (gram, pos) rows",
          rows=int(g.shape[0]), n=int(g.shape[1]),
          ms=cuda_ms(lambda: tsk.bitonic_sort(g, p)))


def main_path(torch, qzt, tk, oracle, level: int, batch: int,
              data: bytes, device_entropy=False) -> dict:
    """Phase 4 for one level: compress on the card with the launch counts
    reset just before; decode; no fallback; the level's kernels ran; in
    hybrid and full mode at least one block carries the card's sequence
    section, in full mode also its literals section. Returns the launch
    counts of the run and its e2e MB/s."""
    qzt.compress(data[:BLOCK + TAIL], level=level, batch=batch,
                 device="cuda", device_entropy=device_entropy)  # warm-up
    torch.cuda.synchronize()
    codec = qzt.GpuCodec(level=level, batch=batch, device="cuda",
                         device_entropy=device_entropy)
    tk.reset_launches()
    t0 = time.perf_counter()
    frame = codec.compress(data)
    seconds = time.perf_counter() - t0
    launches = dict(tk.launches)
    # Bit-exact decode through stock libzstd (raises without it).
    if oracle.decompress(frame, len(data)) != data:
        raise AssertionError("libzstd decode differs from the input")
    phase("main_path", level=level, batch=batch,
          device_entropy=device_entropy, input_bytes=len(data),
          frame_bytes=len(frame), ratio=len(frame) / len(data),
          seconds=seconds, e2e_mbs=len(data) / seconds / 1e6,
          decoder="libzstd", device_blocks=codec.device_blocks,
          overflow_blocks=codec.overflow_blocks,
          section_blocks=codec.section_blocks,
          literal_blocks=codec.literal_blocks,
          fallback_blocks=codec.stats.fallback_blocks, launches=launches)
    if codec.stats.fallback_blocks:
        raise AssertionError(f"level {level}: the main path fell back to "
                             "the CPU matcher")
    if codec.device_blocks != len(data) // BLOCK:
        raise AssertionError(f"level {level}: device produced "
                             f"{codec.device_blocks} blocks")
    if device_entropy and not codec.section_blocks:
        raise AssertionError(f"level {level}: no block carried the card's "
                             "sequence section")
    if device_entropy is True and not codec.literal_blocks:
        raise AssertionError(f"level {level}: no block carried the card's "
                             "literals section")
    wanted = {False: LEVEL_KERNELS, "hybrid": HYBRID_KERNELS,
              True: FULL_KERNELS}[device_entropy][level]
    missing = [k for k in wanted if launches[k] == 0]
    if missing:
        raise AssertionError(f"level {level}: kernels never launched on "
                             f"the main path: {missing}")
    return launches, len(data) / seconds / 1e6


def card_vs_cpu(qzt, level: int, batch: int, data: bytes, device_entropy,
                on_cpu: bytes) -> None:
    """Phase 5 for one level: the port's frame on the card equals its
    frame on the CPU (cpu_frame)."""
    on_card = qzt.compress(data, device="cuda", level=level, batch=batch,
                           device_entropy=device_entropy)
    if on_card != on_cpu:
        raise AssertionError(f"level {level}: frames differ between "
                             "device='cuda' and device='cpu'")
    phase("card_vs_cpu", level=level, batch=batch,
          device_entropy=device_entropy, input_bytes=len(data), equal=True,
          frame_bytes=len(on_card))


def producer_card_vs_cpu(qzt, level: int, blocks: list, want: list
                         ) -> None:
    """Phase 5, the producer: sequence_producer's triples of each block on
    a device="cuda" state equal `want`, the CPU's (cpu_triples), and each
    block went through the device half."""
    state = qzt.create_seqprod_state(level, device="cuda")
    for block, w in zip(blocks, want):
        if qzt.sequence_producer(state, block) != w:
            raise AssertionError(f"level {level}: producer triples of a "
                                 f"{len(block)}-byte block differ between "
                                 "the card and the CPU")
    if state.device_blocks != len(blocks) or state.errors:
        raise AssertionError(f"level {level}: {state.device_blocks} device "
                             f"blocks, {state.errors} errors")
    phase("card_vs_cpu", path="sequence_producer", level=level,
          lengths=[len(b) for b in blocks], equal=True,
          triples=[len(w) for w in want])


# The kernels each producer run must launch (batch 1: no LDM).
PRODUCER_KERNELS = {1: ("hash_keys_winmin_sync", "neighbor_unsort_keys",
                        "compact_slots_sync"),
                    4: ("hash_keys", "finalize_candidates",
                        "compact_slots_dense"),
                    9: ("parse_greedy",)}


def _ms_stats(seconds: list) -> dict:
    ms = np.asarray(seconds) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max()), "calls": len(ms),
            "producer_s": float(ms.sum() / 1e3)}


def _stock(oracle, data: bytes, level: int) -> dict:
    """Stock libzstd's one-shot compress at `level` on the same bytes."""
    t0 = time.perf_counter()
    frame = oracle.compress(data, level)
    seconds = time.perf_counter() - t0
    return {"stock_ratio": len(frame) / len(data),
            "stock_mbs": len(data) / seconds / 1e6}


def producer_run(torch, qzt, tk, oracle, what: str, level: int, data: bytes,
                 run) -> dict:
    """Phase 6, one libzstd-driven run: run(data) (compress_via_libzstd or
    compress_stream_via_libzstd on the card) with the launch counts reset
    just before and read just after, each producer call timed by a wrapper
    around the package's sequence_producer (here, not in the package).
    The frame must decode bit-exactly; no producer error; every block of
    64 bytes or more through the device half; the level's kernels
    launched. Returns the launch counts."""
    run(data[:BLOCK + TAIL])  # warm-up
    torch.cuda.synchronize()
    real = qzt.sequence_producer
    calls, states = [], []

    def timed(state, block, window_size=None):
        t0 = time.perf_counter()
        out = real(state, block, window_size)
        calls.append((len(block), time.perf_counter() - t0))
        if state not in states:
            states.append(state)
        return out

    qzt.sequence_producer = timed
    try:
        tk.reset_launches()
        t0 = time.perf_counter()
        frame = run(data)
        seconds = time.perf_counter() - t0
        launches = dict(tk.launches)
    finally:
        qzt.sequence_producer = real
    stats = oracle.last_producer_stats()
    if oracle.decompress(frame, len(data)) != data:
        raise AssertionError(f"{what}: libzstd decode differs from the input")
    (state,) = states
    device_calls = sum(n >= qzt.DEVICE_MIN_BLOCK for n, _ in calls)
    phase("producer", path=what, level=level, input_bytes=len(data),
          frame_bytes=len(frame), ratio=len(frame) / len(data),
          seconds=seconds, e2e_mbs=len(data) / seconds / 1e6,
          **_ms_stats([t for _, t in calls]),
          **_stock(oracle, data, level), libzstd_stats=stats,
          device_blocks=state.device_blocks, host_blocks=state.host_blocks,
          overflow_blocks=state.overflow_blocks, errors=state.errors,
          short_blocks=len(calls) - device_calls, launches=launches)
    if stats["errors"] or state.errors:
        raise AssertionError(f"{what}: producer errors {stats}, "
                             f"{state.last_error!r}")
    if state.device_blocks != device_calls:
        raise AssertionError(f"{what}: {state.device_blocks} device blocks "
                             f"of {device_calls} calls of 64 bytes or more")
    missing = [k for k in PRODUCER_KERNELS[level] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing}")
    return launches


def stream_run(torch, qzt, tk, oracle, data: bytes) -> dict:
    """Phase 6, StreamCompressor(level=1, batch=8) on the card fed `data`
    in FEED_CHUNK pieces, then finish(), the launch counts reset just
    before and read just after: the frame decodes bit-exactly, every full
    block went through the device half, and level 1's kernels launched
    (LDM on: 8 blocks a batch). Returns the launch counts."""
    def feed(x: bytes):
        sc = qzt.StreamCompressor(level=1, batch=8, device="cuda")
        out = [sc.compress(x[s:s + FEED_CHUNK])
               for s in range(0, len(x), FEED_CHUNK)]
        return sc, b"".join(out) + sc.finish()

    feed(data[:8 * BLOCK + TAIL])  # warm-up
    torch.cuda.synchronize()
    tk.reset_launches()
    t0 = time.perf_counter()
    sc, frame = feed(data)
    seconds = time.perf_counter() - t0
    launches = dict(tk.launches)
    if oracle.decompress(frame, len(data)) != data:
        raise AssertionError("StreamCompressor: libzstd decode differs")
    phase("producer", path="StreamCompressor", level=1, batch=8,
          chunk_bytes=FEED_CHUNK, input_bytes=len(data),
          frame_bytes=len(frame), ratio=len(frame) / len(data),
          seconds=seconds, e2e_mbs=len(data) / seconds / 1e6,
          **_stock(oracle, data, 1), device_blocks=sc.codec.device_blocks,
          blocks_emitted=sc.blocks_emitted,
          fallback_blocks=sc.codec.stats.fallback_blocks, launches=launches)
    if sc.codec.device_blocks != len(data) // BLOCK:
        raise AssertionError(f"StreamCompressor: {sc.codec.device_blocks} "
                             f"device blocks of {len(data) // BLOCK}")
    missing = [k for k in LEVEL_KERNELS[1] if launches[k] == 0]
    if missing:
        raise AssertionError(f"StreamCompressor: kernels never launched: "
                             f"{missing}")
    return launches


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_batch(nfull: int, world: int, ldm: int) -> int:
    """compress_mesh's row count B: the full blocks padded to a multiple
    of lcm(world, LDM span) (the JAX package's parallel/pipeline.py:69-77)."""
    unit = math.lcm(world, ldm or 1)
    return max(unit, -(-nfull // unit) * unit)


def mesh_run(torch, tk, pipeline, mesh, level: int, data: bytes) -> tuple:
    """One compress_mesh run on the card after a warm-up on 8 blocks and
    the tail, the launch counts reset just before and read just after:
    (frame, seconds, launches)."""
    pipeline.compress_mesh(data[:8 * BLOCK + TAIL], mesh, level=level,
                           device="cuda")
    torch.cuda.synchronize()
    tk.reset_launches()
    t0 = time.perf_counter()
    frame = pipeline.compress_mesh(data, mesh, level=level, device="cuda")
    seconds = time.perf_counter() - t0
    return frame, seconds, dict(tk.launches)


def mesh_rank(rank: int, world: int, init_method: str, root: str, seed: int,
              mb: int, queue, go) -> None:
    """Phase 7, one gloo rank in a spawned process, driving cuda:0: makes
    the corpora, joins the group, reports ("ready", rank), waits for `go`,
    then runs compress_mesh at each MESH_LEVELS level and reports
    ("done", rank, {level: (frame, seconds, launches)}), or ("error", rank,
    traceback) on a failure."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, root)
    try:
        from qat_zstd_plugin_tpu_torch.corpus import make_corpus
        from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
        from qat_zstd_plugin_tpu_torch.parallel import (distributed, mesh,
                                                         pipeline)
        data = {1: make_corpus((mb << 20) + TAIL, seed)}
        data[4] = data[9] = make_corpus((DENSE_MB << 20) + TAIL, seed)
        torch.cuda.set_device(0)
        distributed.init(init_method, world_size=world, rank=rank,
                         backend="gloo")
        m = mesh.make_mesh()
        queue.put(("ready", rank))
        if not go.wait(MESH_TIMEOUT_S):
            raise TimeoutError("no go from the parent")
        queue.put(("done", rank, {
            level: mesh_run(torch, tk, pipeline, m, level, data[level])
            for level in MESH_LEVELS}))
    except Exception:
        queue.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # The work is done and reported: leave without the interpreter's
    # teardown, where torch's gloo threads can abort a finished process,
    # once the queue has flushed.
    queue.close()
    queue.join_thread()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _mesh_check(oracle, what: str, level: int, frame: bytes, want: bytes,
                data: bytes, launches: dict) -> None:
    """A phase 7 frame equals the reference frame, decodes bit-exactly
    through stock libzstd, and the level's kernels launched."""
    if frame != want:
        raise AssertionError(f"{what} level {level}: the frame differs from "
                             "GpuCodec(batch=B)'s")
    if oracle.decompress(frame, len(data)) != data:
        raise AssertionError(f"{what} level {level}: libzstd decode differs")
    missing = [k for k in LEVEL_KERNELS[level] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what} level {level}: kernels never "
                             f"launched: {missing}")


def mesh_phase(torch, qzt, tk, oracle, root: str, args, corpus: bytes,
               dense_corpus: bytes, card: str, phase4_mbs: dict) -> dict:
    """Phase 7: the reference frames, compress_mesh at level 1 in an NCCL
    world of one here, then at levels 1, 4 and 9 on MESH_RANKS gloo ranks
    sharing the card (spawned first: their start-up overlaps the
    reference frames, and they wait for the go until this process's
    timed run is over). Returns the launch counts of the timed runs, every
    process's."""
    import torch.distributed as dist
    from qat_zstd_plugin_tpu_torch.parallel import mesh, pipeline
    from qat_zstd_plugin_tpu_torch.runtime.levels import TPU_LEVEL_TABLE
    data = {1: corpus, 4: dense_corpus, 9: dense_corpus}
    ctx = multiprocessing.get_context("spawn")
    queue, go = ctx.Queue(), ctx.Event()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=mesh_rank, args=(
        r, MESH_RANKS, init_method, root, args.seed, args.mb, queue, go))
        for r in range(MESH_RANKS)]
    for p in procs:
        p.start()

    def replies(kind: str) -> dict:
        """Each rank's next message, which must be of `kind`; raises if a
        rank dies first or none comes within MESH_TIMEOUT_S."""
        out = {}
        t0 = time.perf_counter()
        while len(out) < MESH_RANKS:
            try:
                msg = queue.get(timeout=5)
            except Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()}
                if dead or time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    raise AssertionError(f"mesh ranks: no {kind!r} "
                                         f"message; dead ranks {dead}")
                continue
            if msg[0] == "error":
                raise AssertionError(f"mesh rank {msg[1]}:\n{msg[2]}")
            if msg[0] != kind:
                raise AssertionError(f"mesh rank message {msg[:2]}")
            out[msg[1]] = msg[2:]
        return out

    launches = dict.fromkeys(KERNELS, 0)
    try:
        want = {}
        for level in MESH_LEVELS:
            nfull = len(data[level]) // BLOCK
            B = {mesh_batch(nfull, w, TPU_LEVEL_TABLE[level].ldm)
                 for w in (1, MESH_RANKS)}
            if len(B) != 1:
                raise AssertionError(f"level {level}: B differs by world "
                                     f"size: {B}")
            (batch,) = B
            want[level] = qzt.GpuCodec(
                level=level, batch=batch, max_seq=MAX_SEQ, device="cuda",
                device_entropy=False).compress(data[level], checksum=True)
            phase("mesh_reference", level=level, batch=batch,
                  input_bytes=len(data[level]),
                  frame_bytes=len(want[level]))
        replies("ready")
        # NCCL in a world of one, made here: distributed.init joins no
        # group for a world of one.
        dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                                f"{_free_port()}", world_size=1, rank=0)
        try:
            runs = [("nccl", 1, 0, 1, *mesh_run(
                torch, tk, pipeline, mesh.make_mesh(), 1, corpus))]
        finally:
            dist.destroy_process_group()
        go.set()
        for rank, (res,) in sorted(replies("done").items()):
            runs += [("gloo", MESH_RANKS, rank, level, *res[level])
                     for level in MESH_LEVELS]
        for backend, world, rank, level, frame, seconds, counts in runs:
            _mesh_check(oracle, f"compress_mesh {backend} world {world} "
                        f"rank {rank}", level, frame, want[level],
                        data[level], counts)
            for k, n in counts.items():
                launches[k] += n
            batch, mbs = phase4_mbs[level]
            phase("mesh", backend=backend, world=world, rank=rank,
                  level=level, input_bytes=len(data[level]),
                  frame_bytes=len(frame), ratio=len(frame) / len(data[level]),
                  seconds=seconds, e2e_mbs=len(data[level]) / seconds / 1e6,
                  equal_reference=True, decoder="libzstd",
                  phase4_batch=batch, phase4_e2e_mbs=mbs,
                  launches={k: n for k, n in counts.items() if n})
        phase("mesh_note", card=card, note=(
            f"{MESH_RANKS} ranks share one card: these runs measure the "
            "orchestration (span split, context spans, ordered gather), "
            "not scaling; NCCL across cards is not exercised on one card"))
    finally:
        go.set()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"mesh ranks exited with {codes}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=64,
                    help="level-1 corpus size in MiB (plus a tail)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "qat_zstd_plugin_tpu_torch")):
        print("chip_smoke: run from the repository root (the port is not "
              "beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import qat_zstd_plugin_tpu_torch as qzt
    from qat_zstd_plugin_tpu_torch import native, oracle
    from qat_zstd_plugin_tpu_torch.corpus import make_corpus
    from qat_zstd_plugin_tpu_torch.ops import _build
    from qat_zstd_plugin_tpu_torch.ops import fse_kernel as fk
    from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
    from qat_zstd_plugin_tpu_torch.ops import literals_kernel as lk
    from qat_zstd_plugin_tpu_torch.ops import match_pipeline as mp
    from qat_zstd_plugin_tpu_torch.ops import parse_kernel as pk
    from qat_zstd_plugin_tpu_torch.ops import sort_kernel as tsk
    from qat_zstd_plugin_tpu_torch.profile_l1 import card_line

    # 1. Card and builds.
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load()
    phase("build", library=os.path.relpath(_build.library_path(), root),
          nvcc_s=_build.build_seconds,
          load_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    native.load()
    phase("native", library=os.path.relpath(native.library_path(), root),
          load_s=time.perf_counter() - t0)
    phase("libzstd", version=oracle.version(),
          sequence_producer=oracle.has_sequence_producer())

    # 2. Kernel vs twin at the main paths' shapes.
    corpus = make_corpus((args.mb << 20) + TAIL, args.seed)
    dense_corpus = make_corpus((DENSE_MB << 20) + TAIL, args.seed)
    blocks_np = np.frombuffer(corpus[:BATCH * BLOCK], np.uint8) \
        .reshape(BATCH, BLOCK).copy()
    dense_np = np.frombuffer(dense_corpus[:DENSE_BATCH * BLOCK], np.uint8) \
        .reshape(DENSE_BATCH, BLOCK).copy()
    halves = ((1, blocks_np, None), (1, blocks_np[:6].copy(), None),
              *((lv, dense_np, None) for lv in DENSE_LEVELS),
              (4, dense_np[:8].copy(), None),
              *((lv, dense_np, None) for lv in CONTENT_LEVELS),
              (5, dense_np[:6].copy(), None),
              *((lv, ragged_block(corpus, n), n) for lv in PRODUCER_LEVELS
                for n in PRODUCER_LENGTHS))
    producer_blocks = [ragged_bytes(corpus, n) for n in PRODUCER_LENGTHS]
    libzstd_frame_data = corpus[:8 * BLOCK + TAIL]
    entropy_halves = [(lv, e) for e in ("hybrid", True)
                      for lv in HYBRID_LEVELS]
    frames = ((1, 8, corpus[:8 * BLOCK + TAIL], False),
              (4, 16, dense_corpus[:16 * BLOCK + TAIL], False),
              (3, 8, dense_corpus[:9 * BLOCK], False),
              (5, 8, dense_corpus[:9 * BLOCK], False),
              (12, 4, dense_corpus[:4 * BLOCK + TAIL], False),
              (1, 8, corpus[:8 * BLOCK + TAIL], "hybrid"),
              (5, 4, dense_corpus[:4 * BLOCK + TAIL], "hybrid"),
              (1, 8, corpus[:8 * BLOCK + TAIL], True),
              (5, 4, dense_corpus[:4 * BLOCK + TAIL], True))
    # The CPU sides of phases 3 and 5 (the twins and the CPU frames) run in
    # two worker processes, in the order they are needed, while the card
    # works through phase 2; both are done before phase 4 times the main
    # paths, so that they take no host time from those.
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"),
        initializer=_worker_init)
    try:
        want_halves = [pool.submit(cpu_device_half, lv, x, length=n)
                       for lv, x, n in halves]
        want_entropy = [pool.submit(cpu_device_half, lv, dense_np, e)
                        for lv, e in entropy_halves]
        want_parsed = [pool.submit(cpu_parsed_slots, dense_np, kw)
                       for kw in PARSED_CASES]
        want_frames = [pool.submit(cpu_frame, *f) for f in frames]
        want_triples = [pool.submit(cpu_triples, lv, producer_blocks)
                        for lv in PRODUCER_LEVELS]
        want_libzstd = pool.submit(cpu_libzstd_frame, 1, libzstd_frame_data)
        kernels = {}
        kernels_vs_twins(torch, tk, blocks_np, args.seed, kernels)
        unsort_kernels_vs_twins(torch, tk, blocks_np, dense_np, args.seed,
                                kernels)
        dense_kernels_vs_twins(torch, tk, dense_np, args.seed, kernels)
        content_kernels_vs_twins(torch, tk, pk, mp, dense_np, args.seed,
                                 kernels)
        hybrid_kernels_vs_twins(torch, tk, fk, dense_np, args.seed, kernels)
        literals_kernels_vs_twins(torch, lk, dense_np, args.seed, kernels)
        parsed_kernels_vs_twins(torch, tk, tsk, dense_np, args.seed, kernels)
        for name in KERNELS:
            phase("kernel_vs_twin", kernel=name, **kernels[name])

        # 3. Device half: composed outputs, kernels vs twins.
        for (level, x, n), want in zip(halves, want_halves):
            phase("device_half", equal=True,
                  **device_half(torch, qzt, level, x, want.result(), n))
        for (level, entropy), want in zip(entropy_halves, want_entropy):
            phase("device_half", equal=True, **hybrid_device_half(
                torch, qzt, level, dense_np, entropy, want.result()))
        # The paths of B17-B19, which no level takes: their launches count.
        launches = dict.fromkeys(KERNELS, 0)
        parsed_paths(torch, tk, mp, tsk, dense_np,
                     [w.result() for w in want_parsed], launches)

        # 4. Main paths on the card, launch counts per path.
        frames_on_cpu = [w.result() for w in want_frames]
        runs = [(1, BATCH, corpus, False)] + [
            (lv, DENSE_BATCH, dense_corpus, False)
            for lv in DENSE_LEVELS + CONTENT_LEVELS] + [
            (lv, DENSE_BATCH, dense_corpus, entropy)
            for entropy in ("hybrid", True) for lv in HYBRID_LEVELS]
        phase4_mbs = {}
        for level, batch, data, entropy in runs:
            counts, mbs = main_path(torch, qzt, tk, oracle, level, batch,
                                    data, entropy)
            for k, n in counts.items():
                launches[k] += n
            if not entropy:
                phase4_mbs[level] = (batch, mbs)
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")

        # 5. Port on card vs port on CPU.
        for f, want in zip(frames, frames_on_cpu):
            card_vs_cpu(qzt, *f, want)
        for level, want in zip(PRODUCER_LEVELS, want_triples):
            producer_card_vs_cpu(qzt, level, producer_blocks, want.result())
        on_card = qzt.compress_via_libzstd(libzstd_frame_data, level=1,
                                           device="cuda")
        if on_card != want_libzstd.result():
            raise AssertionError("compress_via_libzstd: frames differ "
                                 "between device='cuda' and device='cpu'")
        phase("card_vs_cpu", path="compress_via_libzstd", level=1,
              input_bytes=len(libzstd_frame_data), equal=True,
              frame_bytes=len(on_card))

        # 6. The producer and the streams on the card, launch counts per
        # run.
        via = lambda lv: lambda x: qzt.compress_via_libzstd(  # noqa: E731
            x, level=lv, device="cuda")
        stream = lambda x: qzt.compress_stream_via_libzstd(  # noqa: E731
            x, level=1, device="cuda", chunk_size=STREAM_CHUNK,
            flush_every=STREAM_FLUSH)
        runs = [("compress_via_libzstd", 1, corpus, via(1)),
                *(("compress_via_libzstd", lv, dense_corpus, via(lv))
                  for lv in PRODUCER_LEVELS[1:]),
                ("compress_stream_via_libzstd", 1,
                 corpus[:STREAM_MB << 20], stream)]
        for what, level, data, run in runs:
            for k, n in producer_run(torch, qzt, tk, oracle, what, level,
                                     data, run).items():
                launches[k] += n
        for k, n in stream_run(torch, qzt, tk, oracle, corpus).items():
            launches[k] += n
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # 7. Scale-out: compress_mesh in an NCCL world of one and on two gloo
    # ranks sharing the card.
    for k, n in mesh_phase(torch, qzt, tk, oracle, root, args, corpus,
                           dense_corpus, card, phase4_mbs).items():
        launches[k] += n

    ref = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "qat_zstd_plugin_tpu")]
    if ref:
        raise AssertionError(f"the port imported {sorted(ref)[:5]}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         **kernels[name]} for name in KERNELS]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
