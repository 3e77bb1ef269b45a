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
with two gloo ranks sharing the card, runs the tools (the benchmark in
its four modes, with threads and processes, the CLI and the profiler
trace) on the card, holds the port to its robustness surface there
(adversarial inputs at every level against the CPU twins, wrong device
claims, validate, one codec shared by threads, a first build by two
processes), checks every frame with stock libzstd, reads the card's
frames of every kind with the port's own decoder (decoder.py), mutated
ones against libzstd, and the producer's triples as LZ4s, and drives the
rest of the package on the card (B10's segmented parse, the packed hash
contract, the batch, staged and sharded pipelines, bitpack, entry.py).

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
     the B=64 batch, on crafted rows (designs/parse.py crafted_lengths)
     and on rows of every length 4, 5 and 7 (chains that never meet),
     lazy on and off, each case also back to back (stream_ms, as B11,
     B12, B17 and B18) beside its design's floor (floor_ms), and the same in
     its segmented mode at psegs 2, 4 and 8 (each candidate cut at its
     segment's end; the crafted rows' matches cross every segment end);
     B11 and B13
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
     scaling: NCCL across cards is not exercised on one card;
  8. tools on the card: the 32 MiB corpus plus the tail written to a
     temporary file, the tools run in this process (tools.benchmark.run,
     tools.cli.run), the launch counts reset just before and read just
     after each run: the benchmark (reference test/benchmark.c) in mode
     1 at level 1 with 1 MiB chunks and batch 8 on one thread and on two
     (two GpuCodecs from two host threads on the card), at level 4 with
     2 MiB chunks and batch 16 (one whole LDM span), at level 1 with
     the tool's default 128 KiB chunks (one block a chunk), in modes 0
     (SoftwareCodec) and 2 (stock libzstd) at level 1, where no kernel
     may launch, and in mode 3 (libzstd with the port's producer) at
     level 1 on the first 8 MiB in 1 MiB chunks and on the whole file in
     128 KiB chunks; then -P 2 in mode 1 at level 1 on the first 16 MiB
     (two child processes sharing the card, their launches their own);
     each run must return 0 with every thread and process PASS, and
     prints its aggregate MB/s, ratio, avg and P50/P99 chunk latency (a
     percentile in the histogram's top bucket, 16469 us, is named as
     such, not printed: a 1 MiB device chunk outlasts it) and decompress
     MB/s. The CLI's roundtrip at level 9 (B9, B10) and at
     level 1 with full device entropy (B11-B16), and its compress at
     level 1, whose file must equal GpuCodec(level=1).compress(data);
     each run's kernels must have launched. Last, utils.profiling.trace
     around compress(8 MiB, level=1, batch=64, device="cuda"), around
     compress_via_libzstd(8 MiB, level=1, device="cuda") and around
     phase 4's L1 cell, compress(--mb corpus, level=1, batch=128), each
     after a warm-up of the same call: the traces must name K1-K4's CUDA
     functions (K1, K2 and K4 for the producer, batch 1: no LDM), and the
     kernels' count, summed time, the traced window and the union of
     their intervals as a share of it (the card's busy share of the
     call) are printed;
  9. robustness on the card: tests/test_fuzz.py's eight adversarial
     shapes (utils.corpora.adversarial) at 0, 1, 63, 64, 65, 16383,
     16384, 131071, 131072, 131073 and 1 MiB + 5 bytes through
     GpuCodec(device="cuda") at levels 1-12 with host entropy and at
     levels 1, 4 and 9 with hybrid and full device entropy, at blocks of
     16384 (batch 2) and 131072 (batch 8): every frame equals the same
     codec's on device="cpu" (computed in spawned workers meanwhile),
     decodes bit-exactly through stock libzstd, and no block falls back
     to the CPU; wrong device claims (a third of the offsets replaced,
     another third's lengths plus 7) at levels 1 and 9 still decode
     exactly and compress(validate=True) refuses them, and on clean
     input compress(validate=True) equals compress(); two processes
     build csrc/ at once into an empty build root and exactly one runs
     nvcc; one GpuCodec(level=1, batch=8) from 8 threads x 3 rounds on
     the current stream and again with a torch.cuda.Stream a thread:
     every frame equals the one-thread frame, stats.input_bytes and
     device_blocks balance and each kernel's launches are exactly 24
     times one call's, with the 8 threads' aggregate MB/s beside one
     thread's; distinct codecs at levels 1, 2, 3, 5 and 9 from 8
     threads and compress_via_libzstd from 4, each frame equal to its
     one-thread frame; runtime/device.py's start and stop hammered from
     8 threads. Every kernel a level reaches (all but B17-B19) must
     launch in this phase;
 10. the format contract on the card: (a) on 1 MiB + 5000 bytes of the
     corpus the card writes compress(level=L, batch=8, device="cuda") at
     L = 1, 2, 3, 4, 5, 9, 12 with host entropy and at L = 1, 4, 9 with
     hybrid and full device entropy, compress_via_libzstd at L = 1, 4, 9,
     compress_stream_via_libzstd(level=1) (100000-byte chunks, a flush
     every 2) and StreamCompressor(level=1, batch=8), and phase 9's eight
     adversarial shapes at 131073 bytes at L1 and at L9 full; each frame
     decodes to its input through stock libzstd and through the port's
     decoder (decoder.py), which runs in four spawned workers while the
     card writes the next frames; one line a kind with the frame bytes
     and the decoder's seconds and MB/s, the host's, beside the card's
     name and power limit; (b) each device-entropy kind again on one
     64 KiB block + 5 bytes, written without a checksum so that a
     mutation that still decodes reaches the byte comparison, 64 seeded
     mutations of its frame (tools.fuzz_decoder.mutate), on each of which
     the port's decoder and libzstd agree: the same bytes, or both
     reject, or the port rejects for one of the ways it is stricter
     (STRICTER_REJECTS); at least one mutation a kind decodes in both;
     (c) LZ4s with the card
     as the engine: SeqProdState(L, block_size=65536, device="cuda") at
     L = 1, 4, 9 on 16 slices of 64 KiB, each slice's triples written as
     LZ4s (lz4s_format.encode) read back exactly by lz4s_format.decode and
     native.dec_lz4s and valid for the slice (format.validate_sequences).
     The launch counts are reset just before and read just after each
     card call; every kernel a level reaches must launch in this phase;
 11. the rest of the package on the card, at B=64 blocks of 128 KiB of
     the 32 MiB corpus unless named, each call against the same call on
     the CPU twins (computed in three spawned workers meanwhile), equal
     in every field, with its ms a batch and its launch counts (reset
     just before, read just after; every kernel a path reaches must
     launch): find_matches_positions on level 1's table with the parse
     (dense=False, sync=False) at psegs 4, greedy and lazy (B5, K2, B7,
     B9, K3, B10, B17), and GpuCodec(level=1, batch=64) with that table
     on the 32 MiB corpus plus the tail (decoded by libzstd) and at batch
     8 on 8 blocks + the tail (equal to device="cpu"); the packed hash
     contract, find_matches_packed(matcher="hash") and
     find_matches_hash_split at widths (5, 8), window 32768 (B5, K2, B7,
     B10, B18); find_matches_staged, greedy and lazy (B10);
     parallel.mesh.sharded_pipeline and compression_step in an NCCL world
     of one here and on two gloo ranks sharing the card (each rank's rows
     and every block's stats, gathered in block order); bitpack on the
     items of level 9's sequence sections (B14's state bits and the
     extras), also equal to bitconcat's words where a row fits; entry()'s
     fn (K1-K4); entry.dryrun_multichip(2, device="cuda").

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a result
when there is no CUDA device or the port is not beside this script.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import multiprocessing
import os
import socket
import sys
import threading
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
PARSE_SEGMENTS = (2, 4, 8)  # B10's segmented mode in phase 2
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
# Phase 8: the tools on the DENSE_MB corpus: 1 MiB chunks (8 blocks, one
# batch of 8); level 4 at 2 MiB chunks and batch 16, one whole LDM span
# (at batch 8 level 4 runs without LDM, so without B6 and K3); modes 1
# and 3 again at the tool's default 128 KiB chunks (one block, as the
# producer route times it), whose latency fits the histogram (a 1 MiB
# device chunk outlasts its top bucket); -m 3 on the first TOOLS_MB3
# MiB, -P on the first TOOLS_MBP; the traces around one compress of
# TRACE_MB MiB at batch TRACE_BATCH and around phase 4's L1 cell.
TOOLS_CHUNK_KB, TOOLS_BATCH, TOOLS_BLOCK_KB = 1024, 8, 128
TOOLS_MB3, TOOLS_MBP, TOOLS_PROCESSES = 8, 16, 2
TRACE_MB, TRACE_BATCH = 8, 64
# Phase 9: tests/test_fuzz.py's eight shapes (utils.corpora.adversarial)
# at these sizes through every level with host entropy and levels 1, 4
# and 9 with hybrid and full device entropy, at blocks of 16384 (batch 2)
# and 131072 (batch 8); wrong claims and validate at levels 1 and 9;
# threads on one card (THREAD_MB MiB + TAIL a thread, the producer's and
# the distinct codecs' threads 1 MiB + TAIL).
FUZZ_SMALL = (0, 1, 63, 64, 65, 16383, 16384)
FUZZ_LARGE = (131071, 131072, 131073, (1 << 20) + 5)
FUZZ_CODECS = tuple((lv, False) for lv in range(1, 13)) + tuple(
    (lv, e) for e in ("hybrid", True) for lv in (1, 4, 9))
FUZZ_BLOCKS = ((16384, 2), (BLOCK, 8))
FUZZ_WORKERS = 3
VALIDATE_LEVELS = (1, 9)
THREADS, ROUNDS, THREAD_MB = 8, 3, 2
DISTINCT_LEVELS = (1, 2, 3, 5, 9)
PRODUCER_THREADS = 4
# Phase 10: the frames the card writes on ragged_bytes(corpus,
# FORMAT_BYTES), decoded by the port's own decoder in FORMAT_WORKERS
# spawned workers while the card writes the next; the device-entropy
# kinds again on DIFF_BYTES (one 64 KiB block, device="cuda") with
# DIFF_MUTATIONS seeded mutations each; LZ4S_SLICES slices of LZ4S_BLOCK
# bytes through the producer at LZ4S_LEVELS, written as LZ4s.
FORMAT_BYTES = (1 << 20) + 5000
FORMAT_LEVELS = (1, 2, 3, 4, 5, 9, 12)
FORMAT_ENTROPY_LEVELS = (1, 4, 9)
FORMAT_FUZZ_BYTES = 131073
FORMAT_WORKERS = 4
DIFF_BLOCK = 65536
DIFF_BYTES = DIFF_BLOCK + 5
DIFF_MUTATIONS = 64
# The port's decoder (a copy of the JAX package's golden/decoder.py) is
# stricter than stock libzstd 1.5.x in these ways, and phase 10 (b)
# tolerates a port reject of what stock decodes only for them: it holds
# each Huffman stream to exact consumption (stock's fast 4-stream loop
# checks only the output length) and every offset to the declared window
# (stock checks only its buffer).
STRICTER_REJECTS = ("huffman stream underflow",
                    "huffman stream not fully consumed",
                    "offset exceeds declared window")
LZ4S_BLOCK = 65536  # LZ4s offsets are 16 bits, as on the QAT engine
LZ4S_SLICES = 16
LZ4S_LEVELS = (1, 4, 9)
# Phase 11: the rest of the package at B=64 x 128 KiB of the DENSE_MB
# corpus: the parsed L1 path at psegs 4 (level 1's table with the parse,
# dense=False, sync=False), greedy and lazy; the packed hash contract at
# widths (5, 8) in four segments a block; the content pipeline's staged
# form, greedy and lazy (and through it sharded_pipeline and
# compression_step); CPU twins in REST_WORKERS spawned workers.
REST_WORKERS = 3
PSEGS_TABLES = tuple(dict(dense=False, sync=False, lazy=lazy, psegs=4)
                     for lazy in (False, True))
PSEGS_CASES = tuple(dict(widths=(6,), window=WINDOW, ldm=4,
                         ldm_max_off=1 << 19, dense=False, sync=False,
                         lazy=lazy, psegs=4) for lazy in (False, True))
HASH_PACKED = dict(widths=(5, 8), neighbors=1, window=WINDOW,
                   max_seq=MAX_SEQ)
REST_BATCH_KW = dict(neighbors=4, max_seq=MAX_SEQ)
SEQ_WORDS = 8192  # match_pipeline.SEQ_WORDS: a block's section stream
# The CUDA functions of K1-K4 (csrc/l1_kernels.cu), as a trace names them.
L1_FUNCTIONS = ("hash_keys_winmin_sync_kernel", "neighbor_unsort_keys_kernel",
                "ldm_keys_kernel", "compact_slots_sync_kernel")
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
# Phase 11's paths: the parsed L1 path (psegs 4) and GpuCodec with its
# table, and the packed hash contract.
PSEGS_KERNELS = ("hash_keys", "neighbor_unsort_keys", "finalize_candidates",
                 "ldm_winmin", "ldm_keys", "parse_greedy", "compact_slots")
HASH_PACKED_KERNELS = ("hash_keys", "neighbor_unsort_keys",
                       "finalize_candidates", "parse_greedy",
                       "compact_operands")
# Phase 9's: every kernel a level reaches; B17-B19 stay on phase 3's paths.
ROBUST_KERNELS = tuple(k for k in KERNELS if k not in (
    "compact_slots", "compact_operands", "bitonic_sort"))


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


def content_kernels_vs_twins(torch, tk, pk, blocks_np: np.ndarray,
                             seed: int, results: dict) -> None:
    """Phase 2, the level 5-12 kernels against their twins on the card, at
    B=64 × 128 KiB."""
    from qat_zstd_plugin_tpu_torch.designs.parse import (parse_inputs,
                                                         visited)
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

    # B10 on the L5 and L12 parse inputs of the batch, on crafted rows and
    # on rows where chains from different starts never meet (every length
    # 4, 5 or 7: the design's worst case). Its bound: each visited
    # position's length read and each output byte written; its design's
    # floor (floor_ms): every length read.
    inputs = parse_inputs(torch, corpus, rng)
    floor = lambda mlen: 5 * mlen.numel() / HBM_BYTES_PER_S * 1e3
    for what, mlen in inputs.items():
        for lazy in (False, True):
            chosen = pk.parse_greedy(mlen, lazy)
            err = exact(torch, chosen, pk.parse_greedy_twin(mlen, lazy),
                        f"parse_greedy {what} lazy={lazy}")
            run = lambda: pk.parse_greedy(mlen, lazy)
            case("parse_greedy", f"{what}, lazy={lazy}", err,
                 4 * visited(torch, chosen, mlen) + nbytes(chosen), run,
                 lambda: pk.parse_greedy_twin(mlen, lazy),
                 main=(what, lazy) == ("L5 candidates", True),
                 floor_ms=floor(mlen), stream_ms=stream_ms(torch, run))
    # B10's segmented mode (trunc: psegs rows a block, each candidate cut
    # at its segment's end) on the same rows; the crafted ones cross every
    # segment end (their matches cross each 4096-position edge). Its bytes
    # are psegs 1's: each visited position's length read once.
    for what, mlen in inputs.items():
        for psegs in PARSE_SEGMENTS:
            for lazy in (False, True):
                chosen = pk.parse_greedy(mlen, lazy, psegs)
                err = exact(torch, chosen,
                            pk.parse_greedy_twin(mlen, lazy, psegs),
                            f"parse_greedy {what} lazy={lazy} psegs={psegs}")
                run = lambda: pk.parse_greedy(mlen, lazy, psegs)
                case("parse_greedy", f"{what}, lazy={lazy}, psegs={psegs}",
                     err, 4 * visited(torch, chosen, mlen, psegs)
                     + nbytes(chosen), run,
                     lambda: pk.parse_greedy_twin(mlen, lazy, psegs),
                     psegs=psegs, floor_ms=floor(mlen),
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


def spawn_ranks(target, world: int, *args) -> tuple:
    """Phase 7's and phase 11's gloo ranks: `world` spawned processes
    running target(rank, world, init_method, *args, queue, go) around a
    tcp://127.0.0.1 store. Returns (procs, queue, go)."""
    ctx = multiprocessing.get_context("spawn")
    queue, go = ctx.Queue(), ctx.Event()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=target, args=(r, world, init_method, *args,
                                              queue, go))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, queue, go


def rank_replies(queue, procs: list, kind: str) -> dict:
    """Each rank's next message, which must be of `kind`; raises if a rank
    dies first or none comes within MESH_TIMEOUT_S."""
    out = {}
    t0 = time.perf_counter()
    while len(out) < len(procs):
        try:
            msg = queue.get(timeout=5)
        except Empty:
            dead = {r: p.exitcode for r, p in enumerate(procs)
                    if r not in out and not p.is_alive()}
            if dead or time.perf_counter() - t0 > MESH_TIMEOUT_S:
                raise AssertionError(f"ranks: no {kind!r} message; dead "
                                     f"ranks {dead}")
            continue
        if msg[0] == "error":
            raise AssertionError(f"rank {msg[1]}:\n{msg[2]}")
        if msg[0] != kind:
            raise AssertionError(f"rank message {msg[:2]}")
        out[msg[1]] = msg[2:]
    return out


def join_ranks(procs: list, go) -> list:
    """Let the ranks go and wait for them; returns their exit codes."""
    go.set()
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.terminate()
            p.join()
    return [p.exitcode for p in procs]


def mesh_phase(torch, qzt, tk, oracle, root: str, args, corpus: bytes,
               dense_corpus: bytes, card: str, phase4_mbs: dict) -> dict:
    """Phase 7: the reference frames, compress_mesh at level 1 in an NCCL
    world of one here, then at levels 1, 4 and 9 on MESH_RANKS gloo ranks
    sharing the card (spawned first: their start-up overlaps the
    reference frames, and they wait for the go until this process's
    timed run is over). Returns the launch counts of the timed runs, every
    process's."""
    import torch.distributed as dist
    from qat_zstd_plugin_tpu_torch.entry import mesh_batch
    from qat_zstd_plugin_tpu_torch.parallel import mesh, pipeline
    from qat_zstd_plugin_tpu_torch.runtime.levels import TPU_LEVEL_TABLE
    data = {1: corpus, 4: dense_corpus, 9: dense_corpus}
    procs, queue, go = spawn_ranks(mesh_rank, MESH_RANKS, root, args.seed,
                                   args.mb)

    def replies(kind: str) -> dict:
        return rank_replies(queue, procs, kind)

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
        codes = join_ranks(procs, go)
    if any(codes):
        raise AssertionError(f"mesh ranks exited with {codes}")
    return launches


def _tool_run(tk, tool, argv: list, launches: dict, wants=(),
              none=False) -> tuple[str, float, dict]:
    """Phase 8, one in-process tool run (tool.run(argv)) with the launch
    counts reset just before and read just after, added to `launches`;
    its standard output captured. Raises unless it returns 0 and each of
    `wants` launched (no kernel at all with `none`). Returns (output,
    seconds, the run's launch counts)."""
    out = io.StringIO()
    tk.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = tool.run(argv)
    seconds = time.perf_counter() - t0
    counts = dict(tk.launches)
    text = out.getvalue()
    what = " ".join([tool.__name__.split(".")[-1]] + argv[1:])
    if rc != 0:
        raise AssertionError(f"{what}: returned {rc}:\n{text}")
    missing = [k for k in wants if counts[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing}")
    if none and any(counts.values()):
        raise AssertionError(f"{what}: launched kernels {counts}")
    for k, n in counts.items():
        launches[k] += n
    return text, seconds, counts


def _bench_line(text: str, what: str) -> dict:
    """A benchmark run's --json line, checked: ok, every thread PASS."""
    threads = [ln for ln in text.splitlines() if ln.startswith("thread ")]
    got = json.loads([ln for ln in text.splitlines()
                      if ln.startswith("{")][-1])
    if not got["ok"] or not threads or not all(
            ln.rstrip().endswith("PASS") for ln in threads):
        raise AssertionError(f"{what}: not every thread passed:\n{text}")
    return got


def _chunk_latency(got: dict, top: float) -> dict:
    """A benchmark line's chunk latency: avg, and P50 and P99 where they
    lie below the histogram's top bucket (`top` us); a percentile in
    the top bucket only says "at least `top`", so it is named in
    at_top_bucket instead of printed."""
    lat = got["latency_us"]
    fields = {"avg_us": lat["avg"], "top_bucket_us": top,
              "at_top_bucket": [k for k in ("P50", "P99")
                                if lat[k] >= top]}
    for k in ("P50", "P99"):
        fields[f"{k.lower()}_us"] = lat[k] if lat[k] < top else None
    return fields


def _busy(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _spans(events: list) -> list:
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events]


def trace_run(torch, tk, oracle, trace_dir: str, what: str, run,
              data: bytes, wants: tuple, functions: tuple,
              launches: dict) -> None:
    """Phase 8, utils.profiling.trace around one run(data) on the card
    after a warm-up of the same call, the launch counts reset just before
    and read just after (added to `launches`): each of `wants` must have
    launched and the trace must name each of `functions` (CUDA function
    names); prints the kernels' count, their summed duration, the traced
    window (first event's start to last event's end) and the union of
    the kernels' intervals (and of the kernels' and copies') as a share
    of it: the card's busy share of the call."""
    from qat_zstd_plugin_tpu_torch.utils import profiling
    run(data)
    torch.cuda.synchronize()
    tk.reset_launches()
    with profiling.trace(trace_dir, device="cuda") as path:
        t0 = time.perf_counter()
        frame = run(data)
        seconds = time.perf_counter() - t0
    counts = dict(tk.launches)
    for k, n in counts.items():
        launches[k] += n
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    spans = _spans(events)
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    missing = [k for k in functions
               if not any(k in e["name"] for e in kernels)]
    if missing or any(counts[k] == 0 for k in wants):
        raise AssertionError(f"trace {what}: {missing} missing from the "
                             f"trace, or not launched ({counts})")
    if oracle.decompress(frame, len(data)) != data:
        raise AssertionError(f"trace {what}: libzstd decode differs")
    phase("tool", tool="profiling.trace", path=what, input_bytes=len(data),
          frame_bytes=len(frame), ratio=len(frame) / len(data),
          seconds=seconds, e2e_mbs=len(data) / seconds / 1e6,
          trace_bytes=os.path.getsize(path), kernels=len(kernels),
          kernel_us=sum(float(e["dur"]) for e in kernels),
          window_us=window,
          kernel_busy_share=_busy(_spans(kernels)) / window,
          busy_share=_busy(_spans(kernels + copies)) / window,
          functions={k: sum(k in e["name"] for e in kernels)
                     for k in functions},
          launches={k: n for k, n in counts.items() if n})


def tools_phase(torch, qzt, tk, oracle, data: bytes, cell: bytes,
                card: str) -> dict:
    """Phase 8: the port's tools on the card, on `data` (the DENSE_MB
    corpus plus the tail) written to a temporary file, in this process
    but for -P: the benchmark in modes 1 (levels 1 and 4, one and two
    threads, 1 MiB chunks; level 1 at 128 KiB chunks), 0, 2 and 3 (1 MiB
    and 128 KiB chunks), -P 2 in mode 1, the CLI's roundtrip at level 9
    and at level 1 with full device entropy and its compress at level 1
    (the file equal to GpuCodec(level=1)'s), then the trace around a
    level-1 compress of TRACE_MB MiB, around compress_via_libzstd and
    around phase 4's L1 cell (`cell`, at batch BATCH). Every run
    must return 0 with every thread and process PASS; each run's kernels
    must have launched (none in modes 0 and 2). Returns the launch counts
    of the in-process runs."""
    import tempfile
    from qat_zstd_plugin_tpu_torch.tools import benchmark, cli
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for mb, part in ((None, data), (TOOLS_MB3, data[:TOOLS_MB3 << 20]),
                         (TOOLS_MBP, data[:TOOLS_MBP << 20])):
            paths[mb] = os.path.join(tmp, f"corpus.{mb}.bin")
            with open(paths[mb], "wb") as f:
                f.write(part)
        chunk = ["-c", str(TOOLS_CHUNK_KB), "--batch", str(TOOLS_BATCH)]
        block = ["-c", str(TOOLS_BLOCK_KB), "--batch", str(TOOLS_BATCH)]
        top = benchmark.Histogram().edges[-1]
        bench_runs = (  # mode, level, threads, input, flags, kernels
            (1, 1, 1, None, chunk, LEVEL_KERNELS[1]),
            (1, 1, 2, None, chunk, LEVEL_KERNELS[1]),
            (1, 4, 1, None, ["-c", str(2 * TOOLS_CHUNK_KB), "--batch",
                             str(2 * TOOLS_BATCH)], LEVEL_KERNELS[4]),
            (1, 1, 1, None, block, PRODUCER_KERNELS[1]),
            (0, 1, 1, None, chunk, ()),
            (2, 1, 1, None, chunk, ()),
            (3, 1, 1, TOOLS_MB3, chunk, PRODUCER_KERNELS[1]),
            (3, 1, 1, None, block, PRODUCER_KERNELS[1]))
        for mode, level, threads, mb, flags, wants in bench_runs:
            argv = [paths[mb], "-m", str(mode), "-l", str(level), "-t",
                    str(threads), *flags, "--json"]
            text, seconds, counts = _tool_run(tk, benchmark, argv, launches,
                                              wants, none=not wants)
            got = _bench_line(text, " ".join(argv[1:]))
            phase("tool", tool="benchmark", argv=argv[1:],
                  input_bytes=os.path.getsize(paths[mb]), seconds=seconds,
                  aggregate_mbs=got["aggregate_mbs"], ratio=got["ratio"],
                  **_chunk_latency(got, top), decomp_mbs=got["decomp_mbs"], threads=got["threads"],
                  block_stats=got["block_stats"],
                  launches={k: n for k, n in counts.items() if n})
        # -P: each child process drives the card and counts its own
        # launches; the parent sums the children's MB/s.
        argv = [paths[TOOLS_MBP], "-P", str(TOOLS_PROCESSES), "-m", "1",
                "-l", "1", *chunk]
        text, seconds, _ = _tool_run(tk, benchmark, argv, launches,
                                     none=True)
        procs = [ln for ln in text.splitlines() if ln.startswith("process ")]
        if len(procs) != TOOLS_PROCESSES or not all(
                ln.endswith("PASS") for ln in procs):
            raise AssertionError(f"benchmark -P: not every process "
                                 f"passed:\n{text}")
        agg = [ln for ln in text.splitlines()
               if ln.startswith("aggregate compress:")][-1]
        phase("tool", tool="benchmark", argv=argv[1:],
              input_bytes=os.path.getsize(paths[TOOLS_MBP]),
              seconds=seconds, aggregate_mbs=float(agg.split()[2]),
              processes=[float(ln.split()[2]) for ln in procs],
              note="ratio and latency stay in the children (the tool "
                   "prints their MB/s only); launches in the children")
        cli_runs = (  # argv, kernels
            (["roundtrip", paths[None], "-l", "9"], LEVEL_KERNELS[9]),
            (["roundtrip", paths[None], "-l", "1", "--device-entropy",
              "full"], FULL_KERNELS[1]),
            (["compress", paths[None], "-l", "1", "-o",
              os.path.join(tmp, "cli.zst")], LEVEL_KERNELS[1]))
        for argv, wants in cli_runs:
            text, seconds, counts = _tool_run(tk, cli, argv, launches,
                                              wants)
            fields = {}
            if argv[0] == "roundtrip":
                if "round-trip: PASS" not in text:
                    raise AssertionError(f"cli {argv}: {text}")
                frame_bytes = int([ln for ln in text.splitlines() if
                                   ln.startswith("compressed size:")][0]
                                  .split()[2])
            else:
                with open(argv[-1], "rb") as f:
                    frame = f.read()
                want = qzt.GpuCodec(level=1, device="cuda").compress(data)
                if frame != want:
                    raise AssertionError("cli compress: the file differs "
                                         "from GpuCodec(level=1)'s frame")
                if oracle.decompress(frame, len(data)) != data:
                    raise AssertionError("cli compress: libzstd decode "
                                         "differs")
                frame_bytes = len(frame)
                fields["equal_gpu_codec"] = True
            phase("tool", tool="cli", argv=argv[:1] + argv[2:],
                  input_bytes=len(data), frame_bytes=frame_bytes,
                  ratio=frame_bytes / len(data), seconds=seconds,
                  call_mbs=len(data) / seconds / 1e6, **fields,
                  launches={k: n for k, n in counts.items() if n})
        traced = (  # what, run, input, kernels, their CUDA functions
            (f"compress(level=1, batch={TRACE_BATCH})",
             lambda x: qzt.compress(x, level=1, batch=TRACE_BATCH,
                                    device="cuda"),
             data[:TRACE_MB << 20], LEVEL_KERNELS[1], L1_FUNCTIONS),
            ("compress_via_libzstd(level=1)",
             lambda x: qzt.compress_via_libzstd(x, level=1, device="cuda"),
             data[:TRACE_MB << 20], PRODUCER_KERNELS[1],
             L1_FUNCTIONS[:2] + L1_FUNCTIONS[3:]),
            (f"compress(level=1, batch={BATCH}), phase 4's L1 cell",
             lambda x: qzt.compress(x, level=1, batch=BATCH, device="cuda"),
             cell, LEVEL_KERNELS[1], L1_FUNCTIONS))
        for what, run, x, wants, functions in traced:
            trace_run(torch, tk, oracle, os.path.join(tmp, "trace"), what,
                      run, x, wants, functions, launches)
    phase("tools_note", card=card, note=(
        "in-process tool runs; benchmark MB/s by the tool's own host clock "
        f"(its timed loop); a chunk latency percentile in the top bucket "
        f"(the reference's 200 x1.05 buckets end at {top:.2f} us) says "
        "only that the chunk took at least that long: it is named in "
        "at_top_bucket and printed as null, avg_us is exact; cli call_mbs "
        "over the whole call (read, compress, decode or write)"))
    return launches


# ---------------------------------------------------------------------------
# Phase 9: robustness on the card
# ---------------------------------------------------------------------------

def _fuzz_worker_init() -> None:
    """Each phase 9 CPU worker takes two of the host's cores."""
    import torch
    torch.set_num_threads(2)


def fuzz_cases(seed: int) -> list:
    """Phase 9's fuzz inputs: (level, device_entropy, block, batch, kind,
    data). Each FUZZ_CODECS codec at each FUZZ_BLOCKS block size takes a
    short input (FUZZ_SMALL, no full block at 131072) and two long ones
    (FUZZ_LARGE; at 131072 ones with a full block), the eight shapes of
    utils.corpora.adversarial in turn."""
    from qat_zstd_plugin_tpu_torch.utils.corpora import adversarial
    cases = []
    c = 0
    for block, batch in FUZZ_BLOCKS:
        large = FUZZ_LARGE[:3] if block < BLOCK else FUZZ_LARGE[1:]
        for level, entropy in FUZZ_CODECS:
            for j, n in enumerate((FUZZ_SMALL[c % len(FUZZ_SMALL)],
                                   large[c % len(large)],
                                   large[(c + 1) % len(large)])):
                kind = (3 * c + j + c // 4) % 8
                rng = np.random.default_rng((seed, c, j))
                cases.append((level, entropy, block, batch, kind,
                              adversarial(rng, (n,), kind)))
            c += 1
    return cases


def cpu_fuzz_frame(level: int, entropy, block: int, batch: int,
                   data: bytes) -> bytes:
    """The CPU side of a phase 9 fuzz case, in a worker process."""
    import qat_zstd_plugin_tpu_torch as qzt
    return qzt.GpuCodec(level=level, batch=batch, block_size=block,
                        device="cpu", device_entropy=entropy).compress(data)


def fuzz_on_card(torch, qzt, tk, oracle, cases: list, launches: dict
                 ) -> list:
    """Phase 9 (a), the card's side: each case's frame from
    GpuCodec(device="cuda"), one codec per configuration, the launch
    counts reset just before and read just after each call (added to
    `launches`). Every frame decodes bit-exactly through stock libzstd,
    every full block went through the device half, and none fell back to
    the CPU. Returns the frames."""
    from qat_zstd_plugin_tpu_torch.utils.corpora import FUZZ_KINDS
    codecs, frames = {}, []
    for level, entropy, block, batch, kind, data in cases:
        key = (level, entropy, block, batch)
        if key not in codecs:
            codecs[key] = qzt.GpuCodec(level=level, batch=batch,
                                       block_size=block, device="cuda",
                                       device_entropy=entropy)
        codec = codecs[key]
        before = codec.device_blocks
        tk.reset_launches()
        frame = codec.compress(data)
        for k, n in tk.launches.items():
            launches[k] += n
        what = (f"fuzz L{level} {entropy} block {block} "
                f"{FUZZ_KINDS[kind]} {len(data)} bytes")
        if oracle.decompress(frame, len(data)) != data:
            raise AssertionError(f"{what}: libzstd decode differs")
        if codec.device_blocks - before != len(data) // block:
            raise AssertionError(f"{what}: {codec.device_blocks - before} "
                                 "device blocks")
        if codec.stats.fallback_blocks:
            raise AssertionError(f"{what}: a block fell back to the CPU")
        frames.append(frame)
    return frames


def corrupting(collect):
    """collect_batch with wrong device claims, as tests/test_verify_mode.py
    makes them: a third of each block's offsets replaced, another third's
    lengths plus 7."""
    from qat_zstd_plugin_tpu_torch.format import BlockSequences

    def run(handle):
        rng = np.random.default_rng(0)
        out = []
        for seqs, sec in collect(handle):
            if seqs is None or seqs.nseq == 0:
                out.append((seqs, sec))
                continue
            off = seqs.offsets.copy()
            ml = seqs.match_lengths.copy()
            k = len(off)
            idx = rng.permutation(k)
            off[idx[:k // 3]] = rng.integers(1, 30000, k // 3) \
                .astype(off.dtype)
            ml[idx[k // 3:2 * k // 3]] += 7
            out.append((BlockSequences(seqs.lit_lengths, off, ml,
                                       seqs.last_literals), sec))
        return out
    return run


def wrong_claims(torch, qzt, tk, oracle, data: bytes, launches: dict
                 ) -> None:
    """Phase 9 (b): wrong device claims at levels 1 and 9 on the card must
    still give frames that decode exactly, and compress(validate=True)
    must refuse them (lengths plus 7 overrun the block, which the
    extension pass leaves to the entropy coder's raw fallback); then
    compress(validate=True) on the card equals compress() and decodes.
    Launch counts added to `launches`."""
    for level in VALIDATE_LEVELS:
        tk.reset_launches()
        t0 = time.perf_counter()
        codec = qzt.GpuCodec(level=level, batch=2, device="cuda")
        codec.collect_batch = corrupting(codec.collect_batch)
        frame = codec.compress(data)
        if oracle.decompress(frame, len(data)) != data:
            raise AssertionError(f"wrong claims L{level}: libzstd decode "
                                 "differs")
        try:
            codec.compress(data, validate=True)
        except AssertionError:
            pass
        else:
            raise AssertionError(f"wrong claims L{level}: validate=True "
                                 "passed them")
        clean = qzt.GpuCodec(level=level, batch=8, device="cuda")
        checked = clean.compress(data, validate=True)
        if checked != clean.compress(data):
            raise AssertionError(f"L{level}: compress(validate=True) "
                                 "differs from compress()")
        if oracle.decompress(checked, len(data)) != data:
            raise AssertionError(f"L{level} validate: libzstd decode "
                                 "differs")
        for k, n in tk.launches.items():
            launches[k] += n
        phase("robust", case="wrong device claims and validate",
              level=level, input_bytes=len(data), decoded=True,
              validate_refused_wrong_claims=True, validate_equal=True,
              seconds=time.perf_counter() - t0)


def build_race(repo: str, build_root: str, go, queue) -> None:
    """Phase 9 (d), one of two spawned processes: _build.build() against
    the empty `build_root`, started with the other at `go`; reports (the
    library's path, this process's nvcc seconds or None)."""
    sys.path.insert(0, repo)
    from qat_zstd_plugin_tpu_torch.ops import _build
    _build.BUILD_ROOT = build_root
    go.wait(60)
    path = _build.build()
    queue.put((path, _build.build_seconds))


def first_build_by_two(root: str) -> None:
    """Phase 9 (d): two processes build csrc/ at once into a new build
    root under build/: exactly one runs nvcc, and both get the same
    library."""
    import shutil
    ctx = multiprocessing.get_context("spawn")
    race = os.path.join(root, "build", f"phase9_build.{os.getpid()}")
    shutil.rmtree(race, ignore_errors=True)
    go, queue = ctx.Barrier(2), ctx.Queue()
    procs = [ctx.Process(target=build_race, args=(root, race, go, queue))
             for _ in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = []
    try:
        deadline = time.monotonic() + 300
        while len(got) < len(procs) and time.monotonic() < deadline:
            try:
                got.append(queue.get(timeout=1))
            except Empty:
                if not all(p.is_alive() for p in procs) and queue.empty():
                    break
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    shutil.rmtree(race, ignore_errors=True)
    built = [s for _, s in got if s is not None]
    same = len(got) == 2 and got[0][0] == got[1][0]
    phase("robust", case="first build by two processes",
          nvcc_runs=len(built), nvcc_s=built, same_library=same,
          seconds=time.perf_counter() - t0)
    if len(built) != 1 or not same or any(p.exitcode for p in procs):
        raise AssertionError(f"first build by two processes: {got}, exit "
                             f"codes {[p.exitcode for p in procs]}")


def run_threads(fn, nthreads: int) -> float:
    """fn(tid) in nthreads threads started at a barrier; re-raises the
    first error; returns the wall seconds from the barrier to the last
    join."""
    barrier = threading.Barrier(nthreads + 1)
    errors = []

    def wrap(tid):
        try:
            barrier.wait(60)
            fn(tid)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(t,))
               for t in range(nthreads)]
    for t in threads:
        t.start()
    barrier.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
        if t.is_alive():
            raise AssertionError("a thread did not finish")
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def shared_codec_threads(torch, qzt, tk, oracle, datas: list, card: str,
                         launches: dict) -> None:
    """Phase 9 (c): one GpuCodec(level=1, batch=8) on the card from
    THREADS threads x ROUNDS rounds, each thread on datas[tid], without
    and with a torch.cuda.Stream of its own: every frame equals the
    one-thread frame, stats.input_bytes and device_blocks balance, and
    each kernel's launch total is THREADS x ROUNDS times one call's (the
    counts reset just before and read just after, added to `launches`).
    Prints the aggregate MB/s of the threads beside one thread's."""
    codec = qzt.GpuCodec(level=1, batch=8, device="cuda")
    codec.compress(datas[0])  # warm-up
    torch.cuda.synchronize()
    tk.reset_launches()
    codec.compress(datas[0])
    one_call = dict(tk.launches)
    t0 = time.perf_counter()
    want = [codec.compress(d) for d in datas]
    one_thread_mbs = sum(map(len, datas)) / (time.perf_counter() - t0) / 1e6
    for f, d in zip(want, datas):
        if oracle.decompress(f, len(d)) != d:
            raise AssertionError("shared codec: libzstd decode differs")
    for streams in (False, True):
        got = [[None] * ROUNDS for _ in datas]
        in0, dev0 = codec.stats.input_bytes, codec.device_blocks

        def work(tid):
            ctx = torch.cuda.stream(torch.cuda.Stream()) if streams \
                else contextlib.nullcontext()
            with ctx:
                for r in range(ROUNDS):
                    got[tid][r] = codec.compress(datas[tid])
                torch.cuda.current_stream().synchronize()

        tk.reset_launches()
        seconds = run_threads(work, THREADS)
        counts = dict(tk.launches)
        for k, n in counts.items():
            launches[k] += n
        what = "per-thread streams" if streams else "the current stream"
        if any(f != want[t] for t in range(THREADS) for f in got[t]):
            raise AssertionError(f"shared codec, {what}: a frame differs "
                                 "from the one-thread frame")
        calls = THREADS * ROUNDS
        nbytes = ROUNDS * sum(map(len, datas))
        nblocks = ROUNDS * sum(len(d) // BLOCK for d in datas)
        wrong = {k: (counts[k], calls * n) for k, n in one_call.items()
                 if counts[k] != calls * n}
        phase("robust", case=f"one GpuCodec(level=1, batch=8), {THREADS} "
              f"threads x {ROUNDS} rounds, {what}", input_bytes=nbytes,
              seconds=seconds, aggregate_mbs=nbytes / seconds / 1e6,
              one_thread_mbs=one_thread_mbs, card=card,
              stats_input_bytes=codec.stats.input_bytes - in0,
              device_blocks=codec.device_blocks - dev0,
              launches={k: n for k, n in counts.items() if n},
              one_call_launches={k: n for k, n in one_call.items() if n})
        if codec.stats.input_bytes - in0 != nbytes \
                or codec.device_blocks - dev0 != nblocks:
            raise AssertionError(f"shared codec, {what}: counters lost "
                                 "updates")
        if wrong or not one_call["compact_slots_sync"]:
            raise AssertionError(f"shared codec, {what}: launch totals "
                                 f"(got, want) {wrong}")


def other_threads(torch, qzt, tk, oracle, datas: list, launches: dict
                  ) -> None:
    """Phase 9 (c), the rest: distinct codecs at DISTINCT_LEVELS from
    THREADS threads, compress_via_libzstd(device="cuda") from
    PRODUCER_THREADS threads, each frame equal to its one-thread frame
    and decoded; then runtime/device.py's start and stop hammered from
    THREADS threads (tests/test_concurrency.py's case), after which the
    card is up and a compress decodes."""
    from qat_zstd_plugin_tpu_torch.runtime import device
    level_of = [DISTINCT_LEVELS[t % len(DISTINCT_LEVELS)]
                for t in range(THREADS)]
    runs = (("distinct codecs", THREADS, lambda t: qzt.GpuCodec(
                level=level_of[t], batch=8, device="cuda").compress(
                datas[t])),
            ("compress_via_libzstd", PRODUCER_THREADS,
             lambda t: qzt.compress_via_libzstd(datas[t], level=1,
                                                device="cuda")))
    for what, nthreads, call in runs:
        want = [call(t) for t in range(nthreads)]
        got = [None] * nthreads
        tk.reset_launches()
        seconds = run_threads(lambda t: got.__setitem__(t, call(t)),
                              nthreads)
        for k, n in tk.launches.items():
            launches[k] += n
        for t in range(nthreads):
            if got[t] != want[t] or oracle.decompress(
                    got[t], len(datas[t])) != datas[t]:
                raise AssertionError(f"{what}, thread {t}: the frame "
                                     "differs or does not decode")
        phase("robust", case=f"{what} from {nthreads} threads",
              levels=level_of[:nthreads] if what == "distinct codecs"
              else [1], seconds=seconds, equal=True)

    stop_barrier = threading.Barrier(THREADS)

    def lifecycle(tid):
        for _ in range(5):
            device.start_device()
        stop_barrier.wait(60)
        if tid == 0:
            device.stop_device()
        device.start_device()

    run_threads(lifecycle, THREADS)
    status = device.start_device()
    frame = qzt.GpuCodec(level=1, device="cuda").compress(datas[0])
    if status != device.Status.OK or oracle.decompress(
            frame, len(datas[0])) != datas[0]:
        raise AssertionError(f"device lifecycle under threads: {status}")
    phase("robust", case=f"device start and stop from {THREADS} threads",
          status=status.name, devices=len(device.devices()))


def robustness_phase(torch, qzt, tk, oracle, root: str, args,
                     dense_corpus: bytes, card: str) -> dict:
    """Phase 9: the fuzz inputs through every level on the card against
    the same codecs on the CPU (computed in FUZZ_WORKERS spawned workers
    while the card runs (a), (b) and (d)), wrong device claims and
    validate, a first build by two processes, then threads on one card.
    Every kernel a level reaches (all but B17-B19) must launch. Returns
    the launch counts."""
    from qat_zstd_plugin_tpu_torch.utils.corpora import FUZZ_KINDS
    launches = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    cases = fuzz_cases(args.seed)
    pool = concurrent.futures.ProcessPoolExecutor(
        FUZZ_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_fuzz_worker_init)
    try:
        want = [pool.submit(cpu_fuzz_frame, *c[:4], c[5]) for c in cases]
        frames = fuzz_on_card(torch, qzt, tk, oracle, cases, launches)
        card_s = time.perf_counter() - t0
        wrong_claims(torch, qzt, tk, oracle,
                     dense_corpus[:8 * BLOCK + TAIL], launches)
        first_build_by_two(root)
        for c, frame, w in zip(cases, frames, want):
            if frame != w.result():
                raise AssertionError(
                    f"fuzz L{c[0]} {c[1]} block {c[2]} {FUZZ_KINDS[c[4]]} "
                    f"{len(c[5])} bytes: the card's frame differs from "
                    "device='cpu''s")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    phase("robust", case="fuzz, card vs cpu", frames=len(cases),
          equal=True, decoded=True,
          input_bytes=sum(len(c[5]) for c in cases),
          card_s=card_s, seconds=time.perf_counter() - t0,
          sizes=sorted({len(c[5]) for c in cases}),
          kinds=sorted({FUZZ_KINDS[c[4]] for c in cases}),
          codecs=len({c[:4] for c in cases}))
    datas = [dense_corpus[t * (THREAD_MB << 20):(t + 1) * (THREAD_MB << 20)
                          + TAIL] for t in range(THREADS)]
    shared_codec_threads(torch, qzt, tk, oracle, datas, card, launches)
    other_threads(torch, qzt, tk, oracle,
                  [d[:(1 << 20) + TAIL] for d in datas], launches)
    missing = [k for k in ROBUST_KERNELS if launches[k] == 0]
    phase("robust", case="phase 9", seconds=time.perf_counter() - t0,
          launches={k: n for k, n in launches.items() if n})
    if missing:
        raise AssertionError(f"phase 9: kernels never launched: {missing}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the format contract on the card
# ---------------------------------------------------------------------------

def _format_worker_init() -> None:
    """Each phase 10 worker takes one core and imports the decoder."""
    import torch
    torch.set_num_threads(1)
    from qat_zstd_plugin_tpu_torch import decoder  # noqa: F401


def port_decode_frame(frame: bytes, data: bytes) -> tuple:
    """Phase 10 (a) in a worker: the port's decoder (decoder.py, not
    libzstd) on `frame`. Returns (equal to `data`, the host's seconds)."""
    from qat_zstd_plugin_tpu_torch import decoder
    t0 = time.perf_counter()
    out = decoder.decompress(frame)
    return out == data, time.perf_counter() - t0


def differential_frame(frame: bytes, seed: int, n: int) -> dict:
    """Phase 10 (b) in a worker: `n` seeded mutations of `frame`
    (tools.fuzz_decoder.mutate), each decoded by the port's decoder and by
    stock libzstd. Returns the verdict counts, the port's rejects of what
    stock decoded by reason (each one of STRICTER_REJECTS), and the first
    disagreement (None if there was none): bytes that differ, a port
    decode of what stock rejects, a reject other than DecodeError, or a
    one-sided reject for another reason."""
    import random
    from qat_zstd_plugin_tpu_torch import decoder
    from qat_zstd_plugin_tpu_torch.tools import fuzz_decoder as fz
    rnd = random.Random(seed)
    out = {"both_decoded": 0, "both_rejected": 0, "stricter": {},
           "finding": None}
    for i in range(n):
        m = fz.mutate(rnd, frame)
        stock = fz.stock_decode(m)
        try:
            port, reason = decoder.decompress(m, max_output=fz.MAX_OUT), None
        except decoder.DecodeError as exc:
            port, reason = None, str(exc)
        except Exception as exc:  # noqa: BLE001 - an unclean reject
            port, reason = exc, None
        if port is None and stock is None:
            out["both_rejected"] += 1
        elif port is not None and port == stock:
            out["both_decoded"] += 1
        elif port is None and reason in STRICTER_REJECTS:
            out["stricter"][reason] = out["stricter"].get(reason, 0) + 1
        else:
            out["finding"] = dict(
                mutation=i, frame=m.hex(), stock="rejected" if stock is None
                else f"{len(stock)} bytes",
                port=repr(port) if isinstance(port, Exception)
                else f"rejected: {reason}" if port is None
                else f"{len(port)} bytes")
            return out
    return out


def producer_lz4s(lz4s_format, block: bytes, triples: list) -> tuple:
    """The producer's triples of `block` as LZ4s: (stream, the literal
    bytes it carries)."""
    buf = memoryview(block)
    pos, lits = 0, bytearray()
    for _, ll, ml in triples:
        lits += buf[pos:pos + ll]
        pos += ll + ml
    if pos != len(block):
        raise AssertionError(f"triples span {pos} of {len(block)} bytes")
    seqs = [lz4s_format.Sequence(*t) for t in triples]
    return lz4s_format.encode(seqs, bytes(lits)), bytes(lits)


def lz4s_on_card(torch, qzt, tk, corpus: bytes, launches: dict) -> None:
    """Phase 10 (c): the card as the LZ4s engine. At each LZ4S_LEVELS
    level a SeqProdState(block_size=LZ4S_BLOCK, device="cuda") produces
    the triples of LZ4S_SLICES slices of the corpus, the final
    (0, last_literals, 0) included; each slice's triples written as LZ4s
    with the block's literal bytes come back exactly through
    lz4s_format.decode and native.dec_lz4s, and pass
    format.validate_sequences against the slice. LZ4s offsets are 16 bits,
    as on the QAT engine, so only a block of at most 65536 bytes
    guarantees that every offset fits: the copied encode keeps an
    offset's low 16 bits (offset & 0xFFFF), as the JAX package's does."""
    from qat_zstd_plugin_tpu_torch import format as tformat
    from qat_zstd_plugin_tpu_torch import lz4s_format, native
    for level in LZ4S_LEVELS:
        state = qzt.SeqProdState(level, block_size=LZ4S_BLOCK, device="cuda")
        tokens = stream_bytes = 0
        tk.reset_launches()
        t0 = time.perf_counter()
        blocks = [corpus[i * LZ4S_BLOCK:(i + 1) * LZ4S_BLOCK]
                  for i in range(LZ4S_SLICES)]
        produced = [qzt.sequence_producer(state, b) for b in blocks]
        card_s = time.perf_counter() - t0
        for k, n in tk.launches.items():
            launches[k] += n
        for i, (block, triples) in enumerate(zip(blocks, produced)):
            what = f"LZ4s L{level} slice {i}"
            if triples is qzt.SEQUENCE_PRODUCER_ERROR:
                raise AssertionError(f"{what}: producer error "
                                     f"{state.last_error!r}")
            stream, _ = producer_lz4s(lz4s_format, block, triples)
            got = [(s.offset, s.lit_length, s.match_length)
                   for s in lz4s_format.decode(stream)]
            if got != triples:
                raise AssertionError(f"{what}: lz4s_format.decode differs")
            ll, of, ml = native.dec_lz4s(stream)
            if list(zip(of.tolist(), ll.tolist(), ml.tolist())) != triples:
                raise AssertionError(f"{what}: native.dec_lz4s differs")
            tformat.validate_sequences(
                np.frombuffer(block, np.uint8),
                tformat.BlockSequences(ll[:-1], of[:-1], ml[:-1],
                                       int(ll[-1])))
            tokens += len(triples)
            stream_bytes += len(stream)
        if state.device_blocks != LZ4S_SLICES or state.errors:
            raise AssertionError(f"LZ4s L{level}: {state.device_blocks} "
                                 f"device blocks, {state.errors} errors")
        phase("format", case="lz4s", level=level, streams=LZ4S_SLICES,
              tokens=tokens, stream_bytes=stream_bytes,
              input_bytes=LZ4S_SLICES * LZ4S_BLOCK, card_s=card_s,
              exact=True, validated=True, decoders=["lz4s_format.decode",
                                                    "native.dec_lz4s"])


def format_phase(torch, qzt, tk, oracle, args, corpus: bytes,
                 card: str) -> dict:
    """Phase 10: the frames the card writes, read by the port's own
    decoder. (a) Each kind's frame on ragged_bytes(corpus, FORMAT_BYTES)
    and phase 9's eight shapes at FORMAT_FUZZ_BYTES, written on the card
    (launch counts reset just before and read just after each), decoded
    by stock libzstd here and by decoder.py in FORMAT_WORKERS spawned
    workers while the card writes the next; both must return the input.
    (b) Each device-entropy kind again on DIFF_BYTES without a checksum,
    DIFF_MUTATIONS seeded mutations of its frame, on each of which the
    port's decoder and libzstd agree (differential_frame, in the workers);
    some must decode in both. (c) LZ4s with the card as the engine.
    The decoder's times are the host's. Every kernel a level reaches must
    launch. Returns the launch counts."""
    from qat_zstd_plugin_tpu_torch.utils.corpora import FUZZ_KINDS, \
        adversarial
    launches = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    data = ragged_bytes(corpus, FORMAT_BYTES)
    pool = concurrent.futures.ProcessPoolExecutor(
        FORMAT_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_format_worker_init)
    try:
        def counted(run):
            tk.reset_launches()
            frame = run()
            for k, n in tk.launches.items():
                launches[k] += n
            return frame

        def codec_frame(level, entropy, x, block=BLOCK, sections=True,
                        checksum=None):
            codec = qzt.GpuCodec(level=level, batch=8, block_size=block,
                                 device="cuda", device_entropy=entropy)
            frame = codec.compress(x, checksum=checksum)
            what = f"L{level} {entropy} {len(x)} bytes"
            if codec.stats.fallback_blocks or \
                    codec.device_blocks != len(x) // block:
                raise AssertionError(f"{what}: {codec.device_blocks} device "
                                     "blocks, a block fell back")
            if sections and entropy and not codec.section_blocks:
                raise AssertionError(f"{what}: no card sequence section")
            if sections and entropy is True and not codec.literal_blocks:
                raise AssertionError(f"{what}: no card literals section")
            return frame

        def stream_feed():
            sc = qzt.StreamCompressor(level=1, batch=8, device="cuda")
            return b"".join(sc.compress(data[i:i + FEED_CHUNK]) for i in
                            range(0, len(data), FEED_CHUNK)) + sc.finish()

        kinds = [(f"compress L{lv}", lambda lv=lv: codec_frame(lv, False,
                                                                data))
                 for lv in FORMAT_LEVELS]
        kinds += [(f"compress L{lv} {e}", lambda lv=lv, e=e: codec_frame(
                   lv, e, data)) for e in ("hybrid", True)
                  for lv in FORMAT_ENTROPY_LEVELS]
        kinds += [(f"compress_via_libzstd L{lv}",
                   lambda lv=lv: qzt.compress_via_libzstd(data, level=lv,
                                                          device="cuda"))
                  for lv in FORMAT_ENTROPY_LEVELS]
        kinds += [("compress_stream_via_libzstd L1",
                   lambda: qzt.compress_stream_via_libzstd(
                       data, level=1, device="cuda", chunk_size=STREAM_CHUNK,
                       flush_every=STREAM_FLUSH)),
                  ("StreamCompressor L1", stream_feed)]
        jobs = []
        for name, run in kinds:
            frame = counted(run)
            if oracle.decompress(frame, len(data)) != data:
                raise AssertionError(f"{name}: libzstd decode differs")
            jobs.append((name, len(data), len(frame),
                         pool.submit(port_decode_frame, frame, data)))
        rng_seed = (args.seed, 10)
        for level, entropy in ((1, False), (9, True)):
            frames = []
            for kind in range(len(FUZZ_KINDS)):
                x = adversarial(np.random.default_rng((*rng_seed, kind)),
                                (FORMAT_FUZZ_BYTES,), kind)
                frame = counted(lambda: codec_frame(level, entropy, x,
                                                    sections=False))
                if oracle.decompress(frame, len(x)) != x:
                    raise AssertionError(f"fuzz L{level} {entropy} "
                                         f"{FUZZ_KINDS[kind]}: libzstd "
                                         "decode differs")
                frames.append((frame, x))
            jobs.append((f"fuzz shapes L{level} {entropy}",
                         len(frames) * FORMAT_FUZZ_BYTES,
                         sum(len(f) for f, _ in frames),
                         [pool.submit(port_decode_frame, f, x)
                          for f, x in frames]))
        diffs = []
        x = data[:DIFF_BYTES]
        for e in ("hybrid", True):
            for lv in FORMAT_ENTROPY_LEVELS:
                frame = counted(lambda: codec_frame(
                    lv, e, x, block=DIFF_BLOCK, checksum=False))
                if oracle.decompress(frame, len(x)) != x:
                    raise AssertionError(f"L{lv} {e} {len(x)} bytes: "
                                         "libzstd decode differs")
                diffs.append((f"L{lv} {e}", len(frame), pool.submit(
                    differential_frame, frame, args.seed * 1000 + lv,
                    DIFF_MUTATIONS)))
        card_s = time.perf_counter() - t0
        lz4s_on_card(torch, qzt, tk, corpus, launches)

        decode_s = 0.0
        for name, nin, nframe, fut in jobs:
            got = [f.result() for f in fut] if isinstance(fut, list) \
                else [fut.result()]
            if not all(ok for ok, _ in got):
                raise AssertionError(f"{name}: the port's decoder did not "
                                     "return the input")
            sec = sum(t for _, t in got)
            decode_s += sec
            phase("format", case="decode", kind=name, input_bytes=nin,
                  frame_bytes=nframe, frames=len(got), libzstd_equal=True,
                  decoder_equal=True, host_decoder_s=sec,
                  host_decoder_mbs=nin / sec / 1e6, card=card)
        for name, nframe, fut in diffs:
            r = fut.result()
            if r["finding"] is not None:
                raise AssertionError(f"differential {name}: the port's "
                                     f"decoder and libzstd disagree: "
                                     f"{r['finding']}")
            if not r["both_decoded"]:
                raise AssertionError(f"differential {name}: no mutation "
                                     "decoded in both: nothing compared")
            phase("format", case="differential", kind=name,
                  input_bytes=DIFF_BYTES, frame_bytes=nframe,
                  checksum=False, mutations=DIFF_MUTATIONS,
                  both_decoded=r["both_decoded"],
                  both_rejected=r["both_rejected"],
                  stock_only_decoded=r["stricter"], agree=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    missing = [k for k in ROBUST_KERNELS if launches[k] == 0]
    phase("format", case="phase 10", seconds=time.perf_counter() - t0,
          card_s=card_s, frames=len(kinds) + 2 * len(FUZZ_KINDS),
          host_decoder_s=decode_s, workers=FORMAT_WORKERS, card=card,
          launches={k: n for k, n in launches.items() if n})
    if missing:
        raise AssertionError(f"phase 10: kernels never launched: {missing}")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the rest of the package on the card
# ---------------------------------------------------------------------------

def cpu_rest(path: str, blocks_np: np.ndarray, kw: dict):
    """The CPU side of a phase 11 path check, in a worker process: the
    match_pipeline or glue_kernels function `path` on the twins."""
    import torch
    from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
    from qat_zstd_plugin_tpu_torch.ops import match_pipeline as mp
    fn = {"positions": mp.find_matches_positions,
          "hash_split": tk.find_matches_hash_split,
          "staged": mp.find_matches_staged}[path]
    B, N = blocks_np.shape
    return _numpy(fn(torch.from_numpy(blocks_np),
                     torch.full((B,), N, dtype=torch.int32), **kw))


def cpu_table_frame(level: int, batch: int, data: bytes, table: dict
                    ) -> bytes:
    """The CPU frame of GpuCodec(level, batch) with the level's device
    table replaced by `table`'s fields, in a worker process."""
    import dataclasses
    import qat_zstd_plugin_tpu_torch as qzt
    from qat_zstd_plugin_tpu_torch.runtime import levels
    levels.TPU_LEVEL_TABLE[level] = dataclasses.replace(
        levels.TPU_LEVEL_TABLE[level], **table)
    return qzt.GpuCodec(level=level, batch=batch,
                        device="cpu").compress(data)


def cpu_bitpack(lo: np.ndarray, hi: np.ndarray, nb: np.ndarray,
                max_words: int):
    """bitpack on the CPU, in a worker process."""
    import torch
    from qat_zstd_plugin_tpu_torch.ops import bitpack
    return _numpy(bitpack.bitpack(torch.from_numpy(lo), torch.from_numpy(hi),
                                  torch.from_numpy(nb), max_words))


def cpu_entry() -> np.ndarray:
    """entry("cpu")'s fn on its inputs, in a worker process."""
    from qat_zstd_plugin_tpu_torch import entry
    fn, args = entry.entry("cpu")
    return fn(*args).numpy()


def _rest_worker_init() -> None:
    """Each phase 11 CPU worker takes its share of the host's cores."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // REST_WORKERS))


def pipeline_rank(rank: int, world: int, init_method: str, root: str,
                  blocks_np: np.ndarray, queue, go) -> None:
    """Phase 11, one gloo rank in a spawned process, driving cuda:0:
    joins the group, reports ("ready", rank), waits for `go`, then runs
    sharded_pipeline and compression_step (REST_BATCH_KW) on its share of
    the rows and reports ("done", rank, rows, out, stats, launches, ms),
    or ("error", rank, traceback)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, root)
    try:
        from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
        from qat_zstd_plugin_tpu_torch.parallel import distributed, mesh
        from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
        torch.cuda.set_device(0)
        distributed.init(init_method, world_size=world, rank=rank,
                         backend="gloo")
        m = mesh.make_mesh()
        B = len(blocks_np)
        rows = (rank * B // world, (rank + 1) * B // world)
        x = torch.from_numpy(blocks_np[rows[0]:rows[1]]).cuda()
        n = torch.full((len(x),), BLOCK, dtype=torch.int32, device="cuda")
        queue.put(("ready", rank))
        if not go.wait(MESH_TIMEOUT_S):
            raise TimeoutError("no go from the parent")
        run = mesh.sharded_pipeline(m, **REST_BATCH_KW, device="cuda")
        step = mesh.compression_step(m, **REST_BATCH_KW, device="cuda")
        tk.reset_launches()
        out = run(x, n)
        o2, stats = step(x, n)
        torch.cuda.synchronize()
        launches = dict(tk.launches)
        for k in out:
            if not torch.equal(out[k], o2[k]):
                raise AssertionError(f"compression_step's {k} differs")
        ms = cuda_ms(lambda: run(x, n), reps=5)
        queue.put(("done", rank, rows, _numpy({k: v.cpu() for k, v in
                                                out.items()}),
                   _numpy({k: v.cpu() for k, v in stats.items()}),
                   launches, ms))
    except Exception:
        queue.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    queue.close()
    queue.join_thread()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _equal_dict(torch, got: dict, want: dict, what: str) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: dict keys differ")
    for k, v in want.items():
        exact(torch, torch.as_tensor(got[k]).cpu(), torch.as_tensor(v),
              f"{what} {k}")


def _b14_items(torch, tk, fk, mp, blocks, lengths):
    """The items B14 and the extras hand the packer at B=64: level 9's
    hybrid compaction of the batch, its sections prepared and B14 run,
    [state_0, extras_0, state_1, ...] as in fse_kernel.finish_sections,
    (lo, hi, nbits) int32 each."""
    out = mp.content_sequences(blocks, lengths, 8, MAX_SEQ, True)[0]
    prep = fk.prepare_sections(out["lit_len"], out["offset"],
                               out["match_len"], out["nseq"], True)
    st_lo, st_nb = fk.run_state_kernel(*prep["state_args"])
    ex_lo, ex_hi, ex_nb = prep["extras"]
    B, S1 = ex_lo.shape
    lo = torch.stack([st_lo.t().to(torch.int64) & 0xFFFFFFFF, ex_lo], 2)
    hi = torch.stack([torch.zeros_like(ex_hi), ex_hi], 2)
    nb = torch.stack([st_nb.t().to(torch.int64), ex_nb], 2)
    return tuple(tk._i32(a.reshape(B, 2 * S1)).contiguous()
                 for a in (lo, hi, nb))


def _need(launches: dict, kernels, what: str) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing}")


def rest_phase(torch, qzt, tk, oracle, root: str, dense_np: np.ndarray,
               dense_corpus: bytes, card: str) -> dict:
    """Phase 11: the paths of the JAX package the port holds beyond the
    levels' own, on the card against the same call on the CPU twins
    (computed in REST_WORKERS spawned workers meanwhile), each timed a
    batch with its launch counts read just after: the parsed L1 path at
    psegs 4 and GpuCodec with that table, the packed hash contract,
    find_matches_staged (greedy and lazy), sharded_pipeline and
    compression_step (an NCCL world of one here, then MESH_RANKS gloo
    ranks sharing the card), bitpack on B14's items, entry() and
    dryrun_multichip. Returns the launch counts of the counted calls."""
    import dataclasses
    import torch.distributed as dist
    from qat_zstd_plugin_tpu_torch import entry
    from qat_zstd_plugin_tpu_torch.ops import bitconcat, bitpack
    from qat_zstd_plugin_tpu_torch.ops import fse_kernel as fk
    from qat_zstd_plugin_tpu_torch.ops import match_pipeline as mp
    from qat_zstd_plugin_tpu_torch.parallel import mesh
    from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
    from qat_zstd_plugin_tpu_torch.runtime import levels
    t_phase = time.perf_counter()
    B, N = dense_np.shape
    dev = torch.device("cuda")
    blocks = torch.from_numpy(dense_np).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    frame_data = dense_corpus[:8 * BLOCK + TAIL]
    launches = dict.fromkeys(KERNELS, 0)

    def counted(fn, kernels, what: str):
        out, n = _on_card_counted(torch, tk, fn)
        _need(n, kernels, what)
        for k, v in n.items():
            launches[k] += v
        return out, {k: v for k, v in n.items() if v}

    procs, queue, go = spawn_ranks(pipeline_rank, MESH_RANKS, root, dense_np)
    pool = concurrent.futures.ProcessPoolExecutor(
        REST_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_rest_worker_init)
    try:
        w_parsed = [pool.submit(cpu_rest, "positions", dense_np, kw)
                    for kw in PSEGS_CASES]
        w_hash = pool.submit(cpu_rest, "hash_split", dense_np, HASH_PACKED)
        w_batch = pool.submit(cpu_rest, "staged", dense_np, REST_BATCH_KW)
        w_staged = pool.submit(cpu_rest, "staged", dense_np,
                               {**REST_BATCH_KW, "lazy": True})
        w_entry = pool.submit(cpu_entry)
        w_frames = [pool.submit(cpu_table_frame, 1, 8, frame_data, table)
                    for table in PSEGS_TABLES]

        # The parsed L1 path at psegs 4, greedy and lazy.
        got_parsed = []
        for kw in PSEGS_CASES:
            out, n = counted(lambda: mp.find_matches_positions(
                blocks, lengths, **kw), PSEGS_KERNELS, f"psegs {kw}")
            got_parsed.append((out.cpu(), n, cuda_ms(
                lambda: mp.find_matches_positions(blocks, lengths, **kw),
                reps=5)))
        # GpuCodec on that table: 32 MiB + the tail, and the 8-block frames.
        base = levels.TPU_LEVEL_TABLE[1]
        got_frames = []
        try:
            for table in PSEGS_TABLES:
                levels.TPU_LEVEL_TABLE[1] = dataclasses.replace(base, **table)
                qzt.GpuCodec(level=1, batch=B, device="cuda").compress(
                    dense_corpus[:BLOCK + TAIL])  # warm-up
                codec = qzt.GpuCodec(level=1, batch=B, device="cuda")
                tk.reset_launches()
                t0 = time.perf_counter()
                frame = codec.compress(dense_corpus)
                seconds = time.perf_counter() - t0
                n = dict(tk.launches)
                _need(n, PSEGS_KERNELS, f"GpuCodec L1 {table}")
                for k, v in n.items():
                    launches[k] += v
                if oracle.decompress(frame, len(dense_corpus)) != \
                        dense_corpus:
                    raise AssertionError(f"GpuCodec L1 {table}: libzstd "
                                         "decode differs")
                if codec.stats.fallback_blocks or \
                        codec.device_blocks != len(dense_corpus) // BLOCK:
                    raise AssertionError(f"GpuCodec L1 {table}: a block fell "
                                         "back")
                phase("rest", path="GpuCodec L1 parsed", table=table,
                      batch=B, input_bytes=len(dense_corpus),
                      frame_bytes=len(frame),
                      ratio=len(frame) / len(dense_corpus), seconds=seconds,
                      e2e_mbs=len(dense_corpus) / seconds / 1e6,
                      decoder="libzstd",
                      launches={k: v for k, v in n.items() if v})
                got_frames.append(qzt.GpuCodec(
                    level=1, batch=8, device="cuda").compress(frame_data))
        finally:
            levels.TPU_LEVEL_TABLE[1] = base

        # The packed hash contract, both entry points.
        got_hash = {}
        for name, fn in (
                ("find_matches_packed(matcher='hash')",
                 lambda: mp.find_matches_packed(blocks, lengths,
                                                matcher="hash",
                                                **HASH_PACKED)),
                ("find_matches_hash_split",
                 lambda: tk.find_matches_hash_split(blocks, lengths,
                                                    **HASH_PACKED))):
            out, n = counted(fn, HASH_PACKED_KERNELS, name)
            got_hash[name] = (out.cpu(), n, cuda_ms(fn, reps=5))
        # find_matches_staged, greedy and lazy.
        got_content = {}
        for name, fn in (
                ("find_matches_staged", lambda: mp.find_matches_staged(
                    blocks, lengths, **REST_BATCH_KW)),
                ("find_matches_staged lazy", lambda: mp.find_matches_staged(
                    blocks, lengths, **REST_BATCH_KW, lazy=True))):
            out, n = counted(fn, ("parse_greedy",), name)
            got_content[name] = ({k: v.cpu() for k, v in out.items()}, n,
                                 cuda_ms(fn, reps=5))
        # sharded_pipeline and compression_step in an NCCL world of one.
        dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                                f"{_free_port()}", world_size=1, rank=0)
        try:
            m = mesh.make_mesh()
            run = mesh.sharded_pipeline(m, **REST_BATCH_KW, device="cuda")
            step = mesh.compression_step(m, **REST_BATCH_KW, device="cuda")
            out, n = counted(lambda: run(blocks, lengths), ("parse_greedy",),
                             "sharded_pipeline nccl")
            (o2, stats), n2 = counted(lambda: step(blocks, lengths),
                                      ("parse_greedy",),
                                      "compression_step nccl")
            got_nccl = ({k: v.cpu() for k, v in out.items()},
                        {k: v.cpu() for k, v in o2.items()},
                        {k: v.cpu() for k, v in stats.items()}, n,
                        cuda_ms(lambda: run(blocks, lengths), reps=5),
                        cuda_ms(lambda: step(blocks, lengths), reps=5))
        finally:
            dist.destroy_process_group()
        # bitpack on B14's items, beside bitconcat (what the path packs
        # with) on the same items.
        items = _b14_items(torch, tk, fk, mp, blocks, lengths)
        w_bitpack = pool.submit(cpu_bitpack, *(a.cpu().numpy()
                                               for a in items), SEQ_WORDS)
        got_bp = bitpack.bitpack(*items, SEQ_WORDS)
        bc = bitconcat.bitconcat(*items, SEQ_WORDS, max_item_bits=64)
        bp_ms = cuda_ms(lambda: bitpack.bitpack(*items, SEQ_WORDS), reps=5)
        bc_ms = cuda_ms(lambda: bitconcat.bitconcat(
            *items, SEQ_WORDS, max_item_bits=64), reps=5)
        # entry()'s fn on the card.
        fn, args = entry.entry("cuda")
        got_entry, n_entry = counted(lambda: fn(*args), LEVEL_KERNELS[1],
                                     "entry")
        entry_ms = cuda_ms(lambda: fn(*args), reps=5)

        # The gloo ranks, now that this process's timed calls are done.
        rank_replies(queue, procs, "ready")
        go.set()
        ranks = rank_replies(queue, procs, "done")
        # dryrun_multichip: two more gloo ranks on the card.
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            report = entry.dryrun_multichip(MESH_RANKS, device="cuda")
        dryrun_s = time.perf_counter() - t0

        # Every card result against its CPU twin.
        for kw, (got, n, ms), want in zip(PSEGS_CASES, got_parsed, w_parsed):
            exact(torch, got, torch.from_numpy(want.result()),
                  f"parsed slot words {kw}")
            phase("rest", path="find_matches_positions", batch=B, **kw,
                  equal=True, claims=int((got != -1).sum()), ms=ms,
                  launches=n, card=card)
        for table, got, want in zip(PSEGS_TABLES, got_frames, w_frames):
            if got != want.result():
                raise AssertionError(f"GpuCodec L1 {table}: the card's "
                                     "frame differs from device='cpu'")
            if oracle.decompress(got, len(frame_data)) != frame_data:
                raise AssertionError(f"GpuCodec L1 {table}: 8-block frame "
                                     "does not decode")
            phase("rest", path="GpuCodec L1 parsed, card vs cpu",
                  table=table, input_bytes=len(frame_data), equal=True,
                  frame_bytes=len(got))
        want_hash = torch.from_numpy(w_hash.result())
        for name, (got, n, ms) in got_hash.items():
            exact(torch, got, want_hash, name)
            fields = mp.unpack_outputs(got.numpy())
            phase("rest", path=name, batch=B, **HASH_PACKED, equal=True,
                  sequences=int(fields["nseq"].sum()),
                  overflow_blocks=int(fields["overflow"].sum()), ms=ms,
                  launches=n, card=card)
        want_batch = _tensors(torch, w_batch.result())
        for name, want in (("find_matches_staged", want_batch),
                           ("find_matches_staged lazy",
                            _tensors(torch, w_staged.result()))):
            got, n, ms = got_content[name]
            _equal_dict(torch, got, want, name)
            phase("rest", path=name, batch=B, **REST_BATCH_KW,
                  lazy=name.endswith("lazy"), equal=True,
                  sequences=int(want["nseq"].sum()), ms=ms, launches=n,
                  card=card)
        out, o2, stats, n, ms, step_ms = got_nccl
        want_stats = {"nseq_all": want_batch["nseq"],
                      "last_literals_all": want_batch["last_literals"],
                      "total_sequences": want_batch["nseq"].sum(
                          dtype=torch.int32)}
        _equal_dict(torch, out, want_batch, "sharded_pipeline nccl")
        _equal_dict(torch, o2, want_batch, "compression_step nccl")
        _equal_dict(torch, stats, want_stats, "compression_step nccl stats")
        phase("rest", path="sharded_pipeline, compression_step",
              backend="nccl", world=1, batch=B, equal=True, ms=ms,
              step_ms=step_ms, launches=n, card=card)
        for rank, (rows, got, st, n, ms) in sorted(ranks.items()):
            _need(n, ("parse_greedy",), f"gloo rank {rank}")
            for k, v in n.items():
                launches[k] += v
            _equal_dict(torch, got, {k: v[rows[0]:rows[1]]
                                     for k, v in want_batch.items()
                                     if v.dim() and len(v) == B},
                        f"sharded_pipeline gloo rank {rank}")
            _equal_dict(torch, st, want_stats,
                        f"compression_step gloo rank {rank}")
            phase("rest", path="sharded_pipeline, compression_step",
                  backend="gloo", world=MESH_RANKS, rank=rank,
                  rows=list(rows), equal=True, ms=ms,
                  launches={k: v for k, v in n.items() if v}, card=card)
        want_bp = _tensors(torch, w_bitpack.result())
        for name, g, w in zip(("words", "total_bits", "overflow"), got_bp,
                              want_bp):
            exact(torch, g.cpu(), w, f"bitpack {name}")
        fits = ~got_bp[2]
        exact(torch, got_bp[0][fits], bc[0][fits], "bitpack vs bitconcat")
        exact(torch, got_bp[1], bc[1], "bitpack vs bitconcat bits")
        phase("rest", path="bitpack (B14's items)", batch=B,
              items=int(items[0].shape[1]), max_words=SEQ_WORDS, equal=True,
              overflow_blocks=int(got_bp[2].sum()), ms=bp_ms,
              bitconcat_ms=bc_ms, card=card)
        exact(torch, got_entry.cpu(), torch.from_numpy(w_entry.result()),
              "entry")
        phase("rest", path="entry()", equal=True,
              claims=int((got_entry != -1).sum()), ms=entry_ms,
              launches=n_entry, card=card)
        phase("rest", path="dryrun_multichip", world=MESH_RANKS,
              claims=report["claims"], step_s=report["step_s"],
              frames=report["frames"], seconds=dryrun_s,
              lines=text.getvalue().splitlines(), card=card)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        codes = join_ranks(procs, go)
    if any(codes):
        raise AssertionError(f"phase 11 ranks exited with {codes}")
    phase("rest", path="phase 11", seconds=time.perf_counter() - t_phase,
          card=card, launches={k: n for k, n in launches.items() if n})
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
        content_kernels_vs_twins(torch, tk, pk, dense_np, args.seed,
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

    # 8. The tools on the card.
    for k, n in tools_phase(torch, qzt, tk, oracle, dense_corpus, corpus,
                            card).items():
        launches[k] += n

    # 9. Robustness on the card.
    for k, n in robustness_phase(torch, qzt, tk, oracle, root, args,
                                 dense_corpus, card).items():
        launches[k] += n

    # 10. The format contract: the card's frames read by the port's own
    # decoder, the differential check, LZ4s with the card as the engine.
    for k, n in format_phase(torch, qzt, tk, oracle, args, corpus,
                             card).items():
        launches[k] += n

    # 11. The rest of the package on the card.
    for k, n in rest_phase(torch, qzt, tk, oracle, root, dense_np,
                           dense_corpus, card).items():
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
