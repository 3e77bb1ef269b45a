"""GpuCodec: batched block compression with the device half on one torch
device.

Port of qat_zstd_plugin_tpu.runtime.tpu_codec (`TpuCodec` and the module
functions its device path reaches), restricted to the branches the port
takes: the port's native runtime on the host, no golden Python path,
and host, hybrid or full device entropy coding. Full blocks go in
batches through the device half on a torch device (the CUDA kernels on
"cuda", their plain-torch twins on "cpu").

Defaults the caller leaves at None come from the process config
(utils/config.py, the QZ_* variables) as in TpuCodec: batch, block_size,
max_seq, compress()'s checksum, the entropy placement
(QZ_DEVICE_ENTROPY) and the device (QZ_FORCE_BACKEND: "", "cuda" and the
reference's "tpu" mean "cuda", which raises without a card; "cpu" runs
the twins; there is no fallback from the card to the CPU).

Host entropy (device_entropy=False, the default):

  * levels 1-4, the hash matcher: ops.match_pipeline.find_matches_positions
    -> slot words -> claim positions, which the native extension walk
    verifies and extends, then gap fill;
  * levels 5-12, the content matcher: ops.match_pipeline.find_matches_packed
    -> packed sequences -> coalesced, then the deep-level selector picks
    the hinted chain parse or the extension walk plus gap fill per block;
    with QZ_SECOND_PARSE=1 they skip the selector, take the extension
    walk, and also run the host chain parse, keeping the smaller body.

Hybrid device entropy (device_entropy="hybrid"): the device emits each
block's final FSE Sequences_Section and the host adds the literals
section (native.block_body_external_seqsec), with no extension and no
gap fill. Levels 1-4 take the byte-verified hash matcher
(find_matches_with_seqsec_hash), levels 5-12 the content matcher without
LDM (find_matches_with_seqsec).

Full device entropy (device_entropy=True, 1 or "full"): the same device
half also encodes each block's Huffman literals
(ops/literals_kernel.encode_literals_device), and the host only wraps
them (device_literals_section) and joins the two sections. A block whose
literals the device declines (the `ok` flag: too few literals or
symbols, a stream too long), whose section the format cannot hold, or
whose sequences do not span the block, gets the hybrid body; blocks with
both device sections are counted in `literal_blocks`.

The frames equal TpuCodec's byte for byte at the same level, batch size,
max_seq and entropy placement. The short tail block is matched on the
host, and so is a block whose device output overflows (more sequences
than max_seq, a literal run over 65535 in the packed output, or a
sequence section over its 8192 words): that is the device output's
format contract, as in the reference, and such blocks are counted in
`overflow_blocks`. A device error is raised where it happens; no batch is
re-matched on the CPU.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import fse_format, native
from ..format import (BLOCK_SIZE_MAX, BlockSequences, assemble_frame,
                      validate_sequences)
from ..ops import match_pipeline
from ..ops.bitpack import backward_stream_bytes
from ..ops.glue_kernels import segment_rule
from ..ops.literals_kernel import device_literals_section, streams_rule
from ..utils import config, logging
from .levels import TPU_LEVEL_TABLE, level_params
from .stats import BlockStats, Timer

QUEUE_DEPTH = 3  # device batches in flight
# QZ_DEVICE_ENTROPY's values (tpu_codec.TpuCodec.__init__'s map).
ENTROPY_ENV = {"": False, "0": False, "off": False, "1": True,
               "full": True, "hybrid": "hybrid"}
# QZ_FORCE_BACKEND's values: the reference's "" (the device when present)
# and "tpu" (require the device) both require the card here.
BACKEND_ENV = {"": "cuda", "cuda": "cuda", "tpu": "cuda", "cpu": "cpu"}


def coalesce_sequences(lit: np.ndarray, off: np.ndarray, ml: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge chains of capped matches: zero-literal successors with the
    same offset extend the previous match."""
    if len(lit) == 0:
        return lit, off, ml
    same = (lit == 0) & (off == np.roll(off, 1))
    same[0] = False
    starts = np.flatnonzero(~same)
    return lit[starts], off[starts], np.add.reduceat(ml, starts)


def device_positions_to_claims(pos: np.ndarray, off: np.ndarray,
                               block_len: int) -> BlockSequences:
    """Segment-slots unpack: length-less claims from claim positions. Each
    claim spans to the next one (the last gets 4 bytes); the native
    extension pass recomputes true literal runs and match lengths."""
    ns = len(pos)
    lit = np.zeros(ns, np.int64)
    ml = np.empty(ns, np.int64)
    last_lit = block_len
    if ns:
        lit[0] = pos[0]
        ml[:-1] = pos[1:] - pos[:-1]
        ml[-1] = 4
        last_lit = block_len - int(pos[-1]) - 4
    return BlockSequences(lit, off, ml, last_lit)


def deep_parse_pick(level: int, share: float, ctx_find: int,
                    block_size: int) -> bool:
    """Deep-level (L5+) parse selector: True -> hinted chain parse, False
    -> the extension walk over the device parse. Dense text-like parses
    (low literal share) want the chain parse, as do the first two blocks
    of a window (little context behind their device claims)."""
    bar = 0.13 if level >= 7 else 0.05
    return share < bar or (ctx_find < 2 * block_size and share < 0.40)


def device_outputs_to_sequences(out: dict, block_index: int
                                ) -> BlockSequences | None:
    """One block's coalesced sequences from unpacked device outputs; None
    when the device flagged overflow."""
    if bool(out["overflow"][block_index]):
        return None
    ns = int(out["nseq"][block_index])
    lit, off, ml = coalesce_sequences(
        out["lit_len"][block_index, :ns].astype(np.int64),
        out["offset"][block_index, :ns].astype(np.int64),
        out["match_len"][block_index, :ns].astype(np.int64))
    return BlockSequences(lit, off, ml,
                          int(out["last_literals"][block_index]))


def device_sequence_section(nseq: int, words: np.ndarray, bits: int,
                            plan: dict, i: int) -> bytes:
    """Block i's Sequences_Section from the device's stream: the nbSeq
    varint, the Symbol_Compression_Modes byte (FSE_Compressed for each
    stream whose custom table the device chose, Predefined otherwise),
    those tables' descriptions from the normalized counts, then the
    closed backward bitstream (reference: TpuCodec.collect_batch)."""
    mode = 0
    desc = b""
    if plan:
        for shift, kind, al in ((6, "ll", fse_format.LL_DEFAULT_ACCURACY),
                                (4, "of", fse_format.OF_DEFAULT_ACCURACY),
                                (2, "ml", fse_format.ML_DEFAULT_ACCURACY)):
            if bool(plan[f"use_{kind}"][i]):
                mode |= 2 << shift
                desc += fse_format.write_ncount(
                    [int(x) for x in plan[f"norm_{kind}"][i]], al)
    return (fse_format.nbseq_header(nseq) + bytes([mode]) + desc
            + backward_stream_bytes(words, bits))


def _batch_failed(e: Exception, where: str, nblocks: int) -> None:
    logging.error("device batch failed (%s) at %s; %d blocks, no CPU "
                  "re-match: raising", type(e).__name__, where, nblocks)


def entropy_mode(device_entropy) -> str | bool:
    """The reference's check of an explicit device_entropy
    (TpuCodec.__init__): False (or 0) is host entropy, "hybrid" hybrid,
    True (or 1, or "full") full device entropy; any other value raises
    ValueError."""
    if isinstance(device_entropy, int) and device_entropy in (0, 1):
        return bool(device_entropy)
    if device_entropy in ("hybrid", "full"):
        return "hybrid" if device_entropy == "hybrid" else True
    raise ValueError(f"device_entropy must be False, True/'full' or "
                     f"'hybrid', got {device_entropy!r}")


def check_block_size(level: int, block_size: int,
                     device_entropy: str | bool | None,
                     name: str = "block_size") -> None:
    """Raise ValueError, naming the rule and `name` (where the size came
    from), for a block size that `level` cannot take: outside
    1..BLOCK_SIZE_MAX (RFC 8878's Block_Maximum_Size, every codec), or
    one that the level's device route cannot tile (device_entropy None:
    no device route, as SoftwareCodec's). The hash
    levels (1-4) take the rule of their kernels' geometry
    (glue_kernels.segment_rule): segments of min(window, block) bytes, a
    multiple of 4, and a power of two with device entropy, where the
    byte-verified matcher runs; full device entropy at any level needs a
    multiple of 4 (literals_kernel.streams_rule). The content levels'
    route takes any other size."""
    if not 1 <= block_size <= BLOCK_SIZE_MAX:
        raise ValueError(f"{name}={block_size} is outside 1.."
                         f"{BLOCK_SIZE_MAX}: a zstd block holds at most "
                         "128 KiB (RFC 8878, Block_Maximum_Size)")
    if device_entropy is None:
        return
    p = TPU_LEVEL_TABLE[level]
    broken = None
    if p.matcher == "hash":
        broken = segment_rule(block_size, p.window, 4,
                              pow2=bool(device_entropy))
    if broken is None and device_entropy is True:
        broken = streams_rule(block_size)
    if broken:
        route = {False: "host entropy", "hybrid": "hybrid device entropy",
                 True: "full device entropy"}[device_entropy]
        raise ValueError(f"{name}={block_size}: level {level} with "
                         f"{route} cannot take it: {broken}")


class GpuCodec:
    """Batched block compressor on one torch device. One codec may be
    shared by threads: its counters take a lock, and each thread's
    batches go to that thread's current stream."""

    def __init__(self, level: int = 1, batch: int | None = None,
                 block_size: int | None = None, max_seq: int | None = None,
                 device: str | torch.device | None = None,
                 device_entropy: str | bool | None = None):
        if level not in TPU_LEVEL_TABLE:
            raise ValueError(f"unsupported level {level}: supported range "
                             "1..12")
        cfg = config.get()  # process defaults (QZ_* env); arguments win
        if device_entropy is None:
            if cfg.device_entropy not in ENTROPY_ENV:
                raise ValueError(
                    f"QZ_DEVICE_ENTROPY={cfg.device_entropy!r} (the default "
                    f"of device_entropy): expected one of "
                    f"{sorted(ENTROPY_ENV)}")
            device_entropy = ENTROPY_ENV[cfg.device_entropy]
        if device is None:
            if cfg.force_backend not in BACKEND_ENV:
                raise ValueError(
                    f"QZ_FORCE_BACKEND={cfg.force_backend!r}: expected "
                    f"one of {sorted(BACKEND_ENV)}")
            device = BACKEND_ENV[cfg.force_backend]
        self.device_entropy = entropy_mode(device_entropy)
        self.level = level
        self.params = TPU_LEVEL_TABLE[level]
        self.host = level_params(level)
        self.batch = cfg.batch if batch is None else batch
        self.block_size = cfg.block_size if block_size is None \
            else block_size
        check_block_size(level, self.block_size, self.device_entropy,
                         "QZ_BLOCK_SIZE" if block_size is None
                         else "block_size")
        self.max_seq = cfg.max_seq if max_seq is None else max_seq
        self.checksum_default = cfg.checksum
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={str(self.device)!r}: torch sees no "
                               "CUDA device")
        native.load()  # the host half; raises if it cannot be built
        self.stats = BlockStats()
        self.device_blocks = 0    # full blocks matched by the device half
        self.overflow_blocks = 0  # of those, re-matched on the host
        self.section_blocks = 0   # of those, with the device's section
        self.literal_blocks = 0   # of those, with its literals section too
        self._count_lock = threading.Lock()
        self._fn = None

    def _count(self, **deltas: int) -> None:
        """Add to the block counters under the codec's lock, so that the
        totals of threads sharing the codec are exact."""
        with self._count_lock:
            for name, n in deltas.items():
                setattr(self, name, getattr(self, name) + n)

    def _pipeline(self):
        if self._fn is None:
            self._fn = self.device_half(self.params.window)
        return self._fn

    def device_half(self, window: int):
        """The level's device half, (blocks, lengths) -> the device's
        output, at match window `window`: the level's in compress_bodies,
        min(the level's, block size) in parallel.pipeline.compress_mesh
        (as the reference's mesh path)."""
        p = self.params
        wlog = self.host.window_log
        # Full mode adds the device literals (tpu_codec._pipeline).
        lits = p.huffman and self.device_entropy is True
        if self.device_entropy and p.matcher == "hash":
            def run(blocks, lengths):
                return match_pipeline.find_matches_with_seqsec_hash(
                    blocks, lengths, neighbors=2, max_seq=self.max_seq,
                    lazy=p.lazy, window=window,
                    custom_tables=p.custom_tables, device_literals=lits)
        elif self.device_entropy:
            def run(blocks, lengths):
                return match_pipeline.find_matches_with_seqsec(
                    blocks, lengths, neighbors=p.neighbors,
                    max_seq=self.max_seq, lazy=p.lazy, stride=p.stride,
                    window=window, custom_tables=p.custom_tables,
                    device_literals=lits)
        elif p.matcher == "hash":
            def run(blocks, lengths):
                return match_pipeline.find_matches_positions(
                    blocks, lengths, widths=p.widths,
                    neighbors=p.neighbors, window=window, ldm=p.ldm,
                    ldm_max_off=1 << wlog, dense=p.dense, sync=p.sync,
                    lazy=p.lazy, psegs=p.psegs)
        else:
            def run(blocks, lengths):
                return match_pipeline.find_matches_packed(
                    blocks, lengths, neighbors=p.neighbors,
                    max_seq=self.max_seq, lazy=p.lazy, stride=p.stride,
                    window=window, ldm=p.ldm, ldm_max_off=1 << wlog)
        return run

    def submit_batch(self, blocks_np: np.ndarray, lengths_np: np.ndarray):
        """Copy one batch (b <= self.batch, zero-padded to self.batch as in
        the reference: LDM spans tile the batch) to the device and enqueue
        the pipeline on the current stream. Returns a handle."""
        b = blocks_np.shape[0]
        if b < self.batch:
            pad = np.zeros((self.batch - b,) + blocks_np.shape[1:], np.uint8)
            blocks_np = np.concatenate([blocks_np, pad])
            lengths_np = np.concatenate(
                [lengths_np, np.zeros(self.batch - b, np.int32)])
        blocks = torch.from_numpy(blocks_np).to(self.device)
        lengths = torch.from_numpy(lengths_np).to(self.device)
        return b, lengths_np, self._pipeline()(blocks, lengths)

    def collect_batch(self, handle):
        """Wait for a submitted batch; returns per block (sequences, the
        device's sections or None): claims at levels 1-4 and coalesced
        sequences at 5-12 with host entropy; with device entropy the
        sequences' literal and match lengths (offsets are only in the
        section, zeros here) and (literals section or None, Sequences_
        Section), which is None for a block with no sequences (the host
        encodes that one); the literals section is the device's in full
        mode where it took the block's literals and the sequences span the
        block (tpu_codec.finish_block_host's check), else None. (None,
        None) for a block whose device output overflowed."""
        b, lengths, result = handle
        self._count(device_blocks=b)
        if self.device_entropy:
            return self._collect_sections(b, lengths, result)
        seqs = self.host_sequences(result, lengths)[:b]
        self._count(overflow_blocks=sum(s is None for s in seqs))
        return [(s, None) for s in seqs]

    def host_sequences(self, result, lengths: np.ndarray
                       ) -> list[BlockSequences | None]:
        """Each row of a host-entropy device output (rows of `lengths`
        bytes) as sequences: claims at levels 1-4, coalesced sequences at
        5-12, None for a row whose device output overflowed."""
        if self.params.matcher == "hash":
            words = result.cpu().numpy().view(np.uint32)
            per_block = match_pipeline.unpack_segments(
                words, len(lengths), self.params.window)
            return [device_positions_to_claims(p, o, lengths[i])
                    for i, (p, o) in enumerate(per_block)]
        out = match_pipeline.unpack_outputs(result.cpu().numpy())
        return [device_outputs_to_sequences(out, i)
                for i in range(len(lengths))]

    def _collect_sections(self, b: int, lengths: np.ndarray, result):
        packed, words, bits, sec_over, plan, lits = result
        out = match_pipeline.unpack_outputs_wide(packed.cpu().numpy())
        words = words.cpu().numpy()
        bits = bits.cpu().numpy()
        sec_over = sec_over.cpu().numpy()
        plan = {k: v.cpu().numpy() for k, v in plan.items()}
        if lits is not None:
            lits = {k: v.cpu().numpy() for k, v in lits.items()}
            lits["words"] = lits["words"].reshape(len(words), 4, -1)
            lits["bits"] = lits["bits"].reshape(len(words), 4)
        res = []
        counts = {"overflow_blocks": 0, "section_blocks": 0,
                  "literal_blocks": 0}
        for i in range(b):
            if out["overflow"][i] or sec_over[i]:
                counts["overflow_blocks"] += 1
                res.append((None, None))
                continue
            ns = int(out["nseq"][i])
            seqs = BlockSequences(out["lit_len"][i, :ns],
                                  np.zeros(ns, np.int64),
                                  out["match_len"][i, :ns],
                                  int(out["last_literals"][i]))
            if ns == 0:
                res.append((seqs, None))
                continue
            counts["section_blocks"] += 1
            lit_sec = None
            if lits is not None and lits["ok"][i] \
                    and seqs.total_span() == lengths[i]:
                lit_sec = device_literals_section(
                    lits["nb_bits"][i], lits["codes"][i],
                    lits["max_bits"][i], lits["last_symbol"][i],
                    int(lits["n_lit"][i]), lits["words"][i],
                    lits["bits"][i])
                counts["literal_blocks"] += lit_sec is not None
            res.append((seqs, (lit_sec, device_sequence_section(
                ns, words[i], int(bits[i]), plan, i))))
        self._count(**counts)
        return res

    def produce_sequences(self, blocks_np: np.ndarray,
                          lengths_np: np.ndarray
                          ) -> list[BlockSequences | None]:
        """One batch through the device half and back, keeping only the
        sequences (tpu_codec.TpuCodec.produce_sequences): the claims at
        levels 1-4, the coalesced sequences at 5-12, None for a block
        whose device output overflowed."""
        return [s for s, _ in
                self.collect_batch(self.submit_batch(blocks_np, lengths_np))]

    def compress(self, data: bytes | np.ndarray,
                 checksum: bool | None = None,
                 validate: bool = False) -> bytes:
        """One zstd frame of `data`. validate=True checks each block's
        final sequences with format.validate_sequences before the entropy
        coder (the reference's compressAndVerify): every host-entropy
        block after its extension pass, and the host-matched tail and
        overflow blocks; a block whose sections the device encoded is
        final and not checked, as in the reference. A failed check raises
        AssertionError."""
        if checksum is None:
            checksum = self.checksum_default
        buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
            data, np.ndarray) else np.ascontiguousarray(data, np.uint8)
        bodies = self.compress_bodies(buf, validate=validate)
        return assemble_frame(buf, bodies, self.block_size, checksum,
                              window_log=self.host.window_log)

    def finish_block_host(self, buf: np.ndarray, i: int,
                          seqs: BlockSequences | None,
                          section: tuple[bytes | None, bytes] | None = None,
                          frame_start: bool = True, *,
                          validate: bool = False) -> bytes | None:
        """Host half of block i of the whole frame buffer `buf`: with the
        device's sections (literals section or None, Sequences_Section),
        the two joined, or the host's literals section before the
        device's Sequences_Section; without them the deep selector's
        chain parse, or extension plus gap fill, of the device sequences;
        or, for seqs None (the tail block, an overflowed block), the host
        matcher; then the entropy coder. None => raw. Block 0 starts the
        frame's repeat-offset history unless frame_start is False (a
        stream's later chunks). With the config's second_parse, a deep
        level skips the selector and keeps the smaller of that body and
        the host chain parse's. validate checks the sequences that reach
        the entropy coder first (see compress)."""
        n = len(buf)
        bs = self.block_size
        gp = self.host
        # Cross-block context: matchers that discover offsets get
        # ctx <= window - block so every find stays inside the frame
        # window; the extension pass only verifies device offsets and may
        # see the full window (LDM claims reach (window - block, window]).
        win = 1 << gp.window_log
        blk = buf[i * bs:min((i + 1) * bs, n)]
        if len(blk) < 64:
            return None
        ctx = min(i * bs, win)
        ctx_find = min(i * bs, max(0, win - bs))
        cblk = buf[i * bs - ctx:min((i + 1) * bs, n)]
        if section is not None:
            # Device entropy: the sections are final; no extension.
            lit_sec, seq_sec = section
            if lit_sec is not None:
                return lit_sec + seq_sec
            return native.block_body_external_seqsec(
                blk, seqs.lit_lengths, seqs.match_lengths,
                seqs.last_literals, seq_sec, self.params.huffman)
        second = self.level >= 5 and config.get().second_parse
        deep_hinted = False
        if seqs is not None and seqs.nseq and self.level >= 5 \
                and not second:
            share = float(seqs.lit_lengths.sum()
                          + seqs.last_literals) / len(blk)
            deep_hinted = deep_parse_pick(self.level, share, ctx_find, bs)
        if deep_hinted:
            hpos = (np.cumsum(seqs.lit_lengths + seqs.match_lengths)
                    - seqs.match_lengths)
            seqs = BlockSequences(*native.find_sequences_hinted(
                cblk[ctx - ctx_find:], gp.chain_depth, gp.lazy, hpos,
                seqs.match_lengths, seqs.offsets, ctx_len=ctx_find,
                mml=gp.mml))
        elif seqs is not None and seqs.nseq:
            ll, of, ml, lastlit = native.extend_sequences(
                cblk, seqs.lit_lengths, seqs.offsets, seqs.match_lengths,
                seqs.last_literals, ctx_len=ctx, max_off=win)
            # Re-match the literal runs left behind against the whole
            # block and the window context; the hash levels scan with the
            # extension walk's relaxed economics and a deeper chain.
            fast = self.params.matcher == "hash"
            seqs = BlockSequences(*native.fill_gaps(
                cblk[ctx - ctx_find:], ll, of, ml, lastlit,
                ctx_len=ctx_find,
                chain_depth=max(gp.chain_depth, 8 if fast else 16),
                mml=gp.mml, min_gap=4, relaxed=fast))

        def host_parse() -> BlockSequences:
            return BlockSequences(*native.find_sequences(
                cblk[ctx - ctx_find:], gp.chain_depth, gp.lazy,
                ctx_len=ctx_find, mml=gp.mml))

        def body_of(s: BlockSequences) -> bytes | None:
            if validate:
                validate_sequences(cblk, s, ctx_len=ctx)
            return native.block_body(
                blk, s.lit_lengths, s.offsets, s.match_lengths,
                s.last_literals, self.params.custom_tables
                and gp.custom_tables, self.params.huffman,
                first_block=frame_start and i == 0)

        if seqs is None:
            try:
                return body_of(host_parse())
            except OverflowError:
                return None
        body = body_of(seqs)
        if second:
            # The best-of-two (QZ_SECOND_PARSE=1, tpu_codec's opt-in): the
            # host chain parse as well, the smaller body kept; its
            # overflow keeps the first.
            try:
                alt = body_of(host_parse())
            except OverflowError:
                return body
            if alt is not None and (body is None or len(alt) < len(body)):
                return alt
        return body

    def compress_bodies(self, buf: np.ndarray, frame_start: bool = True,
                        *, validate: bool = False) -> list[bytes | None]:
        """Per-block Compressed_Block bodies (None => raw block); buf's
        first block starts the frame unless frame_start is False;
        validate as in compress.

        The full blocks go to the device in batches, QUEUE_DEPTH batches
        in flight while earlier ones are collected and finished on a host
        thread pool, and a device error is logged (utils/logging, level
        1, where TpuCodec logs its CPU fallback) and raised where it
        happens. The short tail block is matched on the host."""
        buf = np.ascontiguousarray(buf, np.uint8)
        n = len(buf)
        bs = self.block_size
        nblocks = max(1, -(-n // bs))
        nfull = n // bs

        def finish_block(i: int, seqs, section=None) -> bytes | None:
            with Timer() as tm:
                body = self.finish_block_host(buf, i, seqs, section,
                                              frame_start, validate=validate)
            self.stats.record(min(n - i * bs, bs),
                              len(body) if body else None, tm.elapsed)
            return body

        futures: dict[int, object] = {}
        inflight: list[tuple[range, object]] = []
        with ThreadPoolExecutor() as pool:

            def collect_one() -> None:
                ids, handle = inflight.pop(0)
                try:
                    got = self.collect_batch(handle)
                except Exception as e:
                    _batch_failed(e, "collect", len(ids))
                    raise
                for i, (sq, sec) in zip(ids, got):
                    futures[i] = pool.submit(finish_block, i, sq, sec)

            for s in range(0, nfull, self.batch):
                ids = range(s, min(s + self.batch, nfull))
                blocks_np = buf[s * bs:ids.stop * bs] \
                    .reshape(len(ids), bs).copy()
                lengths_np = np.full(len(ids), bs, np.int32)
                try:
                    handle = self.submit_batch(blocks_np, lengths_np)
                except Exception as e:
                    _batch_failed(e, "submit", len(ids))
                    raise
                inflight.append((ids, handle))
                if len(inflight) >= QUEUE_DEPTH:
                    collect_one()
            for i in range(nfull, nblocks):  # the short tail block
                futures[i] = pool.submit(finish_block, i, None)
            while inflight:
                collect_one()
            return [futures[i].result() for i in range(nblocks)]
