"""Match-finding entry points of the port and the host unpack of their
output.

Port of three contracts of qat_zstd_plugin_tpu.ops.match_pipeline:

* segment slots, levels 1-4 (`find_matches_positions`,
  `unpack_segments`): the hash matcher's claim positions;
* packed sequences, levels 5-12 (`find_matches_packed`,
  `unpack_outputs`): the exact-LCP content matcher.
  `candidates` carries the content words through a gram sort for exact
  match lengths up to 16 bytes, `glue_kernels.merge_ldm` folds in the
  long-distance claims, `parse_kernel.parse_greedy` (B10) picks the
  matches, `compact` packs them per block and `pack_outputs` puts every
  field into one array; `find_matches_staged` returns compact's dict.
  With matcher="hash" the same contract comes from the hash matcher
  (glue_kernels.find_matches_hash_split);
* device entropy, levels 1-12 (`find_matches_with_seqsec_hash`,
  `find_matches_with_seqsec`, `unpack_outputs_wide`): the coalesced
  sequences' literal and match lengths (`pack_wide`) beside each block's
  finished FSE sequence-section stream (ops/fse_kernel.py), and in full
  mode each block's Huffman literal streams (ops/literals_kernel.py).

The reference module imports jax at the top, so its numpy unpacks are
repeated here rather than imported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fse_kernel, glue_kernels, literals_kernel, parse_kernel
from .glue_kernels import MIN_MATCH, _shr

LCP_CAP = 16
BIG = 1 << 30
MAX_LEN = 65535  # the packed (lit << 16 | ml) word's field limit


def find_matches_positions(blocks: torch.Tensor, lengths: torch.Tensor,
                           widths: tuple = (6,), neighbors: int = 1,
                           window: int = 32768, ldm: int = 0,
                           ldm_max_off: int = 1 << 19, dense: bool = True,
                           sync: bool = False, lazy: bool = False,
                           psegs: int = 1) -> torch.Tensor:
    """Hash-matcher pipeline of levels 1-4, segment-slots contract (see
    glue_kernels.find_matches_positions; `lazy` and `psegs` are the parsed
    branch's one-step lazy parse and parse segments).
    LDM spans tile the batch, so a batch that is not a whole number of
    spans runs without LDM."""
    if ldm and blocks.shape[0] % ldm:
        ldm = 0  # spans need whole block groups; partial batches skip LDM
    return glue_kernels.find_matches_positions(
        blocks, lengths, widths=tuple(widths), neighbors=neighbors,
        window=window, ldm=ldm, ldm_max_off=ldm_max_off, dense=dense,
        sync=sync, lazy=lazy, psegs=psegs)


def unpack_segments(slot_keys: np.ndarray, nblocks: int, window: int
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Host-side unpack of the segment-slots contract.

    slot_keys: (nblocks*nseg, w/4) u32; slot i of a row holds that 4-byte
    slot's claim as (subslot_k << 30 | byte_offset), the claim position
    being 4*i + k, or the empty sentinel 0xFFFFFFFF. Slot index is
    position order and segments tile the block, so a row-major
    mask-select yields claims in block-position order. Returns per block
    (positions, offsets)."""
    sk = np.asarray(slot_keys)
    R, ws = sk.shape
    nseg = R // nblocks
    w = ws * 4
    rows, cols = np.nonzero(sk != np.uint32(0xFFFFFFFF))
    vals = sk[rows, cols]
    pos = (cols.astype(np.int64) * 4 + (vals >> 30)
           + (rows.astype(np.int64) % nseg) * w)
    off = (vals & 0x3FFFFFFF).astype(np.int64)
    counts = np.bincount(rows // nseg, minlength=nblocks)
    splits = np.cumsum(counts)[:-1]
    return list(zip(np.split(pos, splits), np.split(off, splits)))


# ---------------------------------------------------------------------------
# The content matcher (levels 5-12)
# ---------------------------------------------------------------------------

def _lcp_word(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Leading equal bytes (0..4) of two big-endian-packed int32 words.
    0xFF000000 - (1 << 32) is that mask's int32 bit pattern."""
    xor = x ^ y
    n0 = (xor & (0xFF000000 - (1 << 32))) == 0
    n1 = n0 & ((xor & 0x00FF0000) == 0)
    n2 = n1 & ((xor & 0x0000FF00) == 0)
    n3 = n2 & ((xor & 0x000000FF) == 0)
    return (n0.to(torch.int32) + n1.to(torch.int32) + n2.to(torch.int32)
            + n3.to(torch.int32))


def _grams(blocks: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Big-endian 4-byte grams at t, t+4, t+8, t+12 (zero-padded tail) as
    int32 bit patterns: a byte >= 0x80 on top makes a gram negative."""
    B, N = blocks.shape
    xp = torch.cat([blocks.to(torch.int64),
                    torch.zeros((B, LCP_CAP), dtype=torch.int64,
                                device=blocks.device)], dim=1)

    def word(s: int) -> torch.Tensor:
        w = ((xp[:, s:s + N] << 24) | (xp[:, s + 1:s + 1 + N] << 16)
             | (xp[:, s + 2:s + 2 + N] << 8) | xp[:, s + 3:s + 3 + N])
        return glue_kernels._i32(w)

    return word(0), word(4), word(8), word(12)


def candidates(blocks: torch.Tensor, lengths: torch.Tensor,
               neighbors: int = 4, stride: int = 1,
               window: int = 1 << 30) -> tuple[torch.Tensor, torch.Tensor]:
    """Best (match_len, offset) candidate per position (reference:
    match_pipeline.candidates, XLA there and torch ops here).

    blocks (B, N) uint8, lengths (B,) int32 -> (mlen, moff), (B, N) int32
    each; mlen == 0 where no candidate. A stable sort by the signed first
    gram, position breaking ties, groups equal grams in position order, so
    the k-th sorted predecessor in a group is the k-th most recent earlier
    occurrence; the carried words give the exact common prefix up to 16
    bytes, longer and then nearer wins. stride > 1 takes anchors at
    multiples of stride only (zeros between them); window < N sorts each
    window-wide segment apart, positions segment-local, so no match
    crosses a segment (N % window == 0, window % stride == 0). Offset-1
    runs get exact lengths up to 65535 at every position, across
    segments."""
    B, N = blocks.shape
    if stride < 1 or (window < N and (N % window or window % stride)):
        raise ValueError(f"candidates: block length {N}, window {window} "
                         f"and stride {stride} do not tile")
    dev = blocks.device
    grams = _grams(blocks)
    pos = torch.arange(N, device=dev)
    if stride > 1:
        grams = tuple(g[:, ::stride] for g in grams)
        pos = pos[::stride]
    blen = lengths.to(torch.int32)[:, None]
    R, L = B, pos.numel()
    if window < N:
        nseg = N // window
        R, L = B * nseg, window // stride
        grams = tuple(g.reshape(R, L) for g in grams)
        seg_start = (torch.arange(R, device=dev) % nseg) * window
        pos = pos.reshape(nseg, L).repeat(B, 1) - seg_start[:, None]
        blen = (blen.repeat_interleave(nseg, 0) - seg_start[:, None]) \
            .clamp(0, window).to(torch.int32)
    else:
        pos = pos.expand(R, L)
    g0, g1, g2, g3 = grams
    # (g0 << 17 | column) orders as the stable sort on g0 does (positions
    # rise along a row), and is unique per row (column < 2^17), so any
    # sort gives that order.
    col = torch.arange(L, device=dev)
    order = torch.sort((g0.to(torch.int64) << 17) | col, dim=1).indices
    sk = g0.gather(1, order)
    sp = pos.gather(1, order).to(torch.int32)
    s1, s2, s3 = (g.gather(1, order) for g in (g1, g2, g3))
    best = torch.zeros((R, L), dtype=torch.int32, device=dev)
    for k in range(1, neighbors + 1):
        pk = _shr(sp, k, BIG)
        p1, p2, p3 = (_shr(s, k, 0) for s in (s1, s2, s3))
        f1 = s1 == p1
        f2 = s2 == p2
        lcp = (4 + _lcp_word(s1, p1)
               + torch.where(f1, _lcp_word(s2, p2), 0)
               + torch.where(f1 & f2, _lcp_word(s3, p3), 0))
        lcp = torch.minimum(lcp, blen - sp)  # stay inside the block
        valid = (sk == _shr(sk, k, 0)) & (pk < sp) & (lcp >= MIN_MATCH)
        # Longer first, then the nearest source (capped long matches chain
        # at a constant offset for the host coalesce).
        best = torch.maximum(best, torch.where(valid, (lcp << 18) | pk, 0))
    cand_len = best >> 18
    cand_off = torch.where(cand_len > 0, sp - (best & ((1 << 18) - 1)), 0)
    # Cost model: short matches only near (match_pipeline.candidates).
    worth = ((cand_len >= 7)
             | ((cand_len >= 6) & (cand_off <= 32768))
             | ((cand_len >= 5) & (cand_off <= 4096))
             | ((cand_len >= 4) & (cand_off <= 256)))
    packed = torch.where(worth, (cand_len << 17) | cand_off, 0)
    # Un-sort: scatter back to position order, then to the block's grid.
    pc = torch.empty_like(packed).scatter_(1, order, packed).reshape(B, -1)
    if stride > 1:
        pc = torch.nn.functional.pad(pc[:, :, None], (0, stride - 1)) \
            .reshape(B, N)
    mlen = pc >> 17
    moff = pc & ((1 << 17) - 1)

    # Offset-1 runs: exact lengths from the next byte change (the row's
    # last byte always counts as one), capped at 65535.
    blen = lengths.to(torch.int32)[:, None]
    x = blocks.to(torch.int32)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    chg = torch.ones((B, N), dtype=torch.bool, device=dev)
    chg[:, :-1] = x[:, :-1] != x[:, 1:]
    big = torch.full_like(x, BIG)
    run_end = torch.where(chg, idx, big).flip(1).cummin(1).values.flip(1)
    len1 = torch.minimum(run_end - idx + 1, blen - idx).clamp(max=MAX_LEN)
    prev_eq = torch.zeros((B, N), dtype=torch.bool, device=dev)
    prev_eq[:, 1:] = x[:, 1:] == x[:, :-1]
    use1 = prev_eq & (len1 >= MIN_MATCH) & (len1 > mlen)
    return torch.where(use1, len1, mlen), torch.where(use1, 1, moff)


def _to_front(keep: torch.Tensor, width: int, *planes: torch.Tensor):
    """Per row, the entries where `keep` is set, in order, scattered to the
    front of `width` columns (the rest zero): each kept entry goes to its
    rank, a running count. This is the order of the reference's sort of
    the kept entries' indices to the front; entries past `width` drop."""
    B = keep.shape[0]
    rank = keep.to(torch.int64).cumsum(1) - 1
    slot = torch.where(keep & (rank < width), rank, width)
    out = []
    for p in planes:
        o = torch.zeros((B, width + 1), dtype=p.dtype, device=p.device)
        o.scatter_(1, slot, p)
        out.append(o[:, :width])
    return out


def _segmented_sum(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along dim 1 that restarts at each start (reference:
    match_pipeline._segmented_sum, an associative scan there): the running
    sum less its value just before the latest start."""
    cs = vals.to(torch.int64).cumsum(1)
    idx = torch.arange(vals.shape[1], device=vals.device).expand_as(cs)
    last = torch.where(starts, idx, -1).cummax(1).values
    before = (cs - vals).gather(1, last.clamp(min=0))
    return torch.where(last >= 0, cs - before, cs)


def _coalesce(lit, off, ml, valid, nseq):
    """Merge chains of capped matches on the device (reference: compact's
    coalesce branch): a zero-literal successor with the same offset
    extends the previous match; each group's summed literal run and
    match length move to the front, in order. Returns (lit, off, ml,
    nseq), int64."""
    B, S = lit.shape
    srow = torch.arange(S, device=lit.device)[None, :]
    prev_off = torch.zeros_like(off)
    prev_off[:, 1:] = off[:, :-1]
    same = valid & (lit == 0) & (off == prev_off) & (srow > 0)
    start = valid & ~same
    seg_lit = _segmented_sum(lit, start)  # == lit at the group's start
    seg_ml = _segmented_sum(ml, start)
    nxt_start = torch.ones_like(start)
    nxt_start[:, :-1] = start[:, 1:]
    # The row after the last valid one is no start: close the last group.
    is_end = valid & (nxt_start | (srow == nseq[:, None] - 1))
    lit, off, ml = _to_front(is_end, S, seg_lit, off, seg_ml)
    return lit, off, ml, start.sum(1)


def compact(chosen: torch.Tensor, mlen: torch.Tensor, moff: torch.Tensor,
            lengths: torch.Tensor, max_seq: int, window: int = 1 << 30,
            coalesce: bool = False):
    """Pack the chosen matches into per-block sequence arrays (reference:
    match_pipeline.compact). Returns a dict of lit_len, offset, match_len
    (B, max_seq) int32, nseq, last_literals (B,) int32 and overflow (B,)
    bool; a block with more than min(max_seq, N) matches sets overflow
    (counted before coalescing; nseq after it).

    The reference sorts the chosen positions to the front, per block or,
    with window < N, per window-wide segment and then across segments
    with the match length and offset packed into one payload word (ml <<
    15 | off). Here each chosen position goes to its rank, which is the
    same order on both branches: the parse puts chosen positions >= 4
    apart, so a segment never holds more than window / 4 of them, and the
    payload is lossless because every caller's lengths stay below 2^17
    and its offsets below 2^15 (the verified hash path's: 16383 and
    32767). coalesce=True merges chains of capped matches as the host's
    coalesce_sequences does (see _coalesce)."""
    B, N = chosen.shape
    if window < N and (N % window or window > 32768):
        raise ValueError(f"compact: block length {N} must be a multiple of "
                         f"a segment width {window} <= 32768")
    dev = chosen.device
    req_seq = max_seq
    max_seq = min(max_seq, N)
    idx = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    t2, l2, o2 = _to_front(chosen, max_seq, idx, mlen, moff)
    nseq = chosen.sum(1).to(torch.int32)
    valid = torch.arange(max_seq, device=dev)[None, :] < nseq[:, None]
    end = t2 + l2
    prev_end = torch.zeros_like(end)
    prev_end[:, 1:] = end[:, :-1]
    lit = torch.where(valid, t2 - prev_end, 0)
    ml = torch.where(valid, l2, 0)
    off = torch.where(valid, o2, 0)
    last_end = torch.where(valid, end, 0).amax(1)
    overflow = nseq > max_seq
    if coalesce:
        lit, off, ml, nseq = (a.to(torch.int32) for a in _coalesce(
            lit, off, ml, valid, nseq))
    if req_seq > max_seq:
        pad = (0, req_seq - max_seq)
        lit, off, ml = (torch.nn.functional.pad(a, pad)
                        for a in (lit, off, ml))
    return {
        "lit_len": lit, "offset": off, "match_len": ml,
        "nseq": torch.clamp(nseq, max=max_seq),
        "last_literals": lengths.to(torch.int32) - last_end,
        "overflow": overflow,
    }


def pack_outputs(out: dict, max_seq: int) -> torch.Tensor:
    """All compaction outputs in ONE (B, max_seq+1, 2) int32 array, one
    device-to-host copy (reference: match_pipeline.pack_outputs):
      row 0:   [nseq, last_literals << 1 | overflow]
      row s+1: [lit_len << 16 | match_len, offset]
    Match lengths are capped at 65535 (longer ones continue as chained
    same-offset sequences that the host coalesce merges); a literal run
    longer than 65535 sets overflow."""
    lit = out["lit_len"].to(torch.int64)
    ml = out["match_len"].to(torch.int64).clamp(max=MAX_LEN)
    overflow = out["overflow"] | (lit > MAX_LEN).any(1)
    word0 = glue_kernels._i32((lit.clamp(max=MAX_LEN) << 16) | ml)
    body = torch.stack([word0, out["offset"]], dim=-1)
    hdr1 = (out["last_literals"] << 1) | overflow.to(torch.int32)
    hdr = torch.stack([out["nseq"], hdr1], dim=-1)[:, None, :]
    return torch.cat([hdr, body], dim=1)


def find_matches_staged(blocks: torch.Tensor, lengths: torch.Tensor,
                        neighbors: int = 4, max_seq: int = 16384,
                        lazy: bool = False, stride: int = 1,
                        window: int = 1 << 30) -> dict:
    """The content pipeline without LDM or packing: candidates -> the
    parse (B10) -> compact, returning compact's dict. Port of the
    reference's find_matches_staged (a jit a stage there) and, at stride
    1, of its find_matches_batch (one jit)."""
    mlen, moff = candidates(blocks, lengths, neighbors, stride, window)
    chosen = parse_kernel.parse_greedy(mlen, lazy)
    return compact(chosen, mlen, moff, lengths, max_seq, window)


def find_matches_packed(blocks: torch.Tensor, lengths: torch.Tensor,
                        neighbors: int = 4, max_seq: int = 16384,
                        lazy: bool = False, stride: int = 1,
                        window: int = 1 << 30, ldm: int = 0,
                        ldm_max_off: int = 1 << 18, matcher: str = "content",
                        widths: tuple = (4, 8)) -> torch.Tensor:
    """The packed-sequences contract: (B, N) uint8 blocks and (B,) int32
    lengths -> (B, max_seq+1, 2) int32 (see pack_outputs). Port of the
    reference's find_matches_packed / find_matches_fused.
    matcher="content" (levels 5-12): content_candidates (with LDM the
    minimizer plane B9 -> ldm_unsorted K3, K2 -> merge_ldm), the parse
    (B10), compact. matcher="hash": glue_kernels.find_matches_hash_split
    (B5, K2, B7, B10, B18), which the reference's "hash" and "hash_glue"
    both compute."""
    if matcher == "hash":
        return glue_kernels.find_matches_hash_split(
            blocks, lengths, widths=tuple(widths), neighbors=neighbors,
            window=window, max_seq=max_seq, lazy=lazy)
    if matcher != "content":
        raise ValueError(f"unknown matcher {matcher!r}")
    mlen, moff = content_candidates(blocks, lengths, neighbors, stride,
                                    window, ldm, ldm_max_off)
    chosen = parse_kernel.parse_greedy(mlen, lazy)
    return pack_outputs(compact(chosen, mlen, moff, lengths, max_seq,
                                window), max_seq)


def content_candidates(blocks: torch.Tensor, lengths: torch.Tensor,
                       neighbors: int = 4, stride: int = 1,
                       window: int = 1 << 30, ldm: int = 0,
                       ldm_max_off: int = 1 << 18):
    """The (mlen, moff) planes the content path's parse reads: candidates,
    with the LDM claims merged in when the batch is a whole number of
    `ldm`-block spans."""
    if ldm and blocks.shape[0] % ldm:
        ldm = 0  # spans need whole block groups; partial batches skip LDM
    mlen, moff = candidates(blocks, lengths, neighbors, stride, window)
    if ldm:
        # (1 << 18) - 1: an offset of 2^18 would not fit the reference's
        # segmented payload; the bound is kept so the claims are equal.
        max_off = min(ldm_max_off, (1 << 18) - 1)
        minz = glue_kernels.ldm_winmin(
            blocks, glue_kernels.ldm_stride(ldm, blocks.shape[1]))
        su_l = glue_kernels.ldm_unsorted(minz, ldm, neighbors=1)
        mlen, moff = glue_kernels.merge_ldm(mlen, moff, su_l, lengths, ldm,
                                            local_cap=LCP_CAP,
                                            max_off=max_off)
        if window < blocks.shape[1]:
            # The reference's segmented compact packs (ml << 18 | off)
            # with LDM, so it caps the lengths it parses at 16383.
            mlen = mlen.clamp(max=16383)
    return mlen, moff


# ---------------------------------------------------------------------------
# Device entropy: the device emits each block's final FSE
# Sequences_Section; in hybrid mode the host adds the literals section,
# in full mode the device also encodes the Huffman literals.
# ---------------------------------------------------------------------------

SEQ_WORDS = 8192  # u32 words of a block's section stream (262144 bits)


def pack_wide(out: dict) -> torch.Tensor:
    """The coalesced compaction in one (B, max_seq+1, 2) int32 array for
    the host (reference: match_pipeline._pack_wide_jit): row 0 [nseq,
    last_literals << 1 | overflow], row s+1 [lit_len, match_len]. The
    offsets stay on the device: the section holds them."""
    hdr1 = (out["last_literals"] << 1) | out["overflow"].to(torch.int32)
    hdr = torch.stack([out["nseq"], hdr1], dim=-1)[:, None, :]
    body = torch.stack([out["lit_len"], out["match_len"]], dim=-1)
    return torch.cat([hdr, body], dim=1)


def unpack_outputs_wide(packed: np.ndarray) -> dict:
    """Host-side unpack of pack_wide (numpy)."""
    packed = np.asarray(packed)
    hdr = packed[:, 0, :]
    return {
        "nseq": hdr[:, 0],
        "last_literals": (hdr[:, 1] >> 1).astype(np.int64),
        "overflow": (hdr[:, 1] & 1).astype(bool),
        "lit_len": packed[:, 1:, 0].astype(np.int64),
        "match_len": packed[:, 1:, 1].astype(np.int64),
    }


def sections(out: dict, seq_words: int = SEQ_WORDS,
             custom_tables: bool = True):
    """The hybrid device half's second stage: the coalesced compaction
    `out` (compact(..., coalesce=True)) -> (packed (B, max_seq+1, 2) int32
    (see pack_wide), words (B, seq_words) int32, bits (B,) int32,
    sec_over (B,) bool, plan), the FSE sequence sections of
    fse_kernel.encode_sequence_sections (B14)."""
    words, bits, sec_over, plan = fse_kernel.encode_sequence_sections(
        out["lit_len"], out["offset"], out["match_len"], out["nseq"],
        max_words=seq_words, custom=custom_tables)
    return pack_wide(out), words, bits, sec_over, plan


def verified_sequences(blocks: torch.Tensor, lengths: torch.Tensor,
                       neighbors: int = 2, max_seq: int = 16384,
                       lazy: bool = False, window: int = 32768):
    """The first stage at levels 1-4: the byte-verified matcher
    (glue_kernels.candidates_hash_verified: B11, B12, B13), the parse
    (B10) and the segmented compaction with coalesce. Returns (the
    compaction's dict, chosen (B, N) bool, mlen (B, N) int32): the
    literals stage reads the parse."""
    mlen, moff = glue_kernels.candidates_hash_verified(
        blocks, lengths, neighbors=neighbors, window=window)
    chosen = parse_kernel.parse_greedy(mlen, lazy)
    return compact(chosen, mlen, moff, lengths, max_seq, window,
                   coalesce=True), chosen, mlen


def content_sequences(blocks: torch.Tensor, lengths: torch.Tensor,
                      neighbors: int = 4, max_seq: int = 16384,
                      lazy: bool = False, stride: int = 1,
                      window: int = 1 << 30):
    """The first stage at levels 5-12: the exact-LCP candidates with no
    LDM, the parse (B10) with the level's lazy and the compaction with
    coalesce (unsegmented: window >= N at every content level). Returns
    (the compaction's dict, chosen, mlen), as verified_sequences."""
    mlen, moff = candidates(blocks, lengths, neighbors, stride, window)
    chosen = parse_kernel.parse_greedy(mlen, lazy)
    return compact(chosen, mlen, moff, lengths, max_seq, window,
                   coalesce=True), chosen, mlen


def _with_sections(blocks, lengths, first, seq_words: int,
                   custom_tables: bool, device_literals: bool):
    """sections of the first stage's compaction, then with
    device_literals the literals dict (literals_kernel.
    encode_literals_device of the first stage's parse), else None."""
    out, chosen, mlen = first
    lits = None
    if device_literals:
        lits = literals_kernel.encode_literals_device(blocks, lengths, chosen,
                                                      mlen)
    return (*sections(out, seq_words, custom_tables), lits)


def find_matches_with_seqsec_hash(blocks: torch.Tensor, lengths: torch.Tensor,
                                  neighbors: int = 2, max_seq: int = 16384,
                                  lazy: bool = False, window: int = 32768,
                                  seq_words: int = SEQ_WORDS,
                                  custom_tables: bool = True,
                                  device_literals: bool = True):
    """Device entropy at levels 1-4 (reference:
    match_pipeline.find_matches_with_seqsec_hash): verified_sequences,
    then sections, then with device_literals (full device entropy) the
    Huffman literals. Returns (packed, words, bits, sec_over, plan, lits),
    lits None without device_literals."""
    return _with_sections(
        blocks, lengths, verified_sequences(blocks, lengths, neighbors,
                                            max_seq, lazy, window),
        seq_words, custom_tables, device_literals)


def find_matches_with_seqsec(blocks: torch.Tensor, lengths: torch.Tensor,
                             neighbors: int = 4, max_seq: int = 16384,
                             lazy: bool = False, seq_words: int = SEQ_WORDS,
                             stride: int = 1, window: int = 1 << 30,
                             custom_tables: bool = True,
                             device_literals: bool = True):
    """Device entropy at levels 5-12 (reference:
    match_pipeline.find_matches_with_seqsec): content_sequences, then as
    find_matches_with_seqsec_hash."""
    return _with_sections(
        blocks, lengths, content_sequences(blocks, lengths, neighbors,
                                           max_seq, lazy, stride, window),
        seq_words, custom_tables, device_literals)


def unpack_outputs(packed: np.ndarray) -> dict:
    """Host-side unpack of pack_outputs (numpy)."""
    packed = np.asarray(packed)
    hdr = packed[:, 0, :]
    word0 = packed[:, 1:, 0].astype(np.int64) & 0xFFFFFFFF
    return {
        "nseq": hdr[:, 0],
        "last_literals": (hdr[:, 1] >> 1).astype(np.int64),
        "overflow": (hdr[:, 1] & 1).astype(bool),
        "lit_len": (word0 >> 16).astype(np.int64),
        "match_len": (word0 & 0xFFFF).astype(np.int64),
        "offset": packed[:, 1:, 1].astype(np.int64),
    }
