"""Device FSE sequence sections (hybrid device entropy) in PyTorch, with
B14, the FSE encoder state machine, as a CUDA kernel.

Port of qat_zstd_plugin_tpu.ops.fse_kernel: `encode_sequence_sections`
and what it reaches. For a batch of compacted blocks it computes the
LL/ML/OF codes and extra bits (`_codes`), reverses each block's valid
sequences (FSE encodes backwards), plans per-block tables
(ops/fse_tables.py, or the predefined ones), runs the state machine
(`run_state_kernel`, B14: the kernel in csrc/fse_kernels.cu for a CUDA
tensor, `run_state_kernel_twin` for a CPU one, launches counted in
glue_kernels.launches["fse_state"]), interleaves its state-bit items
with the extras items and packs everything into one backward bitstream
per block with ops/bitconcat.py. The host wraps each stream with the
nbSeq varint, the mode byte and the table descriptions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import fse_format as fmt
from . import bitconcat, fse_tables
from .glue_kernels import _check, _launch, _use_twin

_M32 = 0xFFFFFFFF
_KROWS = {"ll": 64, "of": 32, "ml": 64}  # per-lane symbol rows
_ORDER = ("ll", "of", "ml")
# B14's kernel cuts each block's S+1 steps into pieces of PIECE steps and
# maps every piece from each of a stream's table size + 2 entry states
# (csrc/fse_kernels.cu); MAP_STRIDE bytes hold one map. The entry point
# refuses a PIECE above its kMaxPiece and scratch too small for its
# kMapStride.
PIECE = 64
MAP_STRIDE = 68


def _codes(ll: torch.Tensor, ml: torch.Tensor, ofv: torch.Tensor):
    """Codes and extra bits of (literal length, match length, offset
    value) planes, as the reference's _codes: (ll_code, ml_code,
    of_code, ll_bits, ml_bits, of_bits, ll_extra, ml_extra, of_extra),
    int64; of_bits == of_code."""
    dev = ll.device
    ll_base = torch.tensor(fmt.LL_BASELINES, dtype=torch.int64, device=dev)
    ml_base = torch.tensor(fmt.ML_BASELINES, dtype=torch.int64, device=dev)
    ll_nb = torch.tensor(fmt.LL_BITS, dtype=torch.int64, device=dev)
    ml_nb = torch.tensor(fmt.ML_BITS, dtype=torch.int64, device=dev)
    ll_code = torch.where(
        ll < 16, ll, 15 + (ll[..., None] >= ll_base[16:]).sum(-1))
    ml_code = torch.where(
        ml <= 34, ml - 3, 31 + (ml[..., None] >= ml_base[32:]).sum(-1))
    # floor(log2(offset value)) by a 5-step bit reduction.
    v = ofv
    of_code = torch.zeros_like(ofv)
    for shift in (16, 8, 4, 2, 1):
        m = v >= (1 << shift)
        of_code = of_code + torch.where(m, shift, 0)
        v = torch.where(m, v >> shift, v)
    ll_bits = ll_nb[ll_code]
    ml_bits = ml_nb[ml_code]
    return (ll_code, ml_code, of_code, ll_bits, ml_bits, of_code,
            ll - ll_base[ll_code], ml - ml_base[ml_code],
            ofv - (1 << of_code))


def _predef_lane_tables(kind: str, B: int, device) -> tuple:
    """Predefined table content broadcast to per-lane shape: dnb, dfs
    (B, krows) zero-padded, state table (B, size)."""
    al = fse_tables.ALS[kind]
    t = fmt.build_encode_table(fse_tables._DIST[kind], al)
    krows = _KROWS[kind]
    dnb = np.zeros(krows, np.int64)
    dfs = np.zeros(krows, np.int64)
    dnb[:len(t.delta_nb_bits)] = t.delta_nb_bits
    dfs[:len(t.delta_find_state)] = t.delta_find_state
    st = np.asarray(t.state_table, np.int64)
    return tuple(torch.from_numpy(a).to(device).expand(B, len(a))
                 for a in (dnb, dfs, st))


def _init_state_lane(dnb_tbl: torch.Tensor, dfs_tbl: torch.Tensor,
                     st_tbl: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """FSE_initCState2 per block: dnb/dfs (B, K), st (B, size), sym (B,)
    -> (B,) initial states; the table index is clipped to the table."""
    dnb = dnb_tbl.gather(1, sym[:, None])[:, 0]
    dfs = dfs_tbl.gather(1, sym[:, None])[:, 0]
    nb_out = (dnb + (1 << 15)) >> 16
    value = (nb_out << 16) - dnb
    idx = ((value >> nb_out) + dfs).clamp(0, st_tbl.shape[1] - 1)
    return st_tbl.gather(1, idx[:, None])[:, 0]


# ---------------------------------------------------------------------------
# B14 the FSE state machine
# ---------------------------------------------------------------------------

def _check_state_args(codes, tables, inits, nseq) -> tuple[int, int]:
    name = "fse_state"
    if len(codes) != 3 or len(tables) != 3 or len(inits) != 3:
        raise ValueError(f"{name}: three streams (LL, OF, ML) expected")
    S1, B = codes[0].shape
    for c in codes:
        _check(c, name, torch.int32, 2)
        if c.shape != (S1, B):
            raise ValueError(f"{name}: code rows {tuple(c.shape)} != "
                             f"{(S1, B)}")
    for kind, (dnb, dfs, st) in zip(_ORDER, tables):
        size = 1 << fse_tables.ALS[kind]
        for t, rows in ((dnb, _KROWS[kind]), (dfs, _KROWS[kind]),
                        (st, size)):
            _check(t, name, torch.int32, 2)
            if t.shape != (rows, B):
                raise ValueError(f"{name}: {kind} table {tuple(t.shape)} "
                                 f"!= {(rows, B)}")
    for t in (*inits, nseq):
        _check(t, name, torch.int32, 1)
        if t.shape != (B,):
            raise ValueError(f"{name}: per-block vector {tuple(t.shape)} "
                             f"!= {(B,)}")
    return S1, B


def run_state_kernel_twin(codes, tables, inits, nseq):
    """Plain-torch B14 (see run_state_kernel): a Python loop over steps
    with vector ops over blocks. It stops after step max(nseq), the last
    that can write an item; the rows after it stay zero, as the kernel
    writes them."""
    S1, B = codes[0].shape
    dev = codes[0].device
    n = nseq.to(torch.int64)
    lo = torch.zeros((S1, B), dtype=torch.int64, device=dev)
    nb = torch.zeros_like(lo)
    steps = min(S1, int(n.max()) + 1) if B else 0
    cols = torch.arange(B, device=dev)

    def lookup(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """tbl[idx, block], 0 where idx is outside the table (the
        reference's one-hot lookup)."""
        inside = (idx >= 0) & (idx < tbl.shape[0])
        return torch.where(inside, tbl[idx.clamp(0, tbl.shape[0] - 1), cols],
                           0)

    # Per step and stream: the symbol's dnb and dfs (looked up up front).
    sym = []
    for c, (dnb, dfs, st) in zip(codes, tables):
        c64 = c[:steps].to(torch.int64)
        sym.append((lookup(dnb.to(torch.int64), c64),
                    lookup(dfs.to(torch.int64), c64), st.to(torch.int64)))
    s = [i.to(torch.int64) for i in inits]   # LL, OF, ML states
    for j in range(steps):
        active = (j >= 1) & (j < n)
        parts = []
        for k in (1, 2, 0):  # encode order per step: OF, ML, LL
            dnb_j, dfs_j, st = sym[k][0][j], sym[k][1][j], sym[k][2]
            nbk = torch.where(active, (s[k] + dnb_j) >> 16, 0)
            parts.append((s[k] & ((1 << nbk) - 1), nbk))
            nxt = lookup(st, (s[k] >> nbk) + dfs_j)
            s[k] = torch.where(active, nxt, s[k])
        (b_of, n_of), (b_ml, n_ml), (b_ll, n_ll) = parts
        enc_lo = b_of | (b_ml << n_of) | (b_ll << (n_of + n_ml))
        fl_lo = (s[2] & 63) | ((s[1] & 31) << 6) | ((s[0] & 63) << 11)
        flush = j == n
        lo[j] = torch.where(active, enc_lo, torch.where(flush, fl_lo, 0))
        nb[j] = torch.where(active, n_of + n_ml + n_ll,
                            torch.where(flush, 17, 0))
    return lo.to(torch.int32), nb.to(torch.int32)


def run_state_kernel(codes, tables, inits, nseq):
    """B14. The FSE encoder state machine of the LL, OF and ML streams.

    codes: 3 x (S+1, B) int32 reversed codes (LL, OF, ML; steps on rows,
    blocks on columns); tables: per stream (dnb (krows, B), dfs (krows,
    B), state table (size, B)) int32, krows 64/32/64 and size 64/32/64;
    inits: 3 x (B,) int32 initial states; nseq: (B,) int32. Returns
    (lo, nbits), two (S+1, B) int32: step j of a block with 1 <= j < nseq
    encodes OF, ML, then LL state bits (nb = (s + dnb[code]) >> 16 bits of
    s, then s <- st[(s >> nb) + dfs[code]]) as one item, lowest first;
    step nseq is the flush item (ml & 63 | (of & 31) << 6 | (ll & 63) <<
    11 on 17 bits); every other step is an empty item. Port of the Pallas
    kernel _make_state_kernel / _run_state_kernel."""
    S1, B = _check_state_args(codes, tables, inits, nseq)
    if _use_twin(codes[0], "fse_state"):
        return run_state_kernel_twin(codes, tables, inits, nseq)
    dev = codes[0].device
    lo = torch.empty((S1, B), dtype=torch.int32, device=dev)
    nb = torch.empty_like(lo)
    pieces = -(-S1 // PIECE)
    maps = torch.empty(B * 3 * pieces * MAP_STRIDE, dtype=torch.uint8,
                       device=dev)
    entries = torch.empty(B * 3 * pieces, dtype=torch.uint8, device=dev)
    _launch("fse_state", *codes, *(t for tb in tables for t in tb), *inits,
            nseq, lo, nb, maps, entries, S1, B, PIECE, pieces, maps.numel(),
            entries.numel())
    return lo, nb


def encode_sequence_sections(lit_len: torch.Tensor, offset: torch.Tensor,
                             match_len: torch.Tensor, nseq: torch.Tensor,
                             max_words: int = 8192, custom: bool = False):
    """Device FSE sequence sections for a batch of blocks.

    lit_len/offset/match_len (B, S) int32 (rows < nseq valid), nseq (B,).
    Returns (words (B, max_words) int32, total_bits (B,) int32, overflow
    (B,) bool, plan); with custom=True plan holds "use_ll/of/ml" (B,)
    bools and "norm_ll/of/ml" (B, K) counts of the per-block tables
    chosen over the predefined ones by estimated cost; else it is empty
    and every stream is predefined."""
    prep = prepare_sections(lit_len, offset, match_len, nseq, custom)
    lo, nb = run_state_kernel(*prep["state_args"])
    return finish_sections(prep, lo, nb, max_words)


def prepare_sections(lit_len: torch.Tensor, offset: torch.Tensor,
                     match_len: torch.Tensor, nseq: torch.Tensor,
                     custom: bool = False) -> dict:
    """Everything of encode_sequence_sections before B14: the codes, the
    per-block reversal, the table plan and the initial states. Returns a
    dict: "state_args" (run_state_kernel's arguments), "extras" (lo, hi,
    nbits) (B, S+1) int64 of the extra-bits items, and "plan"."""
    B, S = lit_len.shape
    dev = lit_len.device
    n = nseq.to(torch.int64)[:, None]
    srow = torch.arange(S, device=dev)[None, :]
    valid = srow < n
    ofv = torch.where(valid, offset.to(torch.int64) + 3, 4)
    ll = torch.where(valid, lit_len.to(torch.int64), 0)
    ml = torch.where(valid, match_len.to(torch.int64), 3)
    ll_c, ml_c, of_c, ll_b, ml_b, of_b, ll_x, ml_x, of_x = _codes(ll, ml,
                                                                  ofv)

    # Row j <- sequence nseq-1-j for j < nseq, the rest in place: the
    # reference's stable sort on nseq-1-j (2^30 for invalid rows).
    rev = torch.where(valid, n - 1 - srow, srow).expand(B, S)
    (rll_c, rof_c, rml_c, rll_b, rml_b, rof_b, rllx, rmlx,
     rofx) = (a.gather(1, rev) for a in (ll_c, of_c, ml_c, ll_b, ml_b, of_b,
                                         ll_x, ml_x, of_x))

    plan = {}
    tables = []
    for kind, codes in zip(_ORDER, (ll_c, of_c, ml_c)):
        if custom:
            use, norm, mixed = fse_tables.plan_streams(codes, valid, kind)
            plan[f"use_{kind}"] = use
            plan[f"norm_{kind}"] = norm
            widen = (0, _KROWS[kind] - mixed["dnb"].shape[1])
            tables.append((F.pad(mixed["dnb"], widen),
                           F.pad(mixed["dfs"], widen), mixed["state_table"]))
        else:
            tables.append(_predef_lane_tables(kind, B, dev))
    inits = [_init_state_lane(*tb, rc[:, 0])
             for tb, rc in zip(tables, (rll_c, rof_c, rml_c))]

    def rows(a: torch.Tensor) -> torch.Tensor:
        """(B, S) -> (S+1, B) int32, steps on rows, a zero row for the
        flush step."""
        return F.pad(a, (0, 1)).t().to(torch.int32).contiguous()

    def lane(t: torch.Tensor) -> torch.Tensor:
        return t.t().to(torch.int32).contiguous()

    # Extras of step j come from reversed row j: ll_x | ml_x << a | of_x
    # << c with a = ll bits and c = a + ml bits, up to 49 bits, as two
    # 32-bit words.
    ex = rllx | (rmlx << rll_b) | (rofx << (rll_b + rml_b))
    ex_nb = torch.where(valid, rll_b + rml_b + rof_b, 0)
    ex = torch.where(valid, ex, 0)
    return {
        "state_args": ([rows(rll_c), rows(rof_c), rows(rml_c)],
                       [tuple(lane(t) for t in tb) for tb in tables],
                       [i.to(torch.int32) for i in inits],
                       nseq.to(torch.int32)),
        "extras": (F.pad(ex & _M32, (0, 1)), F.pad(ex >> 32, (0, 1)),
                   F.pad(ex_nb, (0, 1))),
        "plan": plan,
    }


def finish_sections(prep: dict, state_lo: torch.Tensor,
                    state_nb: torch.Tensor, max_words: int = 8192):
    """Everything of encode_sequence_sections after B14: its state items
    interleaved with the extras items, [state_0, extras_0, state_1, ...],
    and packed into one backward bitstream per block (bitconcat)."""
    ex_lo, ex_hi, ex_nb = prep["extras"]
    B, S1 = ex_lo.shape
    st_lo = state_lo.t().to(torch.int64) & _M32
    items_lo = torch.stack([st_lo, ex_lo], dim=2).reshape(B, 2 * S1)
    items_hi = torch.stack([torch.zeros_like(ex_hi), ex_hi],
                           dim=2).reshape(B, 2 * S1)
    items_nb = torch.stack([state_nb.t().to(torch.int64), ex_nb],
                           dim=2).reshape(B, 2 * S1)
    words, bits, over = bitconcat.bitconcat(items_lo, items_hi, items_nb,
                                            max_words, max_item_bits=64)
    return words, bits, over, prep["plan"]
