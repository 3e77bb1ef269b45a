"""The designs of the K2, K3, B7, B13, B14 and B19 CUDA kernels, checked
on the CPU.

A CUDA kernel cannot run here, so what its correctness rests on is held
against the twins in numpy:
  * B14 (csrc/fse_kernels.cu) splits every block's chain of FSE steps into
    pieces: (a) maps each piece from every possible entry state, (b)
    chains the maps from the initial state, (c) walks each piece from its
    known entry. `_piece_walk` models the three phases and must equal
    `run_state_kernel_twin` word for word at several piece lengths, and
    the JAX package's Pallas kernel (interpret mode) at one small size.
  * B19 (csrc/sort_kernels.cu) runs the launches that `sort_plan` plans.
    The plan must run the network's stages exactly once and in order, and
    each stage of a fused group may pair only elements that one thread,
    CTA or cluster holds. `_emulate_plan` runs the plan with the kernels'
    own index arithmetic (register groups, cross-CTA stages in which each
    side keeps its own half) and must equal the twin.
  * B7 and B13 (csrc/common.cuh finalize_tile_kernel, with their first
    passes in dense_kernels.cu and verified_kernels.cu) scan for the next
    byte change in tiles: a pre-pass gives each tile's first change, a
    CTA ballots its change bits into words, one warp scans the words in
    reverse seeded with the minimum over a bounded number of following
    tiles, and each position reads its word. `_tiled_finalize` models the
    kernels with their own index arithmetic, at the kernel's tile and at
    a 64-position tile that crosses many tiles; it must equal
    `_offset1_runs`, the twins, and the JAX package's finalize_candidates
    and finalize_verified (interpret mode) on crafted rows.
  * K2 and K3 (csrc/l1_kernels.cu) take a flip word, XORed into K2's
    reads and both kernels' writes. `_k2_model` runs K2's launches with
    their 32-bit index arithmetic (each thread's 8-word window of its 4
    words and the 4 before them, reads past the window from the row, a
    part of a CTA at a row's end, the scalar path of widths that are no
    multiple of 4, groups of 65535 rows);
    `_k3_model` runs K3's (one thread a sample, its two writes, span row
    0's context from the last span). Each must write every output word
    once (K3 read every sample once) and equal the twin in both flip
    modes, at the kernels' CTA sizes and at small ones.
Everything compared is an integer, so the tolerance is 0.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import fse_kernel as jfk
from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu_torch.ops import _build
from qat_zstd_plugin_tpu_torch.ops import fse_kernel as tfk
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import sort_kernel as tsk

torch.set_num_threads(2)  # the suite runs six workers on a few cores

# ---------------------------------------------------------------------------
# B14
# ---------------------------------------------------------------------------

S = 302  # S + 1 = 303 steps: a multiple of no piece length below but 1
COUNTS = [0, 1, 2, S, S - 1, 37, 64, 5]


@functools.lru_cache(maxsize=None)
def _state_args(custom: bool, outside: bool):
    """B14's arguments from prepare_sections on seeded sequences; with
    `outside`, some codes lie outside their tables (negative or past the
    symbol rows)."""
    rng = np.random.default_rng(21 + custom)
    B = len(COUNTS)
    ll = rng.integers(0, 300, (B, S)).astype(np.int32)
    ll[:, ::7] = rng.integers(0, 70000, (B, -(-S // 7)))
    ml = rng.integers(3, 40, (B, S)).astype(np.int32)
    ml[:, ::11] = rng.integers(3, 70000, (B, -(-S // 11)))
    of = rng.integers(1, 1 << 17, (B, S)).astype(np.int32)
    of[:, ::3] = rng.integers(1, 64, (B, -(-S // 3)))
    nseq = np.array(COUNTS, np.int32)
    codes, tables, inits, n = tfk.prepare_sections(
        *(torch.from_numpy(a) for a in (ll, of, ml, nseq)),
        custom=custom)["state_args"]
    codes = [c.clone() for c in codes]
    if outside:
        for k, c in enumerate(codes):
            hit = torch.from_numpy(rng.random(c.shape) < 0.05)
            bad = torch.from_numpy(rng.choice([-1, -70, 64, 99], c.shape)
                                   .astype(np.int32))
            c[hit] = bad[hit] if k != 1 else bad[hit] // 2
    return codes, tables, inits, n


def _lookup(tbl: np.ndarray, idx: np.ndarray, cols: np.ndarray):
    """tbl[idx, col] (tbl (rows, B), idx and cols broadcast), 0 where idx is
    outside the table."""
    inside = (idx >= 0) & (idx < tbl.shape[0])
    return np.where(inside, tbl[np.clip(idx, 0, tbl.shape[0] - 1), cols], 0)


def _piece_walk(codes, tables, inits, nseq, L: int):
    """The kernel's three phases in numpy, streams in the kernel's order
    (LL, OF, ML); entry e < size is st[e], e == size the state 0, e ==
    size + 1 the initial state."""
    codes = [c.numpy().astype(np.int64) for c in codes]
    tabs = [[t.numpy().astype(np.int64) for t in tb] for tb in tables]
    init = [i.numpy().astype(np.int64) for i in inits]
    n = nseq.numpy().astype(np.int64)
    S1, B = codes[0].shape
    P = -(-S1 // L)
    pstart = np.arange(P) * L
    lo_act = np.maximum(pstart, 1)[None, :]                  # (1, P)
    hi_act = np.minimum(np.minimum(pstart + L, n[:, None]), S1)  # (B, P)
    active_piece = lo_act < hi_act

    def states_of(k, e, cols):
        size = tabs[k][2].shape[0]
        return np.where(e < size, _lookup(tabs[k][2], e, cols),
                        np.where(e == size, 0, init[k][cols]))

    def step(k, code, s, cols):
        """One active step: (bits, nb, next state, next entry)."""
        dnb = _lookup(tabs[k][0], code, cols)
        dfs = _lookup(tabs[k][1], code, cols)
        nb = (s + dnb) >> 16
        at = (s >> nb) + dfs
        size = tabs[k][2].shape[0]
        inside = (at >= 0) & (at < size)
        return (s & ((1 << nb) - 1), nb, _lookup(tabs[k][2], at, cols),
                np.where(inside, at, size))

    # (a) maps[k]: (B, P, size + 2) exit entries.
    maps = []
    for k in range(3):
        E = tabs[k][2].shape[0] + 2
        cols = np.arange(B)[:, None, None]
        entry = np.broadcast_to(np.arange(E), (B, P, E)).copy()
        s = states_of(k, entry, cols)
        for i in range(L):
            j = pstart + i                                    # (P,)
            act = ((j >= lo_act) & (j < hi_act))[:, :, None]  # (B, P, 1)
            code = codes[k][np.minimum(j, S1 - 1)][None, :, :] \
                .transpose(2, 1, 0)                            # (B, P, 1)
            _, _, nxt, nent = step(k, code, s, cols)
            s = np.where(act, nxt, s)
            entry = np.where(act, nent, entry)
        maps.append(entry)

    # (b) entries[k]: (B, P), each piece's entry state.
    entries = []
    for k in range(3):
        e = np.full(B, tabs[k][2].shape[0] + 1)
        per_piece = np.zeros((B, P), np.int64)
        for p in range(P):
            per_piece[:, p] = e
            e = np.where(active_piece[:, p], maps[k][np.arange(B), p, e], e)
        entries.append(per_piece)

    # (c) every (block, piece) from its entry states.
    cols = np.arange(B)[:, None]
    s = [states_of(k, entries[k], cols) for k in range(3)]
    lo = np.zeros((S1, B), np.int64)
    nb = np.zeros((S1, B), np.int64)
    for i in range(L):
        j = pstart + i                                        # (P,)
        inside = j < S1
        jc = np.minimum(j, S1 - 1)
        act = (j >= 1) & (j < n[:, None]) & inside            # (B, P)
        flush = (j == n[:, None]) & inside
        parts = []
        for k in (1, 2, 0):  # OF, ML, LL
            bits, nbk, nxt, _ = step(k, codes[k][jc].T, s[k], cols)
            parts.append((np.where(act, bits, 0), np.where(act, nbk, 0)))
            s[k] = np.where(act, nxt, s[k])
        (b_of, n_of), (b_ml, n_ml), (b_ll, n_ll) = parts
        enc = b_of | (b_ml << n_of) | (b_ll << (n_of + n_ml))
        fl = (s[2] & 63) | ((s[1] & 31) << 6) | ((s[0] & 63) << 11)
        item = np.where(act, enc, np.where(flush, fl, 0))
        bits = np.where(act, n_of + n_ml + n_ll, np.where(flush, 17, 0))
        rows_b, rows_p = np.nonzero(inside[None, :] & np.ones((B, 1), bool))
        lo[j[rows_p], rows_b] = item[rows_b, rows_p]
        nb[j[rows_p], rows_b] = bits[rows_b, rows_p]
    return lo.astype(np.int32), nb.astype(np.int32)


@pytest.mark.parametrize("outside", [False, True], ids=["codes", "outside"])
@pytest.mark.parametrize("custom", [False, True], ids=["predef", "custom"])
@pytest.mark.parametrize("L", [1, 2, 7, tfk.PIECE])
def test_piece_walk_equals_twin(L, custom, outside):
    args = _state_args(custom, outside)
    lo, nb = _piece_walk(*args, L)
    tw_lo, tw_nb = tfk.run_state_kernel_twin(*args)
    np.testing.assert_array_equal(lo, tw_lo.numpy())
    np.testing.assert_array_equal(nb, tw_nb.numpy())
    n = np.array(COUNTS)
    assert (nb[n, np.arange(len(n))] == 17).all()  # every flush item


@pytest.mark.parametrize("custom", [False, True], ids=["predef", "custom"])
def test_piece_walk_equals_pallas(custom):
    """At S = 302 the model against the reference's Pallas kernel in
    interpret mode, codes outside a table included."""
    codes, tables, inits, n = _state_args(custom, True)
    lo, nb = _piece_walk(codes, tables, inits, n, tfk.PIECE)
    B = n.shape[0]
    lo_ref, nb_ref = jfk._run_state_kernel(
        [jnp.asarray(c.numpy()) for c in codes],
        [tuple(jnp.asarray(t.numpy()) for t in tb) for tb in tables],
        [jnp.asarray(i.numpy()).reshape(1, B) for i in inits],
        jnp.asarray(n.numpy()).reshape(1, B))
    S1 = lo.shape[0]
    np.testing.assert_array_equal(lo, np.asarray(lo_ref)[:S1])
    np.testing.assert_array_equal(nb, np.asarray(nb_ref)[:S1])


# ---------------------------------------------------------------------------
# B19
# ---------------------------------------------------------------------------

def _network(n: int) -> list:
    return [(k, j) for m in range(1, n.bit_length())
            for k in [1 << m] for j in [k >> i for i in range(1, m + 1)]]


def _stages(step) -> list:
    """The (k, j) stages of one plan step, in order."""
    if step[0] == "cross":
        return [step[1:]]
    _, k, j, r = step
    return [(k, j >> i) for i in range(r)]


def _group(step, cta: int, kind: str):
    """(pb, bits): the column bits a thread of this register group holds."""
    _, k, j, r = step
    jb = j.bit_length() - 1
    if kind == "global":
        return jb - r + 1, r
    return max(jb - (tsk.GROUP_BITS - 1), 0), tsk.GROUP_BITS


def _holders(pb: int, bits: int, width: int) -> np.ndarray:
    """(threads, 2^bits) columns of each thread, the kernels' arithmetic:
    base = t with `bits` zero bits inserted at pb, column base | e << pb."""
    t = np.arange(width >> bits)[:, None]
    base = ((t >> pb) << (pb + bits)) | (t & ((1 << pb) - 1))
    return base | (np.arange(1 << bits)[None, :] << pb)


@pytest.mark.parametrize("n", [1 << m for m in range(10, 21)])
def test_sort_plan_covers_the_network(n):
    plan = tsk.sort_plan(n)
    stages = [s for _, steps in plan for st in steps for s in _stages(st)]
    assert stages == _network(n)
    cta, span = min(n, tsk.CTA_ELEMS), min(n, tsk.SPAN)
    assert plan[0][0] == "cta" and plan[-1][0] in ("cta", "cluster")
    assert all(kind != "cta" for kind, _ in plan[1:])
    for kind, steps in plan:
        if kind == "global":
            assert len(steps) == 1 and steps[0][0] == "regs"
        else:
            assert len(steps) <= 64  # the kernel's kMaxSteps
        for st in steps:
            if st[0] == "cross":  # partner in another CTA of the cluster
                assert kind == "cluster" and cta <= st[2] < span
                continue
            pb, bits = _group(st, cta, kind)
            width = n if kind == "global" else cta
            cols = _holders(pb, bits, width)
            # The threads' columns cover the CTA (or row) once.
            assert np.array_equal(np.sort(cols.ravel()), np.arange(width))
            for k, j in _stages(st):
                assert 1 <= st[3] <= tsk.GROUP_BITS
                assert j >= span if kind == "global" else j < cta
                if kind == "cta":  # a CTA of its own: k within the CTA
                    assert k <= cta
                # Each partner is one of the same thread's columns.
                assert pb <= j.bit_length() - 1 < pb + bits
    words = tsk._plan_words(plan)
    assert len(words) == sum(2 + len(s) for _, s in plan)


def _emulate_plan(key: np.ndarray, pos: np.ndarray, n: int):
    """The kernels' run of sort_plan(n) on (B, n) rows: returns (key, pos,
    idx) as int64. Register groups compare-exchange the pairs of their
    threads' columns, the larger word to the upper column of an ascending
    pair and to the lower of a descending one (the direction of the lower
    column); a cross-CTA stage gives each element its partner's value
    where the pair swaps."""
    word = ((key.astype(np.int64) & 0xFFFFFFFF) << 32) \
        | ((pos.astype(np.int64) + (1 << 31)) & 0xFFFFFFFF)
    word = word.astype(np.uint64)
    idx = np.broadcast_to(np.arange(n), key.shape).copy()
    cta = min(n, tsk.CTA_ELEMS)
    col = np.arange(n)
    for kind, steps in tsk.sort_plan(n):
        for st in steps:
            if st[0] == "cross":
                _, k, j = st
                partner = col ^ j
                mine_first = ((col & j) == 0) == (
                    ((col & ~(cta - 1)) & k) == 0)
                mine, theirs = word, word[:, partner]
                swap = np.where(mine_first, mine > theirs, theirs > mine)
                word = np.where(swap, theirs, mine)
                idx = np.where(swap, idx[:, partner], idx)
                continue
            pb, bits = _group(st, cta, kind)
            for k, j in _stages(st):
                q = j.bit_length() - 1 - pb
                cols = _holders(pb, bits, n).ravel()
                e = np.tile(np.arange(1 << bits), len(cols) >> bits)
                low = cols[(e & (1 << q)) == 0]
                desc = (low & k) != 0
                a_col = np.where(desc, low | (1 << (pb + q)), low)
                b_col = a_col ^ (1 << (pb + q))
                a, b = word[:, a_col], word[:, b_col]
                swap = a > b
                wa, wb = np.where(swap, b, a), np.where(swap, a, b)
                ia, ib = idx[:, a_col], idx[:, b_col]
                word[:, a_col], word[:, b_col] = wa, wb
                idx[:, a_col], idx[:, b_col] = (np.where(swap, ib, ia),
                                                np.where(swap, ia, ib))
    k_out = (word >> np.uint64(32)).astype(np.int64)
    p_out = (word & np.uint64(0xFFFFFFFF)).astype(np.int64) - (1 << 31)
    return k_out, p_out, idx


@pytest.mark.parametrize("n,rows", [(1024, 4), (32768, 2), (262144, 1)])
def test_emulated_plan_equals_twin(n, rows):
    """At one CTA, a cluster of 2 and past a cluster (device-memory
    passes): random keys in one row, duplicate (key, pos) pairs in the
    others, one payload gathered by the column."""
    rng = np.random.default_rng(n)
    key = rng.integers(-2**31, 2**31, (rows, n)).astype(np.int32)
    pos = np.tile(np.arange(n, dtype=np.int32), (rows, 1))
    key[1:] = rng.integers(-2, 2, (rows - 1, n))
    pos[1:] = rng.integers(-3, 3, (rows - 1, n))
    pay = rng.integers(-2**31, 2**31, (rows, n)).astype(np.int32)
    k_out, p_out, idx = _emulate_plan(key, pos, n)
    want = tsk.bitonic_sort_twin(*(torch.from_numpy(a)
                                   for a in (key, pos, pay)))
    np.testing.assert_array_equal(k_out.astype(np.uint32).view(np.int32),
                                  want[0].numpy())
    np.testing.assert_array_equal(p_out, want[1].numpy())
    np.testing.assert_array_equal(np.take_along_axis(pay, idx, 1),
                                  want[2].numpy())


# ---------------------------------------------------------------------------
# B7 and B13: the tiled offset-1 run scan
# ---------------------------------------------------------------------------

BIG = 1 << 30  # common.cuh kBig
RUN_N = 65536  # two window segments: runs cross the segment boundary
WINDOW = 32768


def _common_constant(name: str) -> int:
    with open(os.path.join(_build.CSRC, "common.cuh")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


KERNEL_TILE = _common_constant("kRunTile")
KERNEL_THREADS = _common_constant("kRunThreads")
TILES = [(KERNEL_TILE, KERNEL_THREADS), (64, 32)]  # (tile, threads a CTA)


def test_run_tile_is_the_kernels():
    """The wrapper sizes the pre-pass's scratch with RUN_TILE: it must be
    the kernels' tile; and the look-ahead reaches as far as the cap."""
    assert tk.RUN_TILE == KERNEL_TILE
    assert KERNEL_TILE % 64 == 0 and KERNEL_TILE // KERNEL_THREADS >= 1
    assert (tk.RUN_CAP + 1) // KERNEL_TILE * KERNEL_TILE >= tk.RUN_CAP - 1


def _changes(x: np.ndarray, width: int) -> np.ndarray:
    """run_change at positions 0..width-1: x[j] != x[j+1], and True from
    the row's last byte on."""
    B, N = x.shape
    c = np.ones((B, width), bool)
    c[:, :N - 1] = x[:, :-1] != x[:, 1:]
    return c


def _tiled_runs(x: np.ndarray, blen: np.ndarray, ml: np.ndarray,
                mo: np.ndarray, T: int, threads: int, look: int = None):
    """tile_first_change_kernel and finalize_tile_kernel's scan and run
    rule, over every (row, tile) at once; `look` defaults to the kernel's
    (kRunCap + 1) / kRunTile."""
    B, N = x.shape
    tiles = -(-N // T)
    per, nwords = T // threads, T // 32
    look = (tk.RUN_CAP + 1) // T if look is None else look
    chg = _changes(x, tiles * T).reshape(B, tiles, T)
    t0 = np.arange(tiles)[None, :, None] * T
    # The pre-pass: each tile's first change before N, or BIG.
    first = _first_changes(x, T)
    j = t0 + np.arange(T)
    np.testing.assert_array_equal(
        first, np.where(chg & (j < N), j, BIG).min(axis=2))
    # (a) Ballots: thread t's k-th position is r = k * threads + t; warp
    # wp's ballot at k fills word r >> 5 of its lane 0, lane l's bit l.
    words = np.zeros((B, tiles, nwords), np.uint64)
    r_of = np.arange(per)[:, None] * threads + np.arange(threads)
    for k in range(per):
        for wp in range(threads // 32):
            lanes = r_of[k, 32 * wp:32 * wp + 32]
            words[:, :, lanes[0] >> 5] = (
                chg[:, :, lanes].astype(np.uint64)
                << np.arange(32, dtype=np.uint64)).sum(axis=2)
    # (b) One warp: the following tiles' minimum, then lane l's words 2l
    # and 2l + 1, an inclusive suffix minimum over the lanes by shuffles.
    after = np.full((B, tiles), BIG)
    for q in range(1, min(look, tiles - 1) + 1):  # tile + q < tiles
        after[:, :tiles - q] = np.minimum(after[:, :tiles - q],
                                          first[:, q:])
    L = nwords // 2
    w0, w1 = words[:, :, 0::2], words[:, :, 1::2]
    base = t0 + 64 * np.arange(L)[None, None, :]
    p0 = np.where(w0 != 0, base + _ctz(w0), BIG)
    p1 = np.where(w1 != 0, base + 32 + _ctz(w1), BIG)
    s = np.minimum(p0, p1)
    d = 1
    while d < 32:
        v = s.copy()
        v[:, :, :L - d] = s[:, :, d:]  # lanes past the last keep their own
        s = np.where(np.arange(L) + d < 32, np.minimum(s, v), s)
        d *= 2
    later = np.empty_like(s)
    later[:, :, :L - 1] = np.minimum(s[:, :, 1:], after[:, :, None])
    later[:, :, L - 1] = after
    n1 = np.where(w1 != 0, p1, later)
    nextw = np.empty((B, tiles, nwords + 1), np.int64)
    nextw[:, :, 1:nwords:2] = n1
    nextw[:, :, 0:nwords:2] = np.where(w0 != 0, p0, n1)
    nextw[:, :, nwords] = after
    # (c) Each position: its word, or the next word's scan.
    r = np.arange(T)
    jj = t0 + r
    m = words[:, :, r >> 5] >> (r & 31).astype(np.uint64)
    nxt = np.where(m != 0, jj + _ctz(m), nextw[:, :, (r >> 5) + 1])
    # The staged bytes: sx[r] is x[t0 + r], sx[-1] the byte before the tile.
    xp = np.concatenate([np.full((B, 1), -1), x.astype(np.int64)], axis=1)
    xx = np.concatenate([xp, np.full((B, tiles * T - N), -1)], axis=1)
    repeat = (jj > 0) & (xx[:, 1:].reshape(B, tiles, T)
                         == xx[:, :-1].reshape(B, tiles, T))
    len1 = np.minimum(np.minimum(nxt - jj + 1, blen[:, None, None] - jj),
                      tk.RUN_CAP)
    ml3 = _tiles_of(ml, tiles, T)
    mo3 = _tiles_of(mo, tiles, T)
    use = repeat & (len1 >= 4) & (len1 > ml3)
    out_ml = np.where(use, len1, ml3).reshape(B, -1)[:, :N]
    out_mo = np.where(use, 1, mo3).reshape(B, -1)[:, :N]
    return out_ml, out_mo


def _first_changes(x: np.ndarray, T: int) -> np.ndarray:
    """tile_first_change_kernel: a warp a tile. Where N % 16 == 0 lane l
    holds the 16-byte chunks at t0 + 16 * (l + 32 q) and compares each
    with the byte after it: lane l + 1's first byte of chunk q, for lane
    31 lane 0's of chunk q + 1, after the last chunk the next tile's
    first byte; else lane l reads bytes t0 + 32 k + l. The row's last
    byte is a change."""
    B, N = x.shape
    tiles = -(-N // T)
    t0 = np.arange(tiles) * T
    f = np.where(N - 1 < t0 + T, N - 1, BIG)[None, :].repeat(B, 0)
    xp = np.zeros((B, tiles * T + 1), np.int64)
    xp[:, :N] = x
    if N % 16 == 0 and T % 512 == 0:
        chunks = T // 512
        lane = np.arange(32)[:, None]
        q = np.arange(chunks)[None, :]
        c = t0[:, None, None] + 16 * (lane + 32 * q)  # (tiles, 32, chunks)
        first_b = xp[:, np.where(c < N, c, tiles * T)]
        up = np.roll(first_b, -1, axis=2)  # lane + 1, same chunk
        wrap = np.concatenate([first_b[:, :, :1, 1:], np.where(
            t0 + T < N, xp[:, np.minimum(t0 + T, tiles * T)],
            0)[:, :, None, None]], axis=3)  # lane 0 of chunk q + 1
        nb = np.where(lane == 31, wrap, up)
        data = xp[:, np.minimum(c[..., None] + np.arange(16), tiles * T)]
        nxt = np.concatenate([data[..., 1:], nb[..., None]], axis=-1)
        diff = data != nxt
        k = np.where(diff.any(-1), diff.argmax(-1), BIG)
        at = np.where((c < N) & (k < BIG), c + k, BIG)
        f = np.minimum(f, at.reshape(B, tiles, -1).min(-1))
    else:
        j = t0[:, None, None] + 32 * np.arange(T // 32)[None, :, None] \
            + np.arange(32)  # (tiles, k, lane)
        jc = np.minimum(j, tiles * T - 1)
        hit = (j < N - 1) & (xp[:, jc] != xp[:, jc + 1])
        f = np.minimum(f, np.where(hit, j, BIG).reshape(B, tiles, -1)
                       .min(-1))
    return f


def _ctz(w: np.ndarray) -> np.ndarray:
    """__ffs(w) - 1 of nonzero u64 words (0 where w is 0)."""
    low = w & (~w + np.uint64(1))
    return np.where(w != 0, np.log2(np.maximum(low, 1).astype(np.float64)),
                    0).astype(np.int64)


def _tiles_of(a: np.ndarray, tiles: int, T: int) -> np.ndarray:
    B, N = a.shape
    out = np.zeros((B, tiles * T), np.int64)
    out[:, :N] = a
    return out.reshape(B, tiles, T)


def _shifted(a: np.ndarray, s: int) -> np.ndarray:
    """Element i <- a[:, i+s], 0 past the row."""
    out = np.zeros_like(a)
    out[:, :a.shape[1] - s] = a[:, s:]
    return out


def _chain(su: np.ndarray, shape, blen, width: int, steps: int, omask):
    """The first passes' chain at one width, as the kernels count it: the
    claim at i (0 where its gram passes the length) and the number of
    leading claims at i, i + width, ... (2^steps of them, 0 past the row)
    equal to it, for the reference's `steps` doubling steps."""
    B, N = shape
    offs = (su.astype(np.int64).reshape(B, N) & omask)
    offs = np.where(np.arange(N) + width <= blen[:, None], offs, 0)
    same = offs > 0
    reach = same.astype(np.int64)
    for m in range(1, 1 << steps):
        same &= _shifted(offs, m * width) == offs
        reach += same
    return offs, reach


def _candidates_pass(sus, blen, shape, widths, omask):
    """CandidatesPass (dense_kernels.cu) at every position."""
    ml = np.zeros(shape, np.int64)
    mo = np.zeros(shape, np.int64)
    for su, width in zip(sus, widths):
        off, reach = _chain(su, shape, blen, width, tk.CHAIN_STEPS, omask)
        est = reach * width
        better = (est > ml) | ((est == ml) & (off > 0)
                               & ((off < mo) | (mo == 0)))
        take = (off > 0) & better
        ml, mo = np.where(take, est, ml), np.where(take, off, mo)
    worth = ((ml >= 7) | ((ml >= 6) & (mo <= 32768)) | ((ml >= 5)
             & (mo <= 4096)) | ((ml >= 4) & (mo <= 256)))
    return (np.where(worth, np.minimum(ml, tk.RUN_CAP), 0),
            np.where(worth, mo, 0))


def _verified_pass(su, blen, shape, omask):
    """VerifiedPass (verified_kernels.cu) at every position."""
    off, reach = _chain(su, shape, blen, 4, tk.VERIFIED_CHAIN_STEPS, omask)
    ml = reach * 4
    worth = (ml >= tk.VERIFIED_FAR_MIN) | ((ml >= 4)
                                           & (off <= tk.VERIFIED_NEAR_OFF))
    return (np.where(worth, np.minimum(ml, tk.RUN_CAP), 0),
            np.where(worth, off, 0))


RUNS = {  # row: (start, length) of its runs of one byte
    1: [(2048, 16382), (20000, 16383), (47104, 16384)],
    2: [(2047, 16385), (22528, 16383), (45000, 16384)],
    3: [(6144, 16385), (30000, 16382), (50000, RUN_N - 50000)],
    4: [(1000, 16385), (20480, 16384), (40960, 16385)],
}


@functools.lru_cache(maxsize=None)
def _run_case(blocks_kind: str):
    """(blocks, keys) of a crafted case. "runs": 8 rows of 65536 bytes: an
    all-same row; runs of 16382-16385 bytes starting and ending on and off
    tile edges (2048-position tiles, so 64-position ones too), one to the
    row's end; short runs; random bytes. "n4100": 6 rows of 4100 bytes
    (one segment, w = N) with runs. Keys: position-ordered (pos << pbits
    | off) words whose offsets repeat along chains."""
    rng = np.random.default_rng(8)
    if blocks_kind == "runs":
        B, N = 8, RUN_N
        x = rng.integers(0, 256, (B, N), np.uint8)
        x[0] = 0x41
        for row, runs in RUNS.items():
            for start, length in runs:
                x[row, start:start + length] = 0x30 + row
        x[5] = rng.integers(0, 3, N, np.uint8)  # short runs everywhere
        x[6, :] = np.repeat(rng.integers(0, 256, N // 7 + 1, np.uint8),
                            7)[:N]
    else:
        B, N = 6, 4100
        x = rng.integers(0, 256, (B, N), np.uint8)
        x[0, 100:4000] = 5
        x[1, 2040:] = 9
        x[2] = 0x41
        x[4, 64:4064] = 3
        x[5, 4000:] = 7
    w = min(WINDOW, N)
    pbits = (w - 1).bit_length()
    offs = rng.choice(np.array([0, 0, 0, 1, 3, 200, 4000, w - 1]), (B, N))
    # Chains: a claim repeats at i + width for widths 4 (B13) and 5.
    for s in (4, 5):
        hit = rng.random((B, N)) < 0.3
        offs[:, s:] = np.where(hit[:, s:], offs[:, :-s], offs[:, s:])
    keys = []
    for width in (4, 5, 6, 8):
        hi = rng.integers(0, 1 << (32 - pbits), (B, N)).astype(np.uint64)
        o = np.where(rng.random((B, N)) < 0.8, offs,
                     rng.integers(0, w, (B, N)))
        keys.append(((hi << np.uint64(pbits)) | o.astype(np.uint64))
                    .astype(np.uint32).reshape(B * (N // w), w))
    return x, tuple(keys)


def _lengths(kind: str, B: int, N: int) -> np.ndarray:
    if kind == "full":
        return np.full(B, N, np.int32)
    return np.resize(np.array([0, 1, 3, 4, N - 10, N], np.int32), B)


CASES = [("runs", "full"), ("runs", "ragged"), ("n4100", "full"),
         ("n4100", "ragged")]


@pytest.mark.parametrize("T,threads", TILES, ids=["kernel-tile", "tile-64"])
@pytest.mark.parametrize("blocks_kind,lens", CASES,
                         ids=["-".join(c) for c in CASES])
def test_tiled_scan_equals_offset1_runs(blocks_kind, lens, T, threads):
    """The scan and run rule alone, on first-pass planes of random
    lengths (up to past the cap) and offsets."""
    x, _ = _run_case(blocks_kind)
    B, N = x.shape
    blen = _lengths(lens, B, N)
    rng = np.random.default_rng(T)
    ml = np.where(rng.random((B, N)) < 0.5, rng.integers(0, 20000, (B, N)),
                  0)
    ml = np.minimum(ml, tk.RUN_CAP)
    mo = rng.integers(0, 1 << 15, (B, N))
    got = _tiled_runs(x, blen, ml, mo, T, threads)
    want = tk._offset1_runs(torch.from_numpy(x),
                            torch.from_numpy(blen.astype(np.int64))[:, None],
                            torch.from_numpy(ml), torch.from_numpy(mo))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert (got[1] == 1).any() or blen.max() < 5


@functools.lru_cache(maxsize=None)
def _reference(kind: str, blocks_kind: str, lens: str):
    """The JAX package's finalize_candidates (widths 4, 5, 6, 8: two
    chunks) or finalize_verified, interpret mode, as numpy arrays."""
    x, keys = _run_case(blocks_kind)
    blen = _lengths(lens, *x.shape)
    if kind == "candidates":
        ml, mo = gk.finalize_candidates(
            tuple(jnp.asarray(k) for k in keys), jnp.asarray(x),
            jnp.asarray(blen), (4, 5, 6, 8), WINDOW, interpret=True)
    else:
        ml, mo = gk.finalize_verified(jnp.asarray(keys[0]), jnp.asarray(x),
                                      jnp.asarray(blen), WINDOW,
                                      interpret=True)
    return np.asarray(ml), np.asarray(mo)


def _tiled_finalize(kind: str, x, keys, blen, T: int, threads: int):
    """B7's or B13's two kernels: the first pass, then the tiled scan."""
    B, N = x.shape
    omask = (1 << (min(WINDOW, N) - 1).bit_length()) - 1
    if kind == "candidates":
        ml, mo = _candidates_pass(keys, blen, (B, N), (4, 5, 6, 8), omask)
    else:
        ml, mo = _verified_pass(keys[0], blen, (B, N), omask)
    return _tiled_runs(x, blen, ml, mo, T, threads)


@pytest.mark.parametrize("T,threads", TILES, ids=["kernel-tile", "tile-64"])
@pytest.mark.parametrize("blocks_kind,lens", CASES,
                         ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("kind", ["candidates", "verified"])
def test_tiled_finalize_equals_reference(kind, blocks_kind, lens, T,
                                         threads):
    x, keys = _run_case(blocks_kind)
    blen = _lengths(lens, *x.shape)
    got = _tiled_finalize(kind, x, keys, blen, T, threads)
    want = _reference(kind, blocks_kind, lens)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    args = (torch.from_numpy(x), torch.from_numpy(blen))
    if kind == "candidates":
        twin = tk.finalize_candidates(
            [torch.from_numpy(k.view(np.int32)) for k in keys], *args,
            (4, 5, 6, 8), WINDOW)
    else:
        twin = tk.finalize_verified(torch.from_numpy(keys[0].view(np.int32)),
                                    *args)
    np.testing.assert_array_equal(got[0], twin[0].numpy())
    np.testing.assert_array_equal(got[1], twin[1].numpy())
    if blocks_kind == "runs":
        assert (got[0] == tk.RUN_CAP).any()  # a capped run
    assert ((got[1] > 1) & (got[0] >= 4)).any()  # first-pass claims kept


@pytest.mark.parametrize("T,threads", TILES, ids=["kernel-tile", "tile-64"])
def test_tiled_scan_needs_its_whole_look_ahead(T, threads):
    """One tile fewer of look-ahead gives a wrong length on the crafted
    rows (a run from inside a tile to a change just under the cap away):
    the cases above reach the bound."""
    x, keys = _run_case("runs")
    blen = _lengths("full", *x.shape)
    zero = np.zeros(x.shape, np.int64)
    full = _tiled_runs(x, blen, zero, zero, T, threads)
    short = _tiled_runs(x, blen, zero, zero, T, threads,
                        look=(tk.RUN_CAP + 1) // T - 1)
    assert not np.array_equal(full[0], short[0])


# ---------------------------------------------------------------------------
# K2 and K3: 32-bit index arithmetic, flip words, one read and one write
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
FLIPS = [0, 0x80000000]


def _l1_constant(name: str) -> int:
    with open(os.path.join(_build.CSRC, "l1_kernels.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


K2_THREADS = _l1_constant("kK2Threads")
K3_THREADS = _l1_constant("kK3Threads")
MAX_GRID = _common_constant("kMaxGridY")


def _k2_claims(sh, sp, j, neighbors, word, pbits, pmask):
    """off for each (sh, sp) at row position j; word(k) gives the words
    k back (valid where k <= j), as the kernel reads them."""
    off = np.zeros_like(sh)
    for k in range(1, neighbors + 1):
        q = word(k)
        pp = q & pmask
        hit = (k <= j) & (off == 0) & ((q >> pbits) == sh) & (pp < sp)
        off = np.where(hit, sp - pp, off)
    return off


def _k2_model(sk, pbits, neighbors, pmask, flip, threads=K2_THREADS,
              max_grid=MAX_GRID):
    """neighbor_unsort_keys_kernel and its launches, thread by thread (in
    numpy, all threads of a row at once): u32 rows in; the outputs and how
    often each output word was written."""
    rows, w = sk.shape
    out = np.zeros(sk.shape, np.int64)
    writes = np.zeros(sk.shape, np.int64)
    vec = w % 4 == 0
    per = 4 * threads if vec else threads
    chunks = -(-w // per)
    shift = 32 - pbits
    i = np.arange(chunks * threads)  # blockIdx.x * kK2Threads + threadIdx.x
    for r0 in range(0, rows, max_grid):
        for y in range(min(rows - r0, max_grid)):
            x = sk[r0 + y].astype(np.int64) ^ flip  # every read flipped
            row = writes[r0 + y], out[r0 + y]
            if vec:
                t = 4 * i[4 * i < w]
                # The register window: a = words t-4..t-1 (0 at t = 0),
                # b = words t..t+3, from two 16-byte loads.
                win = x[np.clip(t[:, None] + np.arange(-4, 4), 0, w - 1)]
                win[t < 4, :4] = 0
                for e in range(4):
                    j = t + e
                    sv = win[:, 4 + e]
                    word = (lambda k, e=e, j=j: win[:, 4 + e - k] if k <= 4
                            else x[np.maximum(j - k, 0)])
                    off = _k2_claims(sv >> pbits, sv & pmask, j, neighbors,
                                     word, pbits, pmask)
                    row[0][j] += 1
                    row[1][j] = (((sv << shift) | off) & M32) ^ flip
            else:
                j = i[i < w]
                sv = x[j]
                off = _k2_claims(sv >> pbits, sv & pmask, j, neighbors,
                                 lambda k: x[np.maximum(j - k, 0)], pbits,
                                 pmask)
                row[0][j] += 1
                row[1][j] = (((sv << shift) | off) & M32) ^ flip
    return out, writes


def _k2_rows(case: str):
    """(u32 rows, pbits, pos_mask): sorted rows with runs of equal hashes
    across many chunks (4 hash values over a row, one, 64), unsorted rows,
    a width of no multiple of 4 (the scalar path) and one that ends in a
    part of a CTA (4100: 4 words past a whole number of CTAs)."""
    rng = np.random.default_rng(len(case))
    w = int(case.split()[1]) if case.startswith("width") else 4096
    pos = rng.permutation(w).astype(np.int64)
    if case == "unsorted":
        rows = [(rng.integers(0, 4, w) << 13) | rng.integers(0, w, w)
                for _ in range(3)]
    else:
        rows = [np.sort((rng.integers(0, 4, w) << 13) | pos),
                np.sort((3 << 13) | pos), np.sort((rng.integers(0, 64, w)
                                                   << 13) | pos)]
    return np.stack(rows).astype(np.uint32), 13, (1 << 13) - 1


@pytest.mark.parametrize("flip", FLIPS, ids=["flip0", "flip"])
@pytest.mark.parametrize("neighbors", [0, 1, 2, 3, 7, 100])
@pytest.mark.parametrize("case", ["sorted", "unsorted", "width 4097",
                                  "width 4100"])
@pytest.mark.parametrize("threads,max_grid", [(K2_THREADS, MAX_GRID),
                                              (4, 2)],
                         ids=["kernel-launch", "4-thread-ctas"])
def test_k2_model_equals_twin(case, neighbors, flip, threads, max_grid):
    """The model of the kernel (register window, reads past it, chunk and
    row-group edges, the scalar path) writes each output word once and
    equals the twin, in both flip modes; 4-thread CTAs and groups of two
    rows put many chunk and launch edges inside the rows."""
    sk, pbits, pmask = _k2_rows(case)
    x = sk ^ np.uint32(flip)
    got, writes = _k2_model(x, pbits, neighbors, pmask, flip, threads,
                            max_grid)
    assert (writes == 1).all()
    twin = tk.neighbor_unsort_keys_twin(
        torch.from_numpy(x.view(np.int32)), pbits, neighbors, pmask, flip)
    np.testing.assert_array_equal(got, twin.numpy().view(np.uint32))
    if neighbors:
        assert ((got ^ flip) & ((1 << (32 - pbits)) - 1)).any()  # claims


def _k3_model(minz, span, stride, flip, threads=K3_THREADS,
              max_grid=MAX_GRID):
    """ldm_keys_kernel and its launches, thread by thread: the outputs,
    how often each output word was written and each sample read."""
    B, n = minz.shape
    spb = n // stride
    nspans = B // span
    half = span * spb
    pbits = (2 * half - 1).bit_length()
    out = np.zeros((nspans, 2 * half), np.int64)
    writes = np.zeros(out.shape, np.int64)
    reads = np.zeros((B, spb), np.int64)
    chunks = -(-spb // threads)

    def key(m, column):
        return ((((m * 2654435761) & M32) >> pbits << pbits) | column) ^ flip

    q = np.arange(chunks * threads)  # blockIdx.x * kK3Threads + threadIdx.x
    q = q[q < spb]
    for r0 in range(0, nspans, max_grid):
        for z in range(min(nspans - r0, max_grid)):  # blockIdx.z
            r = r0 + z
            last = r + 1 == nspans
            for bs in range(span):  # blockIdx.y
                c = bs * spb + q
                b = r * span + bs
                m = minz[b, q * stride].astype(np.int64)
                reads[b, q] += 1
                out[r, half + c] = key(m, half + c)
                writes[r, half + c] += 1
                ctx = 0 if last else r + 1
                out[ctx, c] = key(np.full_like(m, M32) if last else m, c)
                writes[ctx, c] += 1
    return out, writes, reads


K3_SHAPES = {"span 4": (4, 8, 8192), "span 8": (8, 16, 8192),
             "span 16": (16, 32, 8192), "one span": (4, 4, 8192),
             "1027 samples a block": (4, 12, 32 * 1027)}


@pytest.mark.parametrize("flip", FLIPS, ids=["flip0", "flip"])
@pytest.mark.parametrize("case", sorted(K3_SHAPES))
@pytest.mark.parametrize("threads,max_grid", [(K3_THREADS, MAX_GRID),
                                              (32, 1)],
                         ids=["kernel-launch", "32-thread-ctas"])
def test_k3_model_equals_twin(case, flip, threads, max_grid):
    """The model reads each sample once, writes each output word once
    (span row 0's context from the last span's threads) and equals the
    twin, in both flip modes; launches of one span row each exercise the
    row-group loop."""
    span, B, n = K3_SHAPES[case]
    stride = tk.ldm_stride(span, n)
    rng = np.random.default_rng(B + n)
    minz = rng.integers(0, 1 << 32, (B, n), np.uint64).astype(np.uint32)
    got, writes, reads = _k3_model(minz, span, stride, flip, threads,
                                   max_grid)
    assert (writes == 1).all() and (reads == 1).all()
    twin = tk.ldm_keys_twin(torch.from_numpy(minz.view(np.int32)), span,
                            stride, flip)
    np.testing.assert_array_equal(got, twin.numpy().view(np.uint32))


def test_rejected_designs_script_needs_a_card(monkeypatch):
    """designs/k2_k3.py times K2's and K3's rejected designs beside csrc's
    kernels on a card; without one it stops before it builds anything."""
    from qat_zstd_plugin_tpu_torch.designs import k2_k3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        k2_k3.main([])


# ---------------------------------------------------------------------------
# B5, B6 and B9: the warp-tiled keys and windowed minimum (common.cuh)
# ---------------------------------------------------------------------------

HASH_WARPS = _common_constant("kHashWarps")
HASH_ROWS = _common_constant("kHashRows")
ROW_SPAN = _common_constant("kRowSpan")
GEOMETRIES = [(HASH_ROWS, HASH_WARPS), (1, 1)]  # (rows a warp, warps a CTA)
LANES = np.arange(32)
C1, C2, C3 = 2654435761, 2246822519, 3266489917


def _shfl(v, src):
    """__shfl_sync(v, src): lane l gets lane src[l]'s v (lanes last)."""
    return v[..., src]


def _shfl_up(v, d: int, width: int):
    """__shfl_up_sync(v, d, width): a lane whose segment has no lane d
    before it keeps its own v."""
    return v[..., np.where(LANES % width >= d, LANES - d, LANES)]


def _shfl_down(v, d: int, width: int):
    return v[..., np.where(LANES % width + d < width, LANES + d, LANES)]


def _be_at(lo, hi, k: int):
    """__byte_perm(lo, hi, 0x0123 + 0x1111 k): the big-endian word of
    bytes k..k+3 of the little-endian pair (lo, hi)."""
    sel = 0x0123 + 0x1111 * k
    out = np.zeros_like(lo)
    for j in range(4):
        s = (sel >> (4 * j)) & 7
        byte = ((lo if s < 4 else hi) >> np.uint64(8 * (s & 3))) & 0xFF
        out |= byte << np.uint64(8 * j)
    return out


def _hash_words(a, b, width: int):
    """common.cuh hash_words on u32 values held in uint64 (products wrap
    mod 2^64, a multiple of 2^32)."""
    def mul(x, c):
        return (x * np.uint64(c)) & np.uint64(M32)
    h = mul(a, C1)
    if width == 4:
        return h
    if width == 5:
        return h ^ ((mul(b >> np.uint64(24), C2) << np.uint64(11))
                    & np.uint64(M32))
    if width == 6:
        return h ^ mul(b >> np.uint64(16), C2)
    return h ^ mul(mul(b, C2), C3)


def _block_scans(h, L: int):
    """Prefix and suffix minima within blocks of L lanes: the lane's own
    four (h: k first), then segmented shuffle scans."""
    pre = np.minimum.accumulate(h, axis=0)
    suf = np.minimum.accumulate(h[::-1], axis=0)[::-1]
    ip, is_ = pre[3], suf[0]
    d = 1
    while d < L:
        ip = np.minimum(ip, _shfl_up(ip, d, L))
        is_ = np.minimum(is_, _shfl_down(is_, d, L))
        d *= 2
    ep = np.where(LANES % L == 0, M32, _shfl_up(ip, 1, L))
    es = np.where(LANES % L == L - 1, M32, _shfl_down(is_, 1, L))
    return np.minimum(pre, ep), np.minimum(suf, es)


def _window_min(h, pre, suf, hn, pn, stride: int):
    if stride >= 4:
        L = stride // 4
        up = (LANES + L) & 31
        q = [_shfl(np.where(LANES >= L, pre[k], pn[k]), up) for k in range(3)]
        q3 = _shfl(np.where(LANES >= L - 1, pre[3], pn[3]),
                   (LANES + L - 1) & 31)
        return np.stack([np.minimum(suf[0], q3)] +
                        [np.minimum(suf[k], q[k - 1]) for k in (1, 2, 3)])
    if stride == 2:
        h4 = _shfl(np.where(LANES >= 1, h[0], hn[0]), (LANES + 1) & 31)
        nxt = np.concatenate([h[1:], h4[None]])
        return np.minimum(h, nxt)
    return h


def _winmin_model(x, width, pbits, stride, flip, keys_on: bool,
                  minz_on: bool, rows=HASH_ROWS, warps=HASH_WARPS):
    """hash_keys_kernel<keys_on, minz_on> and, for a stride above 128,
    winmin_stretch_kernel, lane by lane (all warps of all rows at once):
    (B, n) uint8 -> u32 keys and minz planes (uint64) and how often each
    word of each was written."""
    B, n = x.shape
    pmask = min(32768, n) - 1  # the wrappers' w - 1 at window 32768
    wide = minz_on and stride > ROW_SPAN
    S = ROW_SPAN if wide else stride
    span = rows * ROW_SPAN
    tiles = -(-n // (span * warps)) * warps  # the grid's warps
    t0 = np.arange(tiles) * span
    t0 = t0[t0 < n]  # the others return at once
    nw = n // 4
    words = np.ascontiguousarray(x).view("<u4").astype(np.uint64)
    loads = rows + (2 if minz_on else 1)
    q = t0[:, None, None] // 4 + 32 * np.arange(loads)[:, None] + LANES
    w = np.where(q < nw, words[:, np.minimum(q, nw - 1)], 0)  # (B,T,r,32)
    w = np.moveaxis(w, 2, 0)  # row of words first
    keys = np.zeros((B, n), np.uint64)
    minz = np.zeros((B, n), np.uint64)
    kw = np.zeros((B, n), np.int64)
    mw = np.zeros((B, n), np.int64)

    def store(out, cnt, i, vals):
        live = np.broadcast_to(i < n, vals.shape[1:])
        for k in range(4):
            pos = np.broadcast_to(i + k, live.shape)
            b = np.broadcast_to(np.arange(B)[:, None, None], live.shape)
            out[b[live], pos[live]] = vals[k][live]
            np.add.at(cnt, (b[live], pos[live]), 1)

    def tile_row(r, write_keys):
        own, nxt = w[r], w[r + 1]
        b = _shfl(np.where(LANES >= 1, own, nxt), (LANES + 1) & 31)
        c = _shfl(np.where(LANES >= 2, own, nxt), (LANES + 2) & 31)
        lo = [_be_at(own, b, k) for k in range(4)]
        hi = [_be_at(b, c, k) for k in range(4)]
        i = t0[:, None] + r * ROW_SPAN + 4 * LANES  # (T, 32)
        if keys_on and write_keys:
            pb = np.uint64(pbits)
            key = np.stack([((_hash_words(lo[k], hi[k], width) >> pb << pb)
                             | ((i + k) & pmask).astype(np.uint64))
                            ^ np.uint64(flip)
                            for k in range(4)])
            store(keys, kw, i, key)
        h8 = np.stack([_hash_words(lo[k], hi[k], 8) for k in range(4)])
        return np.where(i < n, h8, M32), i

    if not minz_on:
        for r in range(rows):
            tile_row(r, True)
        return keys, kw, None, None
    L = max(S // 4, 1)
    h, _ = tile_row(0, True)
    pre, suf = _block_scans(h, L) if S >= 4 else (h, h)
    for r in range(rows):
        hn, _ = tile_row(r + 1, r + 1 < rows)  # the last: the halo
        pn, sn = _block_scans(hn, L) if S >= 4 else (hn, hn)
        i = t0[:, None] + r * ROW_SPAN + 4 * LANES
        store(minz, mw, i, _window_min(h, pre, suf, hn, pn, S))
        h, pre, suf = hn, pn, sn
    if wide:  # the stretch over the stride-128 plane, 4 positions a thread
        plane, minz = minz, np.full_like(minz, M32)
        for r in range(stride // ROW_SPAN):
            sh = np.full_like(plane, M32)
            if r * ROW_SPAN < n:
                sh[:, :n - r * ROW_SPAN] = plane[:, r * ROW_SPAN:]
            minz = np.minimum(minz, sh)
        assert (mw == 1).all()  # each scratch word written once
    return keys, kw, minz, mw


def _winmin_blocks(B: int, n: int, seed: int) -> np.ndarray:
    """Bytes whose minima move: random and low-alphabet spans, a run and
    copies of earlier spans."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (B, n), np.uint8)
    x[:, n // 3:2 * n // 3] = rng.integers(0, 3, (B, 2 * n // 3 - n // 3))
    if n >= 64:
        x[0, 10:40] = 0x41
        x[B - 1, n // 2:] = x[0, :n - n // 2]
    return x


WM_STRIDES = [1, 2, 4, 8, 32, 64, 128, 4096]
WM_SHAPES = {131072: 2, 4100: 3, 8: 3, 4: 2}  # n: rows


def _wm_pbits(n: int) -> int:
    return (min(32768, n) - 1).bit_length()


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["kernel", "1-row"])
@pytest.mark.parametrize("flip", FLIPS, ids=["flip0", "flip"])
@pytest.mark.parametrize("n", sorted(WM_SHAPES))
@pytest.mark.parametrize("stride", WM_STRIDES)
def test_winmin_model_equals_twins(stride, n, flip, geometry):
    """B6's and B9's model (loads, shuffled words, block scans, the next
    row's prefixes, the halo row, the stretch above stride 128) writes
    every key and minz word once and equals _winmin_tail and the twins;
    1-row warp tiles in 1-warp CTAs put a tile edge and its halo at every
    128 positions."""
    rows, warps = geometry
    x = _winmin_blocks(WM_SHAPES[n], n, stride + n)
    width = (4, 5, 6, 8)[stride % 4]
    pbits = _wm_pbits(n)
    keys, kw, minz, mw = _winmin_model(x, width, pbits, stride, flip, True,
                                       True, rows, warps)
    assert (kw == 1).all() and (mw == 1).all()
    tx = torch.from_numpy(x)
    tw_k, tw_m = tk.hash_keys_winmin_twin(tx, width, 32768, stride, flip)
    np.testing.assert_array_equal(keys.reshape(-1),
                                  tw_k.numpy().view(np.uint32).reshape(-1))
    np.testing.assert_array_equal(minz, tw_m.numpy().view(np.uint32))
    h8 = tk._hash_tile(tx.to(torch.int64), 8, 32)
    np.testing.assert_array_equal(minz, tk._winmin_tail(h8, stride).numpy())
    _, _, minz9, _ = _winmin_model(x, 8, 0, stride, 0, False, True, rows,
                                   warps)
    np.testing.assert_array_equal(minz9, minz)
    np.testing.assert_array_equal(
        minz9, tk.ldm_winmin_twin(tx, stride).numpy().view(np.uint32))


@functools.lru_cache(maxsize=None)
def _wm_reference(stride: int, n: int):
    """The JAX package's hash_keys_winmin (width 4) and ldm_winmin,
    interpret mode, as numpy arrays."""
    x = jnp.asarray(_winmin_blocks(WM_SHAPES[n], n, stride + n))
    key, minz = gk.hash_keys_winmin(x, 4, 32768, stride, interpret=True)
    return (np.asarray(key), np.asarray(minz),
            np.asarray(gk.ldm_winmin(x, stride, interpret=True)))


# The reference's rolls take no shift past the row (7 for the 8-gram,
# stride / 2 for the last doubling step): rows of 4 bytes, and of 8 at
# strides above 16, are held to the twins above only.
WM_REFERENCE = [(stride, n) for stride in WM_STRIDES for n in sorted(WM_SHAPES)
                if n >= 7 and stride // 2 <= n]


@pytest.mark.parametrize("flip", FLIPS, ids=["flip0", "flip"])
@pytest.mark.parametrize("stride,n", WM_REFERENCE)
def test_winmin_model_equals_reference(stride, n, flip):
    """The model at the kernel's geometry equals the JAX package's
    kernels word for word: keys (XORed with the flip word), minz and B9's
    plane."""
    x = _winmin_blocks(WM_SHAPES[n], n, stride + n)
    key_ref, minz_ref, ldm_ref = _wm_reference(stride, n)
    keys, _, minz, _ = _winmin_model(x, 4, _wm_pbits(n), stride, flip, True,
                                     True)
    np.testing.assert_array_equal(keys.reshape(key_ref.shape),
                                  key_ref ^ np.uint32(flip))
    np.testing.assert_array_equal(minz, minz_ref)
    _, _, minz9, _ = _winmin_model(x, 8, 0, stride, 0, False, True)
    np.testing.assert_array_equal(minz9, ldm_ref)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["kernel", "1-row"])
@pytest.mark.parametrize("flip", FLIPS, ids=["flip0", "flip"])
@pytest.mark.parametrize("n", [131072, 4100, 4])
@pytest.mark.parametrize("width", [4, 5, 6, 8])
def test_hash_keys_model_equals_twin(width, n, flip, geometry):
    """B5's model (no minz: one row of words past the tile) writes every
    key once and equals the twin in both flip modes."""
    rows, warps = geometry
    x = _winmin_blocks(2, n, width)
    keys, kw, _, _ = _winmin_model(x, width, _wm_pbits(n), 0, flip, True,
                                   False, rows, warps)
    assert (kw == 1).all()
    twin = tk.hash_keys_twin(torch.from_numpy(x), width, 32768, flip)
    np.testing.assert_array_equal(keys.reshape(-1),
                                  twin.numpy().view(np.uint32).reshape(-1))


def test_winmin_row_span_is_the_kernels():
    """The wrappers allocate scratch above WINMIN_ROW_SPAN: the kernels'
    row, and a warp's 32 lanes of 4 positions."""
    assert tk.WINMIN_ROW_SPAN == ROW_SPAN == 32 * 4


def test_winmin_designs_script_needs_a_card(monkeypatch):
    """designs/winmin.py times B5, B6 and B9 at other tile sizes and
    beside a parent tree on a card; without one it stops before it builds
    anything. Its tile sizes replace common.cuh's constants."""
    from qat_zstd_plugin_tpu_torch.designs import winmin
    srcs = winmin._sources(_build.CSRC, (4, 8))
    assert "constexpr int kHashRows = 4;" in srcs["common.cuh"]
    assert "constexpr int kHashWarps = 8;" in srcs["common.cuh"]
    assert winmin.TILES[0] == (HASH_ROWS, HASH_WARPS)  # csrc's own
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        winmin.main([])
