"""The designs of the B14 and B19 CUDA kernels, checked on the CPU.

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
Everything compared is an integer, so the tolerance is 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import fse_kernel as jfk
from qat_zstd_plugin_tpu_torch.ops import fse_kernel as tfk
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
