"""The designs of the B8 and B15 CUDA kernels, checked on the CPU.

A CUDA kernel cannot run here, so what its correctness rests on is held
against the twins in numpy:
  * B8 (csrc/dense_kernels.cu compact_slots_dense_kernel) runs a grid of
    (chunks, rows) in groups of kMaxGridY rows, kSlotsPer slots a thread
    with 32-bit in-row indices. A sample slot (every sls-th) is found by
    a mask and indexed by a shift when sls is a power of two no smaller
    than kSlotsPer (then only a thread's first slot can be one), else by
    a 32-bit % and / a slot; a row whose slot count kSlotsPer does not
    divide takes the guarded path. `_b8_model` runs the grid with that
    arithmetic; every output word must be written exactly once and equal
    `compact_slots_dense_twin`, and, where the LDM estimates come from
    LDM keys (every level's case: sls = ldm_stride / 4), the JAX
    package's compact_slots_dense (interpret mode).
  * B15 (csrc/literals_kernels.cu literal_keys_kernel) is a single-pass
    scan with decoupled look-back: each CTA takes a tile from a counter
    in the order CTAs start, scans it in steps with the kernel's thread
    and warp arithmetic, stores its keys from the tile's own matches and
    a lower bound on the carry (the previous tile's word, read a step
    ahead; each tile posts such a partial bound after each step),
    publishes its aggregate, looks back 32 predecessors a step to the
    nearest inclusive prefix, publishes its own and rewrites the
    literals it stored below the carry. `_b15_model` runs the CTAs
    interleaved in seeded random orders, a few at a time, with the
    kernel's 30-bit status words and clamped ends in int32; it must finish
    (no CTA waits forever), write every key, and equal
    `literal_keys_twin` and, where
    every chosen match is at most 16384 long, the JAX package's
    literal_keys (interpret mode), at the kernel's tile and at a tile of
    64 positions that a row crosses 2048 times.
Everything compared is an integer, so the tolerance is 0.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops import literals_kernel as jlk
from qat_zstd_plugin_tpu_torch.ops import _build
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import literals_kernel as tlk

torch.set_num_threads(2)  # the suite runs six workers on a few cores

M32 = 0xFFFFFFFF
WINDOW = 32768


def _constant(source: str, name: str) -> int:
    with open(os.path.join(_build.CSRC, source)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


# ---------------------------------------------------------------------------
# B8
# ---------------------------------------------------------------------------

SLOT_THREADS = _constant("dense_kernels.cu", "kSlotThreads")
SLOTS_PER = _constant("dense_kernels.cu", "kSlotsPer")
MAX_GRID = _constant("common.cuh", "kMaxGridY")


def _b8_model(mlen, moff, est, off, cap, threads=SLOT_THREADS,
              per=SLOTS_PER, max_grid=MAX_GRID):
    """compact_slots_dense_kernel's grid on numpy arrays: (B*ns,) u32 words
    and the number of times each was written."""
    B, N = mlen.shape
    ns = N // 4
    spb = 0 if est is None else est.shape[1]
    sls = ns // spb if spb else 0
    # The entry point's choice of the shift path.
    sls_log2 = (sls.bit_length() - 1 if spb and sls >= per
                and sls & (sls - 1) == 0 else -1)
    vec = ns % per == 0
    chunks = -(-ns // (threads * per))
    ml4 = mlen.astype(np.int64).reshape(B, ns, 4)
    mo4 = (moff.astype(np.int64) & M32).reshape(B, ns, 4)
    out = np.zeros(B * ns, np.int64)
    writes = np.zeros(B * ns, np.int64)
    tid = np.arange(chunks * threads)  # blockIdx.x * threads + threadIdx.x
    s0 = tid * per
    s0 = s0[s0 < ns]  # the threads that return at once drop out
    for r0 in range(0, B, max_grid):
        for y in range(min(B - r0, max_grid)):
            row = r0 + y
            best = []
            for k in range(per):
                s = np.minimum(s0 + k, ns - 1)
                b = np.full(s0.shape, M32, np.int64)
                for j in range(4):
                    key = (j << 30) | mo4[row, s, j]
                    b = np.where(ml4[row, s, j] >= 4, np.minimum(b, key), b)
                best.append(b)
            m0 = [ml4[row, np.minimum(s0 + k, ns - 1), 0] for k in range(per)]

            def take(b, m, t):
                e = est[row, t].astype(np.int64)
                lo = off[row, t].astype(np.int64) & M32
                return np.where((e > m) & ((m < cap) | (e >= 128)), lo, b)

            if spb and sls_log2 >= 0:
                sample = (s0 & (sls - 1)) == 0
                t = np.where(sample, s0 >> sls_log2, 0)
                best[0] = np.where(sample, take(best[0], m0[0], t), best[0])
            elif spb:
                for k in range(per):
                    s = s0 + k
                    sample = (vec | (s < ns)) & (s % sls == 0)
                    t = np.where(sample, s // sls, 0)
                    best[k] = np.where(sample, take(best[k], m0[k], t),
                                       best[k])
            for k in range(per):
                s = s0 + k
                ok = s < ns if not vec else np.ones(s.shape, bool)
                out[row * ns + s[ok]] = best[k][ok]
                writes[row * ns + s[ok]] += 1
    return out, writes


def _check_b8(mlen, moff, est, off, cap, **kw):
    """The model against the twin; returns the model's words (u32)."""
    out, writes = _b8_model(mlen, moff, est, off, cap, **kw)
    assert (writes == 1).all()
    t = lambda a: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a))
    want = tk.compact_slots_dense_twin(t(mlen), t(moff), mlen.shape[1],
                                       t(est), t(off), cap)
    np.testing.assert_array_equal(out, want.numpy().reshape(-1)
                                  .view(np.uint32))
    return out


@functools.lru_cache(maxsize=None)
def _claims(B, N, seed, mixed=True):
    """(blocks, lengths, mlen, moff): the level-4 claims of seeded bytes
    (the twins' candidates, which the dense-path tests hold to the
    reference) with ragged lengths, and LDM-friendly repeats."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 8 if mixed else 256, (B, N), np.uint8)
    for b in range(1, B, 3):  # long-distance repeats of the block before
        blocks[b, :N // 2] = blocks[b - 1, N // 2:]
    blocks[0, 100:30000] = 0x41
    lengths = np.full(B, N, np.int32)
    lengths[1::4] = N - 7
    lengths[2::5] = N // 3
    x, lens = torch.from_numpy(blocks), torch.from_numpy(lengths)
    widths = (4, 5, 6, 8)
    pbits = (min(WINDOW, N) - 1).bit_length()
    sus = [tk._unsorted(tk.hash_keys(x, w, WINDOW, flip=tk._FLIP), pbits, 2,
                        flipped=True) for w in widths]
    ml, mo = tk.finalize_candidates(sus, x, lens, widths, WINDOW)
    return x, lens, ml.numpy(), mo.numpy()


@functools.lru_cache(maxsize=None)
def _ldm(B, N, seed, span):
    """(su, est, off): the LDM keys of span-block spans of _claims(B, N,
    seed) and their sample-grid estimates."""
    x, lens, _, _ = _claims(B, N, seed)
    _, minz = tk.hash_keys_winmin(x, 4, WINDOW, tk.ldm_stride(span, N))
    su = tk.ldm_unsorted(minz, span)
    est, off = tk._ldm_est(su, lens, N, span, 1 << 19)
    return su, est.numpy(), off.numpy()


@pytest.mark.parametrize("cap", [24, 32])
@pytest.mark.parametrize("span", [0, 4, 8, 16])
def test_b8_model_level_shapes(span, cap):
    """Levels 2-4's claims at 128 KiB blocks, LDM spans 0 (L4 without
    whole spans), 4, 8 and 16 (sample slots every 8, 8 and 16 slots: the
    shift path)."""
    x, lens, ml, mo = _claims(16, 131072, seed=0)
    est = off = None
    if span:
        _, est, off = _ldm(16, 131072, 0, span)
        assert (est > 0).any()
    _check_b8(ml, mo, est, off, cap)


@pytest.mark.parametrize("span", [0, 4, 8])
def test_b8_model_equals_reference(span):
    """64 KiB blocks through the JAX package's compact_slots_dense, which
    computes the LDM estimates from the same LDM keys."""
    x, lens, ml, mo = _claims(8, 65536, seed=7)
    su = est = off = None
    if span:
        su, est, off = _ldm(8, 65536, 7, span)
        assert (est > 0).any()
    for cap in (24, 32):
        got = _check_b8(ml, mo, est, off, cap)
        want = np.asarray(gk.compact_slots_dense(
            jnp.asarray(ml), jnp.asarray(mo), WINDOW,
            su=None if su is None else jnp.asarray(su.numpy().view(np.uint32)),
            lengths=jnp.asarray(lens.numpy()), span_blocks=span,
            local_cap=cap, max_off=1 << 19, interpret=True))
        np.testing.assert_array_equal(got, want.reshape(-1))


@pytest.mark.parametrize("n,spb", [
    (4100, 0), (4100, 1025), (4100, 41), (4100, 5), (4100, 205),
    (4104, 513), (4104, 0), (4096, 256), (4096, 1024), (6144, 128),
    (4608, 384), (4608, 9)])
def test_b8_model_sample_spacings(n, spb):
    """Rows whose slot count kSlotsPer need not divide (4100, 4104: the
    guarded path) and whose last chunk is partial, and sample spacings of
    1, 2, 3, 4, 5, 12, 25, 128 and 205 slots: powers of two no smaller
    than kSlotsPer take the shift path, the others 32-bit % and /. Random
    claims and estimates around both caps and 128; no level gives these
    spacings, so the twin alone is the reference."""
    rng = np.random.default_rng(n + spb)
    B = 5
    ml = rng.integers(0, 48, (B, n)).astype(np.int32)
    ml[:, ::7] = rng.integers(-3, 300, (B, -(-n // 7)))
    mo = rng.integers(0, WINDOW, (B, n)).astype(np.int32)
    est = off = None
    if spb:
        est = rng.integers(0, 260, (B, spb)).astype(np.int32)
        off = rng.integers(1, 1 << 19, (B, spb)).astype(np.int32)
    for cap in (24, 32):
        _check_b8(ml, mo, est, off, cap)
        # Row groups of 2 and two or eight slots a thread: the same words.
        for per in (2, 8):
            _check_b8(ml, mo, est, off, cap, per=per, max_grid=2)


# ---------------------------------------------------------------------------
# B15
# ---------------------------------------------------------------------------

LIT_THREADS = _constant("literals_kernels.cu", "kLitThreads")
LIT_PER = _constant("literals_kernels.cu", "kLitPer")
LIT_STEPS = _constant("literals_kernels.cu", "kLitSteps")
VALUE_MASK = (1 << 30) - 1
PARTIAL = 1 << 30
AGGREGATE = 2 << 30
PREFIX = 3 << 30
# (threads, positions a thread, steps, lanes a warp): the kernel's tile,
# and a tile of 64 positions (2 steps of 4 threads of 8, warps of 2).
TILES = {"kernel tile": (LIT_THREADS, LIT_PER, LIT_STEPS, 32),
         "64-position tile": (4, 8, 2, 2)}


def _b15_model(blocks, lengths, chosen, mlen, threads, per, steps, warp,
               seed, resident):
    """literal_keys_kernel's CTAs, `resident` at a time, each step of each
    interleaved in a seeded random order; returns the (B, n) keys (u32)."""
    B, n = blocks.shape
    step = threads * per
    tile = step * steps
    ntiles = -(-n // tile)
    status = np.zeros(B * ntiles, np.uint32)
    bounds = np.zeros(B * ntiles, np.uint32)
    keys = np.full((B, n), -1, np.int64)  # -1: never written
    counter = [0]
    rng = np.random.default_rng(seed)
    i32 = np.int32

    def cta():
        vid = counter[0]  # atomicAdd on the tile counter
        counter[0] += 1
        yield
        row, t = divmod(vid, ntiles)
        base = t * tile
        st = row * ntiles
        blen = int(lengths[row])
        # A thread peeks at the previous tile's bound word a step before it
        # uses the value, a lower bound on the carry.
        prev = int(bounds[st + t - 1]) if t else 0
        lb = 0
        step_lb = []
        tile_max = 0
        for j in range(steps):
            if base + j * step >= n:
                break
            more = j + 1 < steps and base + (j + 1) * step < n
            if prev >= PARTIAL:
                lb = max(lb, prev & VALUE_MASK)
            step_lb.append(lb)
            if more and t:
                prev = int(bounds[st + t - 1])
            pos = (base + j * step + np.arange(step)).astype(i32)
            inrow = pos < n
            pc = np.minimum(pos, n - 1)
            m = mlen[row, pc].astype(i32)
            # The clamped end, in int32 as on the card.
            end = np.minimum(pos + np.minimum(np.maximum(m, i32(0)), i32(n)),
                             i32(n))
            end = np.where(chosen[row, pc] & inrow, end, i32(0))
            run = np.maximum.accumulate(end.reshape(threads, per), axis=1)
            incl = np.maximum.accumulate(
                run[:, -1].reshape(threads // warp, warp), axis=1)
            warp_max = incl[:, -1]
            excl = np.concatenate([np.zeros((threads // warp, 1), i32),
                                   incl[:, :-1]], axis=1)
            before_warp = np.concatenate(
                [[0], np.maximum.accumulate(warp_max)[:-1]]).astype(i32)
            excl = np.maximum(excl, before_warp[:, None]).reshape(threads)
            before = np.maximum(np.maximum(excl, tile_max), lb)
            tile_max = max(tile_max, int(warp_max.max()))
            if more:
                bounds[st + t] = PARTIAL | max(tile_max, lb)
            p2 = pos.reshape(threads, per)
            lit = (np.maximum(before[:, None], run) <= p2) & (p2 < blen)
            word = np.where(lit, (p2.astype(np.int64) << 8)
                            | blocks[row, pc].reshape(threads, per), M32)
            keys[row, pos[inrow]] = word.reshape(-1)[inrow]
            yield
        carry = 0
        if t == 0:
            status[st] = PREFIX | tile_max
        else:
            status[st + t] = AGGREGATE | max(tile_max, lb)
            yield
            top = t - 1
            while True:  # one warp, 32 predecessors a step
                ts = top - np.arange(32)
                s = np.where(ts >= 0, status[st + np.maximum(ts, 0)],
                             PREFIX).astype(np.int64)
                if (s < AGGREGATE).any():
                    yield "waiting"
                    continue
                prefixes = s >= PREFIX
                last = int(np.argmax(prefixes)) if prefixes.any() else 31
                carry = max(carry, int((s[:last + 1] & VALUE_MASK).max()))
                if prefixes.any():
                    break
                top -= 32
                yield
            status[st + t] = PREFIX | max(carry, tile_max)
        yield
        # Each thread rewrites its literals below the carry: in step j
        # those at or past the step's bound.
        c = min(carry, base + tile, n)
        for j, lo in enumerate(step_lb):
            pos = base + j * step + np.arange(step)
            if pos[0] >= c:
                break
            mine = (pos >= lo) & (pos < c)
            assert (keys[row, pos[(pos < lo) & (pos < c)]] == M32).all()
            keys[row, pos[mine]] = M32

    pending, active, waits = B * ntiles, [], 0
    while pending or active:
        if pending and len(active) < resident and (
                not active or rng.random() < 0.3):
            g = cta()
            next(g)  # the CTA starts: it takes the next tile index
            active.append(g)
            pending -= 1
            continue
        i = int(rng.integers(len(active)))
        try:
            waits = waits + 1 if next(active[i]) == "waiting" else 0
        except StopIteration:
            active.pop(i)
            waits = 0
        assert waits < 1000 * (len(active) + 1), "the look-back never ends"
    assert (status >> 30 == 3).all()  # every tile published its prefix
    assert (keys >= 0).all()  # every key written
    return keys


def _lit_rows(N: int, tile: int, seed: int):
    """(chosen, mlen): sparse short matches, and one chosen match a row of
    16383, 16384, 16385, 40000 and 65535 bytes from a tile's first,
    middle and last position; a row with a match that ends on a tile edge
    and one with a match past the row's end."""
    rng = np.random.default_rng(seed)
    lengths = (16383, 16384, 16385, 40000, 65535)
    starts = (tile, tile + tile // 2, 2 * tile - 1)
    B = len(lengths) * len(starts) + 2
    chosen = rng.random((B, N)) < 0.02
    mlen = rng.integers(4, 41, (B, N)).astype(np.int32)
    row = 0
    for length in lengths:
        for s in starts:
            chosen[row, s], mlen[row, s] = True, length
            row += 1
    edge = 3 * tile
    chosen[row, edge - 1000], mlen[row, edge - 1000] = True, 1000
    chosen[row + 1, N - 30], mlen[row + 1, N - 30] = True, 65535
    return chosen, mlen


def _lit_check(chosen, mlen, lengths, tile_name, seed, reference):
    B, N = chosen.shape
    blocks = np.random.default_rng(seed).integers(0, 256, (B, N), np.uint8)
    threads, per, steps, warp = TILES[tile_name]
    got = _b15_model(blocks, lengths, chosen, mlen, threads, per, steps,
                     warp, seed, resident=int(seed % 5) + 2)
    want = tlk.literal_keys_twin(*(torch.from_numpy(a) for a in (
        blocks, lengths, chosen, mlen))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    if reference:  # every chosen match at most 16384 long
        ref = np.asarray(jlk.literal_keys(
            jnp.asarray(blocks), jnp.asarray(lengths), jnp.asarray(chosen),
            jnp.asarray(mlen), interpret=True))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("tile_name", sorted(TILES))
def test_b15_model_long_matches(tile_name, seed):
    """Matches of 16383 to 65535 from a tile's first, middle and last
    position (of the 64-position tile too), one ending on a tile edge and
    one past the row; against the twin, and the rows of matches up to
    16384 long against the reference."""
    threads, per, steps, _ = TILES[tile_name]
    tile = threads * per * steps
    N = 131072
    chosen, mlen = _lit_rows(N, max(tile, 64), seed)
    lengths = np.full(chosen.shape[0], N, np.int32)
    _lit_check(chosen, mlen, lengths, tile_name, seed, reference=False)
    short = 6  # rows of the 16383- and 16384-long matches
    _lit_check(chosen[:short].copy(), mlen[:short].copy(), lengths[:short],
               tile_name, seed + 10, reference=True)


@pytest.mark.parametrize("tile_name", sorted(TILES))
def test_b15_model_no_chosen_and_ragged(tile_name):
    """No chosen position, and ragged lengths 0, 1, 7 and N - 8 over
    sparse matches: against the twin and the reference."""
    N = 65536
    rng = np.random.default_rng(5)
    chosen = rng.random((5, N)) < 0.03
    chosen[0] = False
    mlen = rng.integers(-2, 300, (5, N)).astype(np.int32)
    lengths = np.array([N, 0, 1, 7, N - 8], np.int32)
    _lit_check(chosen, mlen, lengths, tile_name, 3, reference=True)


def test_b15_clamped_ends_pin_int32_overflow():
    """A chosen match of length near 2**31 past position 0: the clamped
    int32 end covers the rest of the row, as the twin's int64 cummax does,
    where the unclamped int32 sum p + mlen wraps negative and would cover
    nothing."""
    N = 4096
    chosen = np.zeros((2, N), bool)
    mlen = np.zeros((2, N), np.int32)
    chosen[0, 5], mlen[0, 5] = True, 2**31 - 1
    chosen[1, 3000], mlen[1, 3000] = True, 2**31 - 2000
    lengths = np.full(2, N, np.int32)
    with np.errstate(over="ignore"):
        assert np.int32(5) + mlen[0, 5] < 0  # what the old sum gave
    for tile_name in TILES:
        _lit_check(chosen, mlen, lengths, tile_name, 4, reference=False)
    twin = tlk.literal_keys_twin(*(torch.from_numpy(a) for a in (
        np.zeros((2, N), np.uint8), lengths, chosen, mlen))).numpy()
    assert (twin[0, 5:] == -1).all() and (twin[1, 3000:] == -1).all()


def test_slots_literals_script_needs_a_card(monkeypatch):
    """designs/slots_literals.py times B8 and B15 at other designs and
    beside a parent tree on a card; without one it stops before it builds
    anything. Each design sets csrc constants that exist, to values other
    than csrc's."""
    from qat_zstd_plugin_tpu_torch.designs import slots_literals as sl
    for name, design in sl.DESIGNS.items():
        srcs = sl._sources(_build.CSRC, design)
        plain = sl._sources(_build.CSRC)
        _, source, consts = design
        assert srcs[source] != plain[source], name
        for const, value in consts.items():
            assert re.search(rf"constexpr \w+ {const} = {value};",
                             srcs[source]), name
    with pytest.raises(SystemExit, match="has no kNoSuchConstant"):
        sl._sources(_build.CSRC, ("B8", "dense_kernels.cu",
                                  {"kNoSuchConstant": "1"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        sl.main([])


def test_b15_wrapper_scratch_fits_the_kernel():
    """The wrapper sizes B15's scratch (a status word and a bound line a
    tile, then the counter) from the kernel's tile and bound stride."""
    assert tlk.LIT_TILE == LIT_THREADS * LIT_PER * LIT_STEPS
    assert tlk.LIT_BOUND_STRIDE == _constant("literals_kernels.cu",
                                             "kLitBoundStride")
