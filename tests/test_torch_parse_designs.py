"""The design of the B10 CUDA kernel (csrc/content_kernels.cu
parse_greedy_kernel), checked on the CPU.

A CUDA kernel cannot run here, so what its correctness rests on is held
against the twins in numpy. The kernel cuts every row into chunks of
kParseThreads x kParsePiece positions, one CTA a chunk, each lane a piece
of kParsePiece positions and each warp a segment of 32 pieces:
  (a) a lane computes its positions' steps in registers (the sign marks a
      take) and maps its piece backward from every entry to where the
      chain leaves it (`pe`); each warp composes its pieces backward into
      the same map over its segment (`we`);
  (b) a CTA takes its chunk from a ticket counter, chunk-major, so its
      predecessor in the row has started; thread 0 waits for the
      predecessor's exit (the row's cursor at the chunk's start; past the
      chunk it passes through), hops over the segments to the chunk's
      exit and publishes it at once;
  (c) each warp hops over its pieces from its segment's entry, and each
      lane walks its piece forward from its own entry and writes chosen.
`_parse_model` runs the three phases with the kernel's index arithmetic
(chunk edges, the last chunk's end, the look-ahead read across a chunk
edge, the ticket order) and must equal `parse_greedy_twin`, the JAX
package's parse_greedy_scan and, at one small size, parse_greedy_pallas
(interpret mode), in both modes (psegs 1 and `trunc`), lazy on and off,
at the kernel's chunk and at chunks of 64 that a row crosses many times.
Everything compared is an integer, so the tolerance is 0.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import match_pipeline as jmp
from qat_zstd_plugin_tpu.ops import parse_kernel as jpk
from qat_zstd_plugin_tpu_torch.ops import _build
from qat_zstd_plugin_tpu_torch.ops import parse_kernel as tpk

torch.set_num_threads(2)  # the suite runs six workers on a few cores

MIN_MATCH = 4
WARP = 32


def _constant(name: str) -> int:
    with open(os.path.join(_build.CSRC, "content_kernels.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


THREADS = _constant("kParseThreads")
PIECE = _constant("kParsePiece")
STATUS_STRIDE = _constant("kParseStatusStride")
# (threads, piece): the kernel's, and chunks of 64 positions in one warp
# of pieces of 2 and in two warps of pieces of 1 (segments of 32).
SIZES = [(THREADS, PIECE), (32, 2), (64, 1)]


def _parse_model(mlen: np.ndarray, lazy: bool, psegs: int = 1,
                 threads: int = THREADS, piece: int = PIECE) -> np.ndarray:
    """parse_greedy_kernel's phases on (B, N) int32 lengths -> (B, N)
    bool, each array indexed as the kernel's shared memory is (chunk
    positions, not the padded words)."""
    B, N = mlen.shape
    rows, n = B * psegs, N // psegs
    trunc = psegs > 1
    m_rows = mlen.reshape(rows, n).astype(np.int64)
    C = threads * piece
    S = WARP * piece                       # a warp's segment
    cpr = (n - 1) // C + 1                 # chunks a row
    big = np.iinfo(np.int64).max // 4
    j = np.arange(C)
    base = np.arange(cpr)[:, None] * C                   # (cpr, 1)
    E = np.minimum(C, n - base)                          # (cpr, 1)
    # The chunk's lengths and the one past it (0 past the row's end).
    t = base + np.arange(C + 1)                          # (cpr, C + 1)
    m = np.where(t < n, m_rows[:, np.minimum(t, n - 1)], 0)  # (rows, cpr, C+1)
    t = t[:, :C]
    raw, nxt = m[..., :C], m[..., 1:]
    ml = np.minimum(raw, n - t) if trunc else raw
    take = (ml >= MIN_MATCH) & ~(lazy & (nxt > ml))
    st = np.where(take, -np.minimum(ml, n - t), 1)
    st = np.where(j < E, st, 1)                          # past the row: 1
    step = np.abs(st)
    assert np.where(j < E, t + step, 0).max() <= n < 2 ** 30  # int32 sums

    def at(a, idx):
        return np.take_along_axis(a, np.minimum(idx, C - 1), axis=-1)

    # (a) the piece maps, lane by lane, backward (where the chain from each
    # entry leaves the piece), then the segment maps, piece by piece.
    ps = (j // piece) * piece
    pend = np.minimum(ps + piece, E)                     # (cpr, C)
    pe = np.zeros_like(st)
    for i in reversed(range(piece)):
        js = np.arange(i, C, piece)                      # position i of each piece
        y = js + step[..., js]
        pe[..., js] = np.where(y >= pend[:, js], y, at(pe, y))
    ss = (j // S) * S
    send = np.minimum(ss + S, E)
    we = np.zeros_like(st)
    for q in reversed(range(WARP)):
        js = (np.arange(0, C, S)[:, None] + q * piece
              + np.arange(piece)).ravel()                # piece q of each warp
        y = pe[..., js]
        we[..., js] = np.where(y >= send[:, js], y, at(we, y))

    # (b) the chain: tickets in order, chunk-major (ticket = k * rows + r),
    # thread 0's hops over the segments from the entry.
    status = np.zeros(cpr * rows, np.int64)
    seg_entry = np.full((rows, cpr, C // S), C)          # C: no entry
    for ticket in range(cpr * rows):
        k, r = divmod(ticket, rows)
        entry = 0 if k == 0 else status[(k - 1) * rows + r]
        x, e = entry - base[k, 0], E[k, 0]
        exit_at = entry                                  # past the chunk
        while x < e:
            seg_entry[r, k, x // S] = x
            y = we[r, k, x]
            if y >= e:
                exit_at = base[k, 0] + y
                break
            x = y
        status[ticket] = exit_at

    # (c) each warp's hops over its pieces (every lane the same x), then
    # each lane's walk of its piece from its own entry.
    p_entry = np.full((rows, cpr, C // piece), big)
    x = seg_entry.copy()                                 # (rows, cpr, W)
    wsend = send[:, ::S]                                 # (cpr, W)
    rr, kk, _ = np.indices(x.shape)
    for _ in range(WARP):
        live = x < wsend
        xs = np.minimum(x, C - 1)
        p_entry[rr[live], kk[live], xs[live] // piece] = xs[live]
        x = np.where(live, pe[rr, kk, xs], x)
    assert not (x < wsend).any()                         # at most 32 hops
    chosen = np.zeros((rows, cpr, C), bool)
    x = p_entry
    for i in range(piece):
        js = np.arange(i, C, piece)
        on = js == x
        chosen[..., js] = on & (st[..., js] < 0)
        x = np.where(on, js + step[..., js], x)
    return chosen.reshape(rows, cpr * C)[:, :n].reshape(B, N)


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------

def _content_rows(B: int, n: int, seed: int) -> np.ndarray:
    """tests/test_torch_content.py's B10 rows: zeros, lengths >= 4, lazy
    ties, an exact end, a strictly rising run, a match past the end."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((B, n)) < 0.3,
                 rng.integers(0, 40, (B, n)), 0).astype(np.int32)
    m[0, :] = 0
    m[1 % B, :] = rng.integers(4, 9, n)
    m[2 % B, 100:110] = 7
    m[2 % B, n - 20] = 20
    m[3 % B, 8190:8200] = np.arange(4, 14)[:len(m[3 % B, 8190:8200])]
    m[B - 1, n - 3:] = 60
    return m


def _psegs_rows(B: int, N: int, psegs: int, seed: int) -> np.ndarray:
    """tests/test_torch_psegs.py's rows: matches across every segment end,
    lengths that reach it, cuts below 4, look-aheads over it."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((B, N)) < 0.4, rng.integers(0, 48, (B, N)), 0)
    m = m.astype(np.int32)
    np_ = N // psegs
    for end in range(np_, N + 1, np_):
        for b in range(0, B, 2):
            k = int(rng.integers(1, 40))
            m[b, end - k] = k + int(rng.integers(1, 30))
        m[1, end - 6] = 6
        m[3, end - 2] = 3
        if end < N:
            m[5, end - 1] = 4
            m[5, end] = 40
    return m


def _edge_rows(N: int, chunk: int, seed: int) -> np.ndarray:
    """Rows against the design: every length 4, 5 and 7 (chains from
    different starts never meet), a 65535-long match over several chunks
    and one past the row's end, chains that exit exactly on each chunk
    edge or on the next one, a look-ahead across each chunk edge, one
    match over the whole row, chunk-long jumps, a match that ends on the
    last position and lengths below 4 at the edges."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((12, N)) < 0.3, rng.integers(0, 40, (12, N)), 0)
    m = m.astype(np.int32)
    edges = np.arange(chunk, N, chunk)
    m[0], m[1], m[2] = 4, 5, 7
    jump = min(65535, N - 3)
    m[3, :3] = 0
    m[3, 3] = jump                           # jumps over chunks
    m[4, N - 70:] = 65535                    # past the row's end
    m[5:10] = 0
    m[5, edges - 8] = 8                      # exits exactly on each edge
    m[6, edges - 1] = 4                      # look-ahead on the next chunk
    m[6, edges] = 9
    m[7, 0] = N                              # one match, the whole row
    m[8, edges - 2] = chunk + 2              # lands on the next edge
    m[9, 1::chunk] = 2 * chunk - 1           # chunk-long jumps
    m[10, N - 4] = 4                         # ends on the last position
    m[11, edges - 3] = 2                     # a length below 4 at an edge
    return m


def _want(m: np.ndarray, lazy: bool, psegs: int = 1) -> np.ndarray:
    return tpk.parse_greedy_twin(torch.from_numpy(m), lazy, psegs).numpy()


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_constants_match_the_wrapper():
    assert tpk.PARSE_CHUNK == THREADS * PIECE
    assert tpk.PARSE_STATUS_STRIDE == STATUS_STRIDE
    assert THREADS % WARP == 0 and PIECE % 16 == 0


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_equals_twin_psegs_1(size, lazy):
    C = size[0] * size[1]
    cases = [_content_rows(6, 16384, seed=1 + lazy),
             _content_rows(3, 131072, seed=3),
             _edge_rows(131072 if C > 64 else 8192, C, seed=5),
             _content_rows(2, 1000, seed=7),        # one partial chunk
             np.ascontiguousarray(_edge_rows(4100, C, seed=9)
                                  [:, :4099])]   # n % 4 != 0
    for m in cases:
        np.testing.assert_array_equal(_parse_model(m, lazy, 1, *size),
                                      _want(m, lazy))


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("psegs", [2, 4, 8])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_equals_twin_trunc(size, psegs, lazy):
    C = size[0] * size[1]
    N = 131072 if C > 64 else 8192
    cases = [_psegs_rows(6, N, psegs, seed=psegs + lazy),
             _edge_rows(N, C, seed=psegs)]
    for m in cases:
        got = _parse_model(m, lazy, psegs, *size)
        np.testing.assert_array_equal(got, _want(m, lazy, psegs))


@pytest.mark.parametrize("lazy", [False, True])
def test_model_equals_jax_at_a_small_size(lazy):
    """The model at chunks of 64 equals the JAX package's scan and its
    Pallas kernel (interpret mode), unsegmented and at psegs 4."""
    N = 8192
    m = np.concatenate([_content_rows(6, N, seed=11),
                        _edge_rows(N, 64, seed=12)])
    scan = np.asarray(jmp.parse_greedy_scan(jnp.asarray(m), lazy))
    pallas = np.asarray(jpk.parse_greedy_pallas(jnp.asarray(m),
                                                interpret=True, lazy=lazy))
    np.testing.assert_array_equal(scan, pallas)
    for size in SIZES[1:]:
        np.testing.assert_array_equal(_parse_model(m, lazy, 1, *size), scan)
    m = _psegs_rows(6, N, 4, seed=13)
    pallas = np.asarray(jpk.parse_greedy_pallas(
        jnp.asarray(m), interpret=True, lazy=lazy, psegs=4))
    for size in SIZES:
        np.testing.assert_array_equal(_parse_model(m, lazy, 4, *size),
                                      pallas)


def test_edge_rows_exercise_the_design():
    """At the kernel's chunk the edge rows do what they are for: the
    constant rows take every 4th, 5th and 7th position, the long match
    passes whole chunks (an entry past a chunk's end), chains exit
    exactly on chunk edges and look ahead across them."""
    C = THREADS * PIECE
    N = 131072
    m = _edge_rows(N, C, seed=5)
    edges = np.arange(C, N, C)
    for lazy in (False, True):
        chosen = _want(m, lazy)
        for row, d in ((0, 4), (1, 5), (2, 7)):
            assert chosen[row].sum() == (N - 1) // d + 1
        assert chosen[3, 3] and not chosen[3, 4:3 + 65535].any()
        assert 65535 // C >= 2
        assert chosen[5, edges - 8].all() and chosen[8, C - 2]
        assert chosen[6, edges - 1].all() != lazy
        assert chosen[6, edges].all() == lazy
        assert chosen[7, 0] and chosen[7].sum() == 1
