"""The CUDA kernels against their plain-torch twins, on a CUDA device.

Marked `cuda`: on a machine without a CUDA device every test here skips
(a kernel has no CPU mode). Run on the card with
`python -m pytest tests/test_torch_cuda.py -q`; chip_smoke.py repeats
these checks at the main path's full shapes.
"""

import contextlib
import json
import threading

import numpy as np
import pytest
import torch

import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import compress
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.ops import fse_kernel as fk
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import literals_kernel as lk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp
from qat_zstd_plugin_tpu_torch.ops import parse_kernel as pk
from qat_zstd_plugin_tpu_torch.ops import sort_kernel as tsk

torch.set_num_threads(2)  # six test workers share a few cores

pytestmark = pytest.mark.cuda

N = 131072
WINDOW = 32768


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _blocks(B=8, seed=0):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 8, (B, N), np.uint8)
    out[1] = rng.integers(0, 256, N, np.uint8)
    out[2] = 0x41
    out[B - 1, N // 2:] = out[0, :N // 2]
    return out


def test_hash_keys_winmin_sync(cuda):
    x = torch.from_numpy(_blocks()).to(cuda)
    for stride in (0, 32):
        k, m = tk.hash_keys_winmin_sync(x, 6, WINDOW, stride)
        tw_k, tw_m = tk.hash_keys_winmin_sync_twin(x, 6, WINDOW, stride)
        assert torch.equal(k, tw_k)
        assert (m is None and tw_m is None) or torch.equal(m, tw_m)


def test_neighbor_unsort_and_ldm_keys(cuda):
    k, m = tk.hash_keys_winmin_sync(torch.from_numpy(_blocks()).to(cuda), 6,
                                    WINDOW, 32)
    sk = tk._sort_rows(k)
    assert torch.equal(tk.neighbor_unsort_keys(sk, 15, 1, WINDOW - 1),
                       tk.neighbor_unsort_keys_twin(sk, 15, 1, WINDOW - 1))
    lk = tk.ldm_keys(m, 4, 32)
    assert torch.equal(lk, tk.ldm_keys_twin(m, 4, 32))
    slk = tk._sort_rows(lk)
    assert torch.equal(tk.neighbor_unsort_keys(slk, 15, 2),
                       tk.neighbor_unsort_keys_twin(slk, 15, 2))


def _flip_modes(kernel, twin, x):
    """kernel(x, 0) and kernel(x ^ sign, FLIP) against the twin's."""
    for a, f in ((x, 0), (x ^ tk._SIGN, tk._FLIP)):
        assert torch.equal(kernel(a, f), twin(a, f))


@pytest.mark.parametrize("neighbors", [1, 2, 3, 7, 100])
@pytest.mark.parametrize("width", [WINDOW, 4100, 4097])
def test_neighbor_unsort_keys_flip_modes(cuda, width, neighbors):
    """Full-resolution rows at every neighbors value, at a width with a
    part of a CTA (4100) and one of no multiple of 4 (4097, the scalar
    path), and one row."""
    x = torch.from_numpy(_blocks()).to(cuda)
    sk = tk._sort_rows(tk.hash_keys(x, 4, WINDOW))[:, :width].contiguous()
    for rows in (sk, sk[:1].contiguous()):
        _flip_modes(lambda a, f: tk.neighbor_unsort_keys(a, 15, neighbors,
                                                         flip=f),
                    lambda a, f: tk.neighbor_unsort_keys_twin(
                        a, 15, neighbors, None, f), rows)


@pytest.mark.parametrize("span,B", [(4, 4), (4, 8), (8, 8), (16, 16)])
def test_ldm_keys_flip_modes(cuda, span, B):
    """One span (all context the fill), two spans, spans 8 and 16, and
    1027 samples a block."""
    x = torch.from_numpy(_blocks(B, seed=span)).to(cuda)
    stride = tk.ldm_stride(span, N)
    _, m = tk.hash_keys_winmin(x, 4, WINDOW, stride)
    for minz in (m, m[:, :32 * 1027].contiguous()):
        s = tk.ldm_stride(span, minz.shape[1])
        _flip_modes(lambda a, f: tk.ldm_keys(a, span, s, flip=f),
                    lambda a, f: tk.ldm_keys_twin(a, span, s, f), minz)


def test_unsorted_chains_card_vs_cpu(cuda):
    """_unsorted and ldm_unsorted (signed sorts, K2 and K3 flipped) on
    the card equal the same on the CPU."""
    x = torch.from_numpy(_blocks()).to(cuda)
    k, m = tk.hash_keys_winmin_sync(x, 6, WINDOW, 32)
    assert torch.equal(tk._unsorted(k, 15, 1, WINDOW - 1).cpu(),
                       tk._unsorted(k.cpu(), 15, 1, WINDOW - 1))
    assert torch.equal(tk.ldm_unsorted(m, 4).cpu(),
                       tk.ldm_unsorted(m.cpu(), 4))



K1_SHAPES = {"B=8, N=131072": (8, N), "B=37, N=65536": (37, 65536),
             "B=64, N=4100": (64, 4100), "B=3, N=4098": (3, 4098),
             "B=2, N=6": (2, 6)}


@pytest.mark.parametrize("shape", sorted(K1_SHAPES))
@pytest.mark.parametrize("stride", [0, 1, 2, 4, 32, 64, 128, 256, 4096])
def test_hash_keys_winmin_sync_samples_and_plane(cuda, stride, shape):
    """K1 with the samples and with the plane, flip 0 and the sign flip,
    on the corpus-like, random, all-same and copied rows, at a row that
    ends inside a warp's tile (4100), one of n % 4 == 2 (4098) and one of
    6 bytes."""
    B, n = K1_SHAPES[shape]
    x = torch.from_numpy(_blocks(max(B, 8))[:B, :n].copy()).to(cuda)
    for samples in (True, False):
        for flip in (0, tk._FLIP):
            got = tk.hash_keys_winmin_sync(x, 6, WINDOW, stride, flip,
                                           samples)
            want = tk.hash_keys_winmin_sync_twin(x, 6, WINDOW, stride, flip,
                                                 samples)
            assert torch.equal(got[0], want[0])
            assert (got[1] is None and want[1] is None) or \
                torch.equal(got[1], want[1])


def test_ldm_keys_on_samples(cuda):
    """K3 on K1's samples at stride 1 gives the words of K3 on the plane
    at stride 32."""
    x = torch.from_numpy(_blocks()).to(cuda)
    _, m = tk.hash_keys_winmin_sync(x, 6, WINDOW, 32)
    _, s = tk.hash_keys_winmin_sync(x, 6, WINDOW, 32, samples=True)
    for flip in (0, tk._FLIP):
        got = tk.ldm_keys(s, 4, 1, flip=flip)
        assert torch.equal(got, tk.ldm_keys(m, 4, 32, flip=flip))
        assert torch.equal(got, tk.ldm_keys_twin(s, 4, 1, flip))


@pytest.mark.parametrize("span", [0, 4])
def test_compact_slots_sync_flip_modes(cuda, span):
    """K4 with and without the LDM rows, flip 0 (unsigned words) and the
    sign flip (the signed sorts' words), ragged lengths."""
    x = torch.from_numpy(_blocks()).to(cuda)
    lengths = torch.from_numpy(LENGTHS).to(cuda)
    k, s = tk.hash_keys_winmin_sync(x, 6, WINDOW, 32, samples=True)
    su = tk._unsorted(k, 15, 1, WINDOW - 1)
    su_l = tk.ldm_unsorted(s, 4, 1, stride=1) if span else None
    want = tk.compact_slots_sync_twin(su, WINDOW, lengths, 6, su_l, span)
    assert torch.equal(tk.compact_slots_sync(su, WINDOW, lengths, 6, su_l,
                                             span), want)
    flipped = None if su_l is None else su_l ^ tk._SIGN
    assert torch.equal(tk.compact_slots_sync(
        su ^ tk._SIGN, WINDOW, lengths, 6, flipped, span, flip=tk._FLIP),
        want)


def test_compact_slots_sync_odd_slot_count(cuda):
    """Blocks of 4100 bytes: 1025 slots, the kernel's guarded path."""
    x = torch.from_numpy(_blocks()[:, :4100].copy()).to(cuda)
    lengths = torch.from_numpy(np.minimum(LENGTHS, 4100)).to(cuda)
    k, _ = tk.hash_keys_winmin_sync(x, 6, WINDOW, 0)
    su = tk._unsorted(k, 13, 1, 4099)
    for flip, words in ((0, su), (tk._FLIP, su ^ tk._SIGN)):
        assert torch.equal(
            tk.compact_slots_sync(words, 4100, lengths, 6, flip=flip),
            tk.compact_slots_sync_twin(words, 4100, lengths, 6, flip=flip))

LENGTHS = np.array([N, N - 1, N // 2, 100, 0, N, N, 7], np.int32)
L1_KERNELS = ("hash_keys_winmin_sync", "neighbor_unsort_keys", "ldm_keys",
              "compact_slots_sync")
CONTENT_KERNELS = ("ldm_winmin", "parse_greedy")
HYBRID_ONLY = ("gram_pos_planes", "neighbor_verify_keys", "finalize_verified",
               "fse_state", "literal_keys",
               "byte_hist")  # kernels of device entropy alone
NO_LEVEL = ("compact_slots", "compact_operands",
            "bitonic_sort")  # kernels that no level's path launches


def test_slot_words_card_vs_cpu(cuda):
    blocks = _blocks()
    kw = dict(window=WINDOW, ldm=4, dense=True, sync=True)
    tk.reset_launches()
    got = tmp.find_matches_positions(torch.from_numpy(blocks).to(cuda),
                                     torch.from_numpy(LENGTHS).to(cuda),
                                     **kw).cpu()
    assert all(tk.launches[k] > 0 for k in L1_KERNELS)
    want = tmp.find_matches_positions(torch.from_numpy(blocks),
                                      torch.from_numpy(LENGTHS), **kw)
    assert torch.equal(got, want)


def test_frames_card_vs_cpu(cuda):
    data = _blocks(B=4, seed=1).tobytes() + b"tail" * 1000
    assert compress(data, batch=4, device="cuda") == \
        compress(data, batch=4, device="cpu")


@pytest.mark.parametrize("level", [1, 4, 9])
def test_compress_mesh_card_vs_cpu(cuda, level):
    """compress_mesh in a world of one: the card's frame equals the CPU's,
    cut into one-span device calls too, and the level's kernels ran."""
    from qat_zstd_plugin_tpu_torch.parallel import pipeline
    data = _blocks(B=8, seed=2).tobytes() + b"tail" * 1000
    want = pipeline.compress_mesh(data, level=level, device="cpu")
    tk.reset_launches()
    assert pipeline.compress_mesh(data, level=level, device="cuda") == want
    assert tk.launches["neighbor_unsort_keys"] > 0
    assert pipeline._compress_mesh(data, None, level, True, 16384, N,
                                   "cuda", 1) == want


def test_sharded_positions_step_card_vs_cpu(cuda):
    from qat_zstd_plugin_tpu_torch.parallel import mesh
    blocks = _blocks()
    m = mesh.make_mesh()
    got = mesh.sharded_positions_step(m)(blocks, LENGTHS).cpu()
    want = mesh.sharded_positions_step(m, device="cpu")(blocks, LENGTHS)
    assert torch.equal(got, want)


def test_hash_keys_and_winmin(cuda):
    x = torch.from_numpy(_blocks()).to(cuda)
    for width in (4, 5, 6, 8):
        assert torch.equal(tk.hash_keys(x, width, WINDOW),
                           tk.hash_keys_twin(x, width, WINDOW))
    for stride in (1, 2, 32, 64):
        k, m = tk.hash_keys_winmin(x, 5, WINDOW, stride)
        tw_k, tw_m = tk.hash_keys_winmin_twin(x, 5, WINDOW, stride)
        assert torch.equal(k, tw_k) and torch.equal(m, tw_m)


WINMIN_SHAPES = [(8, N), (37, 65536), (64, 4100), (1, 8)]


def _winmin_blocks(B, n, seed=4):
    """_blocks' rows (low alphabet, random, one byte, a copy) cut to n
    bytes, cycled over B rows."""
    return np.resize(_blocks(seed=seed)[:, :n], (B, n))


@pytest.mark.parametrize("shape", WINMIN_SHAPES,
                         ids=[f"{b}x{n}" for b, n in WINMIN_SHAPES])
@pytest.mark.parametrize("stride", [1 << s for s in range(13)])
def test_winmin_every_stride(cuda, stride, shape):
    """B6 in both flip modes and B9 equal their twins at every stride the
    wrappers take, 256-4096 through the stride-128 plane in scratch."""
    x = torch.from_numpy(_winmin_blocks(*shape)).to(cuda)
    for flip in (0, tk._FLIP):
        k, m = tk.hash_keys_winmin(x, 4, WINDOW, stride, flip=flip)
        tw_k, tw_m = tk.hash_keys_winmin_twin(x, 4, WINDOW, stride, flip)
        assert torch.equal(k, tw_k) and torch.equal(m, tw_m)
    assert torch.equal(tk.ldm_winmin(x, stride), tw_m)


@pytest.mark.parametrize("width", [4, 5, 6, 8])
def test_hash_keys_flip_modes(cuda, width):
    for shape in WINMIN_SHAPES:
        x = torch.from_numpy(_winmin_blocks(*shape, seed=width)).to(cuda)
        for flip in (0, tk._FLIP):
            assert torch.equal(tk.hash_keys(x, width, WINDOW, flip=flip),
                               tk.hash_keys_twin(x, width, WINDOW, flip))


def _sus(x, widths, neighbors=2):
    pbits = (min(WINDOW, x.shape[1]) - 1).bit_length()
    return [tk._unsorted(tk.hash_keys(x, w, WINDOW), pbits, neighbors)
            for w in widths]


FINALIZE_SHAPES = [(8, N), (37, N), (8, 4100)]


def _finalize_case(cuda, B, n):
    """Blocks and lengths for B7 and B13: at (8, N) _blocks() (an all-same
    row, length 0) with a run longer than 16383; else B rows of n bytes
    with an all-same row, a run to the row's end, a run past the cap
    where it fits, short runs, and lengths 0, 1, 3, 4, n - 10 and n."""
    if (B, n) == (8, N):
        blocks, lengths = _blocks(), LENGTHS
        blocks[3, 1000:40000] = 7  # a run longer than 16383
    else:
        rng = np.random.default_rng(B)
        blocks = rng.integers(0, 4, (B, n), np.uint8)
        blocks[0] = 0x41
        blocks[1, n // 3:] = 9
        blocks[2, n // 5:n // 5 + 16385] = 7
        blocks[3] = rng.integers(0, 256, n, np.uint8)
        lengths = rng.integers(0, n + 1, B).astype(np.int32)
        lengths[:7] = (n, n, n - 10, 0, 1, 3, 4)
    return (torch.from_numpy(blocks).to(cuda),
            torch.from_numpy(lengths).to(cuda))


@pytest.mark.parametrize("shape", FINALIZE_SHAPES,
                         ids=["8xN", "37xN", "8x4100"])
@pytest.mark.parametrize("widths", [(6,), (5, 8), (4, 5, 6, 8)])
def test_finalize_candidates(cuda, widths, shape):
    x, lengths = _finalize_case(cuda, *shape)
    sus = _sus(x, widths)
    ml, mo = tk.finalize_candidates(sus, x, lengths, widths, WINDOW)
    tw_ml, tw_mo = tk.finalize_candidates_twin(sus, x, lengths, widths,
                                               WINDOW)
    assert torch.equal(ml, tw_ml) and torch.equal(mo, tw_mo)


@pytest.mark.parametrize("ldm", [0, 4])
def test_compact_slots_dense(cuda, ldm):
    x = torch.from_numpy(_blocks()).to(cuda)
    lengths = torch.from_numpy(LENGTHS).to(cuda)
    widths = (4, 5, 6, 8)
    ml, mo = tk.finalize_candidates(_sus(x, widths), x, lengths, widths,
                                    WINDOW)
    est = off = None
    if ldm:
        _, m = tk.hash_keys_winmin(x, 6, WINDOW, 32)
        est, off = tk._ldm_est(tk.ldm_unsorted(m, ldm), lengths, N, ldm,
                               1 << 19)
    for cap in (24, 32):
        assert torch.equal(
            tk.compact_slots_dense(ml, mo, WINDOW, est, off, cap),
            tk.compact_slots_dense_twin(ml, mo, WINDOW, est, off, cap))


@pytest.mark.parametrize("span", [0, 4, 8, 16])
def test_compact_slots_dense_spans(cuda, span):
    """B8 on level 4's claims at every LDM span the levels take (sample
    slots every 8 and 16 slots: the shift path) and without LDM, on 16
    blocks where block 5 repeats half of block 4 (LDM claims)."""
    blocks = _blocks(B=16)
    blocks[5, :N // 2] = blocks[4, N // 2:]
    x = torch.from_numpy(blocks).to(cuda)
    lengths = torch.from_numpy(np.tile(LENGTHS, 2)).to(cuda)
    widths = (4, 5, 6, 8)
    ml, mo = tk.finalize_candidates(_sus(x, widths), x, lengths, widths,
                                    WINDOW)
    est = off = None
    if span:
        _, m = tk.hash_keys_winmin(x, 6, WINDOW, tk.ldm_stride(span, N))
        est, off = tk._ldm_est(tk.ldm_unsorted(m, span), lengths, N, span,
                               1 << 19)
        assert int((est > 0).sum()) > 0
    for cap in (24, 32):
        assert torch.equal(
            tk.compact_slots_dense(ml, mo, WINDOW, est, off, cap),
            tk.compact_slots_dense_twin(ml, mo, WINDOW, est, off, cap))


@pytest.mark.parametrize("n,spb", [
    (4100, 0), (4100, 1025), (4100, 41), (4100, 5), (4100, 205),
    (4104, 513), (4104, 0), (4096, 256), (4096, 1024), (6144, 128),
    (4608, 384), (4608, 9)])
def test_compact_slots_dense_ragged_rows(cuda, n, spb):
    """B8 on seeded claim planes at rows whose slot count 4 does not
    divide (4100, 4104: the guarded path), a partial last chunk, and
    sample spacings of 1, 2, 3, 4, 5, 12, 25, 128 and 205 slots: powers of
    two of at least four take the shift path, the others 32-bit % and
    /."""
    rng = np.random.default_rng(n + spb)
    B = 6
    ml = rng.integers(0, 48, (B, n)).astype(np.int32)
    ml[:, ::7] = rng.integers(-3, 300, (B, -(-n // 7)))
    mo = rng.integers(0, WINDOW, (B, n)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    est = off = None
    if spb:
        est = t(rng.integers(0, 260, (B, spb)).astype(np.int32))
        off = t(rng.integers(1, 1 << 19, (B, spb)).astype(np.int32))
    for cap in (24, 32):
        got = tk.compact_slots_dense(t(ml), t(mo), n, est, off, cap)
        assert torch.equal(got, tk.compact_slots_dense_twin(
            t(ml), t(mo), n, est, off, cap))


def test_l4_frames_card_vs_cpu(cuda):
    data = _blocks(B=8, seed=2).tobytes() + b"tail" * 1000
    tk.reset_launches()
    on_card = compress(data, level=4, batch=8, device="cuda")
    assert all(n > 0 for k, n in tk.launches.items() if k not in L1_KERNELS
               + CONTENT_KERNELS + HYBRID_ONLY + NO_LEVEL
               and k != "hash_keys_winmin")  # 8 < 16: no LDM
    assert on_card == compress(data, level=4, batch=8, device="cpu")


@pytest.mark.parametrize("stride", [32, 64])
def test_ldm_winmin(cuda, stride):
    x = torch.from_numpy(_blocks()).to(cuda)
    assert torch.equal(tk.ldm_winmin(x, stride), tk.ldm_winmin_twin(x, stride))
    assert torch.equal(tk.ldm_winmin(x, stride),
                       tk.hash_keys_winmin(x, 6, WINDOW, stride)[1])


def _parse_rows(B=8, n=N, seed=3):
    """All-zero rows, rows with every length >= 4, matches across the
    kernel's 4096-position chunk edges, lazy ties, a match that ends exactly
    at n and one that passes it."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((B, n)) < 0.3, rng.integers(0, 40, (B, n)), 0)
    m = m.astype(np.int32)
    m[0] = 0
    m[1] = rng.integers(4, 9, n)
    m[2] = 7
    m[3, 4096 - 5::4096] = 30
    m[4, n - 20] = 20
    m[5, n - 3:] = 60
    return m


@pytest.mark.parametrize("lazy", [False, True])
def test_parse_greedy(cuda, lazy):
    for mlen in (_parse_rows(), _parse_rows(B=6, n=20000, seed=4)):
        m = torch.from_numpy(mlen).to(cuda)
        got = pk.parse_greedy(m, lazy)
        assert torch.equal(got, pk.parse_greedy_twin(m, lazy))
        assert torch.equal(got.cpu(), pk.parse_greedy(m.cpu(), lazy))


@pytest.mark.parametrize("lazy", [False, True])
def test_parse_greedy_edges(cuda, lazy):
    """B10 on the design's edges: rows of a length that is no multiple of
    4 or 16 (scalar loads and byte stores), one position, one partial
    chunk, constant lengths (chains that never meet), the crafted rows
    (jumps over whole chunks, exits on chunk edges), psegs 1, 2 and 4,
    and a launch counted once a call."""
    from qat_zstd_plugin_tpu_torch.designs.parse import crafted_lengths
    rng = np.random.default_rng(7)
    rows = [crafted_lengths(16, 131072, rng), np.full((5, 8196), 5, np.int32),
            np.full((3, 4), 4, np.int32), np.full((3, 1), 9, np.int32),
            _parse_rows(B=6, n=4099, seed=5), _parse_rows(B=6, n=2002,
                                                          seed=6),
            np.full((2, 12), 7, np.int32)]
    for mlen in rows:
        m = torch.from_numpy(mlen).to(cuda)
        for psegs in (1, 2, 4):
            if m.shape[1] % psegs:
                continue
            tk.reset_launches()
            got = pk.parse_greedy(m, lazy, psegs)
            assert tk.launches["parse_greedy"] == 1
            assert torch.equal(got, pk.parse_greedy_twin(m, lazy, psegs))


def test_content_frames_card_vs_cpu(cuda):
    data = _blocks(B=8, seed=5).tobytes() + b"tail" * 1000
    tk.reset_launches()
    on_card = compress(data, level=5, batch=4, device="cuda")
    assert all(tk.launches[k] > 0 for k in ("ldm_winmin", "ldm_keys",
                                            "neighbor_unsort_keys",
                                            "parse_greedy"))
    assert on_card == compress(data, level=5, batch=4, device="cpu")


def test_gram_pos_planes_and_neighbor_verify_keys(cuda):
    x = torch.from_numpy(_blocks()).to(cuda)
    g, p = tk.gram_pos_planes(x, WINDOW)
    tw_g, tw_p = tk.gram_pos_planes_twin(x, WINDOW)
    assert torch.equal(g, tw_g) and torch.equal(p, tw_p)
    sg, sp = tk._sort_rows2(g, p, 15)
    for neighbors in (1, 2):
        assert torch.equal(tk.neighbor_verify_keys(sg, sp, 15, neighbors),
                           tk.neighbor_verify_keys_twin(sg, sp, 15,
                                                        neighbors))


@pytest.mark.parametrize("shape", FINALIZE_SHAPES,
                         ids=["8xN", "37xN", "8x4100"])
def test_finalize_verified(cuda, shape):
    x, lengths = _finalize_case(cuda, *shape)
    pbits = (min(WINDOW, x.shape[1]) - 1).bit_length()
    sg, sp = tk._sort_rows2(*tk.gram_pos_planes(x, WINDOW), pbits)
    su = tk._sort_rows(tk.neighbor_verify_keys(sg, sp, pbits, 2))
    ml, mo = tk.finalize_verified(su, x, lengths)
    tw_ml, tw_mo = tk.finalize_verified_twin(su, x, lengths)
    assert torch.equal(ml, tw_ml) and torch.equal(mo, tw_mo)


def test_finalize_odd_row_length(cuda):
    """Rows of 4099 bytes: no row but the first starts on a 4-byte
    boundary, so the kernels stage bytes and key words one at a time."""
    x, lengths = _finalize_case(cuda, 7, 4099)
    rng = np.random.default_rng(5)
    keys = [torch.from_numpy(rng.integers(0, 1 << 31, x.shape)
                             .astype(np.int32)
                             & np.int32(rng.choice([3, 4095]))).to(cuda)
            for _ in range(4)]
    widths = (4, 5, 6, 8)
    got = tk.finalize_candidates(keys, x, lengths, widths, WINDOW)
    want = tk.finalize_candidates_twin(keys, x, lengths, widths, WINDOW)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = tk.finalize_verified(keys[0], x, lengths)
    want = tk.finalize_verified_twin(keys[0], x, lengths)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_finalize_run_scratch_checked(cuda):
    """The entry points refuse a pre-pass scratch of fewer words than one
    a tile of every row; the wrappers refuse more rows than the grid
    holds."""
    x, lengths = _finalize_case(cuda, 37, N)
    pbits = (WINDOW - 1).bit_length()
    su = _sus(x, (6,))[0]
    mlen, moff, scratch = tk._run_outputs("finalize_verified", x)
    assert scratch.numel() == 37 * (N // tk.RUN_TILE)
    for name, args in (
            ("finalize_verified", (su, x, lengths, mlen, moff, scratch, 37,
                                   N, pbits)),
            ("finalize_candidates", (su, None, None, None, x, lengths, mlen,
                                     moff, scratch, 37, N, 1, 6, 0, 0, 0,
                                     pbits))):
        with pytest.raises(RuntimeError, match="invalid argument"):
            tk._launch(name, *args, scratch.numel() - 1)
        tk._launch(name, *args, scratch.numel())
    rows = torch.zeros((tk.MAX_RUN_ROWS + 1, 4), dtype=torch.uint8,
                       device=cuda)
    with pytest.raises(ValueError, match="rows"):
        tk.finalize_verified(torch.zeros((rows.shape[0], 4),
                                         dtype=torch.int32, device=cuda),
                             rows, torch.zeros(rows.shape[0],
                                               dtype=torch.int32,
                                               device=cuda))


def _crafted_sequences(cuda, S=16384, seed=7, B=8):
    """Blocks of 0, 1, S and in-between sequence counts (and with B > 8
    random ones), literal and match lengths past 65535 and offsets to
    2^17."""
    rng = np.random.default_rng(seed)
    nseq = np.array([0, 1, S, 5000, 127, 128, S - 1, 3], np.int32)
    nseq = np.concatenate([nseq, rng.integers(0, S + 1, B - len(nseq))])
    nseq = np.minimum(nseq, S).astype(np.int32)
    ll = rng.integers(0, 300, (B, S)).astype(np.int32)
    ll[:, ::7] = rng.integers(0, 70000, (B, -(-S // 7)))
    ml = rng.integers(3, 40, (B, S)).astype(np.int32)
    ml[:, ::11] = rng.integers(3, 70000, (B, -(-S // 11)))
    of = rng.integers(1, 1 << 17, (B, S)).astype(np.int32)
    return [torch.from_numpy(a).to(cuda) for a in (ll, of, ml, nseq)]


@pytest.mark.parametrize("custom", [False, True])
def test_fse_state_machine(cuda, custom):
    x = torch.from_numpy(_blocks()).to(cuda)
    lengths = torch.from_numpy(LENGTHS).to(cuda)
    out = tmp.verified_sequences(x, lengths)[0]
    batches = [(out["lit_len"], out["offset"], out["match_len"],
                out["nseq"]), _crafted_sequences(cuda),
               _crafted_sequences(cuda, S=2048, seed=8, B=37)]
    for seqs in batches:
        args = fk.prepare_sections(*seqs, custom=custom)["state_args"]
        lo, nb = fk.run_state_kernel(*args)
        tw_lo, tw_nb = fk.run_state_kernel_twin(*args)
        assert torch.equal(lo, tw_lo) and torch.equal(nb, tw_nb)
        on_cpu = fk.encode_sequence_sections(*(t.cpu() for t in seqs),
                                             custom=custom)
        on_card = fk.encode_sequence_sections(*seqs, custom=custom)
        for got, want in zip(on_card[:3], on_cpu[:3]):
            assert torch.equal(got.cpu(), want)


HYBRID_KERNELS = {1: ("gram_pos_planes", "neighbor_verify_keys",
                      "finalize_verified", "parse_greedy", "fse_state"),
                  9: ("parse_greedy", "fse_state")}


@pytest.mark.parametrize("level", sorted(HYBRID_KERNELS))
def test_hybrid_frames_card_vs_cpu(cuda, level):
    data = _blocks(B=4, seed=6).tobytes() + b"tail" * 1000
    tk.reset_launches()
    on_card = compress(data, level=level, batch=4, device="cuda",
                       device_entropy="hybrid")
    assert all(tk.launches[k] > 0 for k in HYBRID_KERNELS[level])
    assert on_card == compress(data, level=level, batch=4, device="cpu",
                               device_entropy="hybrid")


def _long_matches(B=8, n=N, seed=8):
    """(chosen, mlen): sparse short matches, chosen matches of 16383 to
    65535 bytes, matches across the 2048-position tiles of B15 and ones
    that end at or pass n."""
    rng = np.random.default_rng(seed)
    chosen = rng.random((B, n)) < 0.02
    mlen = rng.integers(4, 41, (B, n)).astype(np.int32)
    for row, length in enumerate((16383, 16384, 16385, 40000, 65535)):
        chosen[row, 10 + row], mlen[row, 10 + row] = True, length
    chosen[5, 2045::2048], mlen[5, 2045::2048] = True, 2100
    chosen[6, n - 50], mlen[6, n - 50] = True, 50
    chosen[7, n - 20], mlen[7, n - 20] = True, 65535
    return chosen, mlen


def test_literal_keys_and_byte_hist(cuda):
    blocks = _blocks()
    x = torch.from_numpy(blocks).to(cuda)
    lengths = torch.from_numpy(LENGTHS).to(cuda)
    _, chosen, mlen = tmp.content_sequences(x, lengths, lazy=True)
    long_ch, long_ml = (torch.from_numpy(a).to(cuda) for a in _long_matches())
    for ch, ml in ((chosen, mlen), (long_ch, long_ml)):
        keys = lk.literal_keys(x, lengths, ch, ml)
        assert torch.equal(keys, lk.literal_keys_twin(x, lengths, ch, ml))
        assert torch.equal(keys.cpu(), lk.literal_keys(
            x.cpu(), lengths.cpu(), ch.cpu(), ml.cpu()))
        assert torch.equal(lk.byte_hist(keys), lk.byte_hist_twin(keys))


def _lit_args(dev, chosen, mlen, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    B, n = chosen.shape
    blocks = rng.integers(0, 256, (B, n), np.uint8)
    if lengths is None:
        lengths = np.full(B, n, np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (blocks, lengths, chosen, mlen))


def test_literal_keys_carry_from_tile_zero(cuda):
    """One chosen match from position 0 of length N on every row: every
    later tile's keys rest on tile 0's carry through the look-back. 200
    calls in a row, each exact."""
    B = 64
    chosen = np.zeros((B, N), bool)
    chosen[:, 0] = True
    mlen = np.zeros((B, N), np.int32)
    mlen[:, 0] = N
    mlen[1::2, 0] = N - 1  # the row's last position stays a literal
    args = _lit_args(cuda, chosen, mlen)
    want = lk.literal_keys_twin(*args)
    assert int((want != -1).sum()) == B // 2
    for _ in range(200):
        assert torch.equal(lk.literal_keys(*args), want)


@pytest.mark.parametrize("B", [1, 64, 300])
def test_literal_keys_rows(cuda, B):
    """B15 on 1, 64 and 300 rows of the seeded long matches, ragged
    lengths, with lengths near 2**31 that the clamped ends must keep."""
    chosen, mlen = _long_matches(B=max(B, 8), seed=B)
    chosen, mlen = chosen[:B], mlen[:B]
    chosen[-1, 5], mlen[-1, 5] = True, 2**31 - 1
    chosen[0, N // 2], mlen[0, N // 2] = True, 2**31 - 7
    lengths = np.random.default_rng(B).integers(0, N + 1, B).astype(
        np.int32)
    args = _lit_args(cuda, chosen, mlen, B, lengths)
    assert torch.equal(lk.literal_keys(*args), lk.literal_keys_twin(*args))


def test_literal_keys_back_to_back(cuda):
    """Two B15 calls in a row on different inputs (the second reuses the
    first's scratch from the allocator): both exact."""
    a = _lit_args(cuda, *_long_matches(seed=1), seed=1)
    ch, ml = _long_matches(seed=2)
    ml[:, ::3] = 0
    b = _lit_args(cuda, ch, ml, seed=2)
    got_a = lk.literal_keys(*a)
    got_b = lk.literal_keys(*b)
    assert torch.equal(got_a, lk.literal_keys_twin(*a))
    assert torch.equal(got_b, lk.literal_keys_twin(*b))


def test_encode_literals_device_card_vs_cpu(cuda):
    x = torch.from_numpy(_blocks()).to(cuda)
    lengths = torch.from_numpy(LENGTHS).to(cuda)
    _, chosen, mlen = tmp.verified_sequences(x, lengths)
    on_card = lk.encode_literals_device(x, lengths, chosen, mlen)
    on_cpu = lk.encode_literals_device(x.cpu(), lengths.cpu(), chosen.cpu(),
                                       mlen.cpu())
    assert sorted(on_card) == sorted(on_cpu)
    for k, v in on_cpu.items():
        assert torch.equal(on_card[k].cpu(), v), k


@pytest.mark.parametrize("level", sorted(HYBRID_KERNELS))
def test_full_frames_card_vs_cpu(cuda, level):
    data = _blocks(B=4, seed=9).tobytes() + b"tail" * 1000
    tk.reset_launches()
    on_card = compress(data, level=level, batch=4, device="cuda",
                       device_entropy=True)
    assert all(tk.launches[k] > 0 for k in HYBRID_KERNELS[level]
               + ("literal_keys", "byte_hist"))
    assert on_card == compress(data, level=level, batch=4, device="cpu",
                               device_entropy=True)


@pytest.mark.parametrize("lazy", [False, True])
def test_compact_slots_parsed_and_dense(cuda, lazy):
    """B17 on the parse of the parsed branch (one claim a slot) and on a
    dense mask (up to four), bool and int32; the branch on the card equals
    the branch on the CPU."""
    blocks = _blocks()
    x = torch.from_numpy(blocks).to(cuda)
    lengths = torch.from_numpy(LENGTHS).to(cuda)
    ml, mo = tk.candidates_hash_split(x, lengths, (5, 8), 1, WINDOW)
    for chosen in (pk.parse_greedy(ml, lazy), ml >= 4,
                   (ml >= 4).to(torch.int32)):
        assert torch.equal(tk.compact_slots(chosen, mo, WINDOW),
                           tk.compact_slots_twin(chosen, mo, WINDOW))
    kw = dict(widths=(5, 8), window=WINDOW, ldm=4, dense=False, lazy=lazy)
    tk.reset_launches()
    got = tmp.find_matches_positions(x, lengths, **kw).cpu()
    assert tk.launches["compact_slots"] > 0
    assert torch.equal(got, tmp.find_matches_positions(
        torch.from_numpy(blocks), torch.from_numpy(LENGTHS), **kw))


def test_compact_operands_and_fast_glue(cuda):
    """B18 at nseg 4, 32 and 1, with payloads past 16 bits, and
    compact_fast_glue's dict on the card against the CPU."""
    blocks = _blocks()
    x = torch.from_numpy(blocks).to(cuda)
    lengths = torch.from_numpy(LENGTHS).to(cuda)
    ml, mo = tk.candidates_hash_split(x, lengths, (5, 8), 1, WINDOW)
    chosen = pk.parse_greedy(ml, True)
    wide = ml * 70001  # payloads that reach into the position key
    for window, cols in ((WINDOW, N), (4096, N), (WINDOW, WINDOW)):
        for args in ((chosen, ml, mo), (chosen.to(torch.int32), wide, mo)):
            args = [a[:, :cols].contiguous() for a in args]
            for g, w in zip(tk.compact_operands(*args, window),
                            tk.compact_operands_twin(*args, window)):
                assert torch.equal(g, w)
    for max_seq in (16384, 1024):
        on_card = tk.compact_fast_glue(chosen, ml, mo, lengths, max_seq,
                                       WINDOW)
        on_cpu = tk.compact_fast_glue(chosen.cpu(), ml.cpu(), mo.cpu(),
                                      lengths.cpu(), max_seq, WINDOW)
        assert sorted(on_card) == sorted(on_cpu)
        for k, v in on_cpu.items():
            assert torch.equal(on_card[k].cpu(), v), k


@pytest.mark.parametrize("n", [1024, 8192, 16384, 32768, 131072, 262144])
def test_bitonic_sort(cuda, n):
    """B19 against its twin (the same network) at rows of one CTA, of a
    cluster of 2 and of 8, and past a cluster (device-memory passes):
    random keys, heavy duplicates and duplicate (key, pos) pairs, with 0,
    1 and 9 payloads (the last launch gathers eight, a gather kernel the
    ninth)."""
    rng = np.random.default_rng(n)
    B = {131072: 4, 262144: 2}.get(n, 8)
    kinds = {
        "random": (rng.integers(-2**31, 2**31, (B, n), np.int64),
                   np.broadcast_to(np.arange(n), (B, n))),
        "dup_keys": (rng.integers(0, 17, (B, n)),
                     np.broadcast_to(np.arange(n), (B, n))),
        "dup_pairs": (rng.integers(-2, 2, (B, n)),
                      rng.integers(-3, 3, (B, n))),
    }
    for key, pos in kinds.values():
        key, pos = (torch.from_numpy(np.ascontiguousarray(a, np.int32))
                    .to(cuda) for a in (key, pos))
        for npay in (0, 1, 9):
            pay = [torch.from_numpy(rng.integers(-2**31, 2**31, (B, n),
                                                 np.int64).astype(np.int32))
                   .to(cuda) for _ in range(npay)]
            got = tsk.bitonic_sort(key, pos, *pay)
            want = tsk.bitonic_sort_twin(key, pos, *pay)
            assert len(got) == len(want) == 2 + npay
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.parametrize("geometry, refused", [
    ({"GROUP_BITS": 5}, True),     # five stages on a 16-column group
    ({"CTA_ELEMS": 8192}, True),   # a cross-CTA step inside one CTA
    ({"CTA_ELEMS": 32768}, True),  # a register step across two CTAs
    ({"SPAN": 262144}, True),      # a cross-CTA step across two clusters
    ({"SPAN": 65536}, False),      # more device-memory passes
    ({"GROUP_BITS": 3}, False),    # smaller register groups
])
def test_bitonic_sort_plan_geometry(cuda, monkeypatch, geometry, refused):
    """sort_plan's copy of csrc/sort_kernels.cu's geometry cannot drift
    silently: a plan that pairs columns no thread, CTA or cluster of the
    kernel holds is refused; one that pairs only columns they hold sorts
    as the twin does."""
    rng = np.random.default_rng(5)
    n = 262144
    key, pos, pay = (torch.from_numpy(rng.integers(
        -2**31, 2**31, (1, n), np.int64).astype(np.int32)).to(cuda)
        for _ in range(3))
    for name, value in geometry.items():
        monkeypatch.setattr(tsk, name, value)
    tsk._plan_array.cache_clear()
    try:
        if refused:
            with pytest.raises(RuntimeError, match="invalid argument"):
                tsk.bitonic_sort(key, pos, pay)
        else:
            got = tsk.bitonic_sort(key, pos, pay)
            for g, w in zip(got, tsk.bitonic_sort_twin(key, pos, pay)):
                assert torch.equal(g, w)
    finally:
        tsk._plan_array.cache_clear()


@pytest.mark.parametrize("geometry, refused", [
    ({"MAP_STRIDE": 67}, True),  # maps scratch below the kernel's stride
    ({"PIECE": 65}, True),       # pieces past the kernel's staging
    ({"PIECE": 32}, False),      # shorter pieces
])
def test_fse_state_machine_scratch(cuda, monkeypatch, geometry, refused):
    """The wrapper's piece length and scratch are held to
    csrc/fse_kernels.cu's own: too little scratch or too long a piece is
    refused, a shorter piece gives the twin's items."""
    seqs = _crafted_sequences(cuda, S=2048, seed=9, B=37)
    args = fk.prepare_sections(*seqs, custom=True)["state_args"]
    for name, value in geometry.items():
        monkeypatch.setattr(fk, name, value)
    if refused:
        with pytest.raises(RuntimeError, match="invalid argument"):
            fk.run_state_kernel(*args)
    else:
        lo, nb = fk.run_state_kernel(*args)
        tw_lo, tw_nb = fk.run_state_kernel_twin(*args)
        assert torch.equal(lo, tw_lo) and torch.equal(nb, tw_nb)


@pytest.mark.parametrize("n", [131072, 70001, 4097, 64])
@pytest.mark.parametrize("level", [1, 4, 9])
def test_producer_triples_card_vs_cpu(cuda, level, n):
    """The sequence producer at batch 1 on ragged blocks: the kernels give
    the twins' triples, and the block went through the device half."""
    block = make_corpus(2 * N, seed=level)[N - 1000:N - 1000 + n]
    card = qzt.create_seqprod_state(level, device="cuda")
    got = qzt.sequence_producer(card, block)
    assert got == qzt.sequence_producer(
        qzt.create_seqprod_state(level, device="cpu"), block)
    assert card.device_blocks == 1 and card.errors == 0


def test_compress_via_libzstd_card_vs_cpu(cuda):
    data = make_corpus(3 * N + 5000, seed=1)
    got = qzt.compress_via_libzstd(data, level=1, device="cuda")
    assert qzt.oracle.last_producer_stats() == {"blocks": 4, "errors": 0}
    assert got == qzt.compress_via_libzstd(data, level=1, device="cpu")
    assert qzt.decompress(got, len(data)) == data


def test_benchmark_two_threads_on_the_card(cuda, tmp_path, capsys):
    """Two GpuCodecs from two host threads on the one card (benchmark -t 2
    -m 1): every thread PASS, K1-K4 launched, and the ratio of the card's
    frames equals the CPU twins' (-t 1 --device cpu)."""
    from qat_zstd_plugin_tpu_torch.tools import benchmark
    path = tmp_path / "in.bin"
    path.write_bytes(make_corpus(16 * N + 777, 3))
    argv = [str(path), "-m", "1", "-c", "1024", "--batch", "8", "--json"]
    tk.reset_launches()
    assert benchmark.run(argv + ["-t", "2"]) == 0
    launches = dict(tk.launches)
    out = capsys.readouterr().out.splitlines()
    threads = [ln for ln in out if ln.startswith("thread ")]
    assert len(threads) == 2 and all(ln.endswith("PASS") for ln in threads)
    for k in ("hash_keys_winmin_sync", "neighbor_unsort_keys", "ldm_keys",
              "compact_slots_sync"):
        assert launches[k] > 0, k
    got = json.loads([ln for ln in out if ln.startswith("{")][-1])
    assert benchmark.run(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    want = json.loads([ln for ln in out if ln.startswith("{")][-1])
    assert got["ok"] and got["ratio"] == want["ratio"]


def test_trace_names_the_l1_kernels(cuda, tmp_path):
    """utils.profiling.trace on the card records the kernels launched
    through ctypes: the trace names K1-K4's CUDA functions."""
    from qat_zstd_plugin_tpu_torch.utils import profiling
    data = make_corpus(8 * N + 777, 5)
    with profiling.trace(str(tmp_path)) as path:
        frame = compress(data, level=1, batch=8, device="cuda")
    assert qzt.decompress(frame, len(data)) == data
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    for k in ("hash_keys_winmin_sync_kernel", "neighbor_unsort_keys_kernel",
              "ldm_keys_kernel", "compact_slots_sync_kernel"):
        assert any(k in n for n in names), k


def _thread_inputs(n=8, size=2 * N + 777):
    return [make_corpus(size, seed=40 + t) for t in range(n)]


def _in_threads(fn, n):
    """fn(tid) in n threads started at a barrier; re-raises the first
    error."""
    barrier = threading.Barrier(n)
    errors = []

    def wrap(tid):
        try:
            barrier.wait(60)
            fn(tid)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(t,)) for t in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    if errors:
        raise errors[0]


@pytest.mark.parametrize("streams", [False, True],
                         ids=["current_stream", "stream_a_thread"])
def test_shared_codec_threads_on_the_card(cuda, streams):
    """One GpuCodec(level=1, batch=2) on the card from 8 threads x 3
    rounds, each on the current stream or inside a torch.cuda.Stream of
    its own: the frames equal the one-thread frames and the CPU twins',
    the counters balance, and each kernel's launches are exactly 24
    times one call's."""
    datas = _thread_inputs()
    codec = qzt.GpuCodec(level=1, batch=2, device="cuda")
    want = [codec.compress(d) for d in datas]
    assert want[0] == qzt.GpuCodec(level=1, batch=2,
                                   device="cpu").compress(datas[0])
    tk.reset_launches()
    codec.compress(datas[0])
    one = dict(tk.launches)
    in0, dev0 = codec.stats.input_bytes, codec.device_blocks
    rounds = 3
    got = [[None] * rounds for _ in datas]

    def work(tid):
        with torch.cuda.stream(torch.cuda.Stream()) if streams \
                else contextlib.nullcontext():
            for r in range(rounds):
                got[tid][r] = codec.compress(datas[tid])
            torch.cuda.current_stream().synchronize()

    tk.reset_launches()
    _in_threads(work, len(datas))
    counts = dict(tk.launches)
    assert all(g == [w] * rounds for g, w in zip(got, want))
    assert codec.stats.input_bytes - in0 == rounds * sum(map(len, datas))
    assert codec.device_blocks - dev0 == rounds * sum(
        len(d) // N for d in datas)
    calls = rounds * len(datas)
    assert one["compact_slots_sync"] > 0
    assert {k: counts[k] for k in one} == {k: calls * n
                                            for k, n in one.items()}


def test_producer_threads_on_the_card(cuda):
    """compress_via_libzstd on the card from 4 threads: each frame equals
    its one-thread frame and the CPU twins', and decodes."""
    datas = _thread_inputs(4, N + 5000)
    want = [qzt.compress_via_libzstd(d, level=1, device="cpu")
            for d in datas]
    got = [None] * 4

    def work(tid):
        got[tid] = qzt.compress_via_libzstd(datas[tid], level=1,
                                            device="cuda")

    _in_threads(work, 4)
    assert got == want
    for f, d in zip(got, datas):
        assert qzt.decompress(f, len(d)) == d


@pytest.mark.parametrize("level", [1, 9])
def test_validate_on_the_card(cuda, level):
    """compress(validate=True) on the card equals compress() and the CPU
    twins' frame, and decodes."""
    data = make_corpus(4 * N + 5000, seed=level)
    codec = qzt.GpuCodec(level=level, batch=2, device="cuda")
    got = codec.compress(data, validate=True)
    assert got == codec.compress(data)
    assert got == qzt.GpuCodec(level=level, batch=2,
                               device="cpu").compress(data, validate=True)
    assert qzt.decompress(got, len(data)) == data


@pytest.mark.parametrize("psegs", [2, 4, 8])
@pytest.mark.parametrize("lazy", [False, True])
def test_parse_greedy_segmented(cuda, psegs, lazy):
    """B10's segmented mode: the rows' matches cross every segment end
    (every 4096-position edge)."""
    for mlen in (_parse_rows(), _parse_rows(B=6, n=20480, seed=4)):
        m = torch.from_numpy(mlen).to(cuda)
        got = pk.parse_greedy(m, lazy, psegs)
        assert torch.equal(got, pk.parse_greedy_twin(m, lazy, psegs))
        assert torch.equal(got.cpu(), pk.parse_greedy(m.cpu(), lazy, psegs))


def test_rest_of_the_package_card_vs_cpu(cuda):
    """The packed hash contract, the staged pipeline, the parsed path at
    psegs 4, bitpack and entry() on the card equal the CPU twins."""
    from qat_zstd_plugin_tpu_torch import entry
    from qat_zstd_plugin_tpu_torch.ops import bitpack
    blocks = _blocks()
    host = (torch.from_numpy(blocks), torch.full((8,), N, dtype=torch.int32))
    card = tuple(x.to(cuda) for x in host)
    for fn in (lambda b, n: tmp.find_matches_packed(
                   b, n, matcher="hash", widths=(5, 8), neighbors=1,
                   window=WINDOW, max_seq=4096),
               lambda b, n: tmp.find_matches_positions(
                   b, n, widths=(6,), window=WINDOW, ldm=4, dense=False,
                   lazy=True, psegs=4)):
        assert torch.equal(fn(*card).cpu(), fn(*host))
    got = tmp.find_matches_staged(*card, neighbors=4, max_seq=4096)
    want = tmp.find_matches_staged(*host, neighbors=4, max_seq=4096)
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)
    rng = np.random.default_rng(0)
    items = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (4, 999))
                              .astype(np.int32)) for _ in range(2)]
    items.append(torch.from_numpy(rng.integers(0, 65, (4, 999))
                                  .astype(np.int32)))
    got = bitpack.bitpack(*(x.to(cuda) for x in items), 900)
    want = bitpack.bitpack(*items, 900)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    fn, args = entry.entry("cuda", batch=4)
    cfn, cargs = entry.entry("cpu", batch=4)
    assert torch.equal(fn(*args).cpu(), cfn(*cargs))
