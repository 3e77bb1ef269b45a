"""The port's level 2-4 device ops against the JAX package's, on the CPU.

Every input goes, as numpy arrays made from a seed, through the JAX
function (Pallas kernels in interpret mode) and through the port's
wrapper, which on a CPU tensor runs the kernel's plain-torch twin. All
values are integers, so the tolerance is 0: equality, word for word.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops import match_pipeline as jmp
from qat_zstd_plugin_tpu.runtime.tpu_codec import TPU_LEVEL_TABLE
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp

torch.set_num_threads(2)  # six test workers share a few cores

N = 65536  # two window segments: the chains cross a segment boundary
WINDOW = 32768
PBITS = 15
WORDS = [b"the ", b"of ", b"and ", b"compression ", b"data ", b"block ",
         b"sequence ", b"entropy ", b"offset ", b"window "]


def make_blocks(kind: str, B: int = 4, n: int = N, seed: int = 0):
    rng = np.random.default_rng(seed)
    text = b"".join(WORDS[i] for i in rng.integers(0, len(WORDS), B * n // 3))
    if kind == "random":
        return rng.integers(0, 256, (B, n), np.uint8)
    if kind == "same":
        return np.full((B, n), 0x41, np.uint8)
    if kind == "text":
        return np.frombuffer(text[:B * n], np.uint8).reshape(B, n).copy()
    # "mixed": text, records, low-entropy and random spans, runs longer
    # than 16383 (one across a segment boundary), an all-same block and
    # copies of earlier blocks (long-distance repeats for LDM). Fewer than
    # four blocks take the first rows of the four-block mix.
    rows = max(B, 4)
    out = rng.integers(0, 16, (rows, n), np.uint8)
    out[0, :n // 2] = np.frombuffer(text[:n // 2], np.uint8)
    out[0, n // 2 - 5000:n // 2 + 15000] = 0x20
    rec = rng.integers(0, 256, 64, np.uint8)
    out[1, n // 4:n // 4 + 64 * 200] = np.tile(rec, 200)
    out[1, n - 17000:] = 7
    out[2] = 0x41
    out[rows // 2 + 1, :n // 8] = rng.integers(0, 256, n // 8, np.uint8)
    for b in range(3, rows, 2):
        out[b] = out[b - 3]
    return out[:B].copy()


KINDS = ["text", "random", "same", "mixed"]


def ragged_lengths(B: int, n: int = N) -> np.ndarray:
    base = np.array([n, n - 1, n // 2 + 3, 100, 0, n - 7, 5, n], np.int32)
    return np.resize(base, B)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def jax_sus(blocks, widths, neighbors):
    """Position-ordered un-sort keys of each width, by the JAX ops."""
    sus = []
    for width in widths:
        key = gk.hash_keys(jnp.asarray(blocks), width, WINDOW,
                           interpret=True)
        sk = np.sort(np.asarray(key), axis=1)
        sus.append(np.sort(np.asarray(gk.neighbor_unsort_keys(
            jnp.asarray(sk), PBITS, neighbors, interpret=True)), axis=1))
    return sus


# --- B5 hash_keys ----------------------------------------------------------

@pytest.mark.parametrize("width", [4, 5, 6, 8])
def test_hash_keys_widths(width):
    blocks = make_blocks("mixed", B=2, seed=width)
    want = np.asarray(gk.hash_keys(jnp.asarray(blocks), width, WINDOW,
                                   interpret=True))
    got = tk.hash_keys(torch.from_numpy(blocks), width, WINDOW)
    assert got.shape == (2 * N // WINDOW, WINDOW)
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("kind", ["text", "random", "same"])
def test_hash_keys_kinds(kind):
    blocks = make_blocks(kind, B=2)
    want = np.asarray(gk.hash_keys(jnp.asarray(blocks), 6, WINDOW,
                                   interpret=True))
    np.testing.assert_array_equal(
        u32(tk.hash_keys(torch.from_numpy(blocks), 6, WINDOW)), want)


def test_hash_keys_one_segment_short_block():
    """N < window: one segment of N positions, pbits from N."""
    blocks = make_blocks("text", B=2, n=8192)
    want = np.asarray(gk.hash_keys(jnp.asarray(blocks), 5, WINDOW,
                                   interpret=True))
    got = tk.hash_keys(torch.from_numpy(blocks), 5, WINDOW)
    assert got.shape == (2, 8192)
    np.testing.assert_array_equal(u32(got), want)


# --- B6 hash_keys_winmin ---------------------------------------------------

@pytest.mark.parametrize("stride", [32, 64])
@pytest.mark.parametrize("kind", ["mixed", "random"])
def test_hash_keys_winmin(kind, stride):
    blocks = make_blocks(kind, B=2)
    key_ref, minz_ref = gk.hash_keys_winmin(jnp.asarray(blocks), 4, WINDOW,
                                            stride, interpret=True)
    key, minz = tk.hash_keys_winmin(torch.from_numpy(blocks), 4, WINDOW,
                                    stride)
    np.testing.assert_array_equal(u32(key), np.asarray(key_ref))
    np.testing.assert_array_equal(u32(minz), np.asarray(minz_ref))


# --- B5 and B6 in the flip mode of the main path ---------------------------

@pytest.mark.parametrize("width", [4, 5, 6, 8])
def test_hash_keys_flip_mode(width):
    """flip=_FLIP XORs the sign bit into every key: the reference's keys
    ^ 0x80000000, which a signed row sort orders as the unsigned sort
    orders the reference's."""
    blocks = make_blocks("mixed", B=2, seed=width)
    want = np.asarray(gk.hash_keys(jnp.asarray(blocks), width, WINDOW,
                                   interpret=True))
    got = tk.hash_keys(torch.from_numpy(blocks), width, WINDOW,
                       flip=tk._FLIP)
    np.testing.assert_array_equal(u32(got), want ^ np.uint32(0x80000000))


@pytest.mark.parametrize("stride", [1, 32, 64, 256])
def test_hash_keys_winmin_flip_mode(stride):
    """B6's keys take the flip; its minz plane never does."""
    blocks = make_blocks("mixed", B=2, seed=stride)
    key_ref, minz_ref = gk.hash_keys_winmin(jnp.asarray(blocks), 6, WINDOW,
                                            stride, interpret=True)
    key, minz = tk.hash_keys_winmin(torch.from_numpy(blocks), 6, WINDOW,
                                    stride, flip=tk._FLIP)
    np.testing.assert_array_equal(u32(key), np.asarray(key_ref)
                                  ^ np.uint32(0x80000000))
    np.testing.assert_array_equal(u32(minz), np.asarray(minz_ref))


@pytest.mark.parametrize("widths,neighbors", [((6,), 1), ((5, 8), 1),
                                              ((4, 5, 6, 8), 2)])
def test_unsorted_takes_flipped_keys(widths, neighbors):
    """_unsorted(flipped=True) on B5's flipped keys gives the words of
    _unsorted on plain keys, which are the reference's."""
    blocks = make_blocks("mixed", B=2, seed=len(widths))
    x = torch.from_numpy(blocks)
    for width, want in zip(widths, jax_sus(blocks, widths, neighbors)):
        flipped = tk._unsorted(tk.hash_keys(x, width, WINDOW, flip=tk._FLIP),
                               PBITS, neighbors, flipped=True)
        plain = tk._unsorted(tk.hash_keys(x, width, WINDOW), PBITS,
                             neighbors)
        assert torch.equal(flipped, plain)
        np.testing.assert_array_equal(u32(flipped), want)


@pytest.mark.parametrize("case", ["L2_b4_128k", "L4_b16_32k",
                                  "L4_b8_32k_no_ldm"])
def test_dense_path_sorts_the_kernels_keys(case, monkeypatch):
    """On the dense path each width's first row sort takes B5's or B6's
    keys as the kernel wrote them (flipped): no XOR pass between."""
    level, B, n, _ = SLOT_CASES[case]
    p = TPU_LEVEL_TABLE[level]
    written, sorted_in, flips = [], [], []
    for name in ("hash_keys", "hash_keys_winmin"):
        def spy(*a, _fn=getattr(tk, name), _keys_only=name == "hash_keys",
                **k):
            flips.append(k.get("flip"))
            out = _fn(*a, **k)
            written.append(out if _keys_only else out[0])
            return out
        monkeypatch.setattr(tk, name, spy)
    sort = tk._sort_signed
    monkeypatch.setattr(tk, "_sort_signed",
                        lambda x: sorted_in.append(x) or sort(x))
    blocks = make_blocks("mixed", B=B, n=n, seed=level)
    tmp.find_matches_positions(torch.from_numpy(blocks),
                               torch.from_numpy(ragged_lengths(B, n)),
                               widths=p.widths, neighbors=p.neighbors,
                               window=p.window, ldm=p.ldm, dense=True,
                               sync=False)
    assert len(written) == len(p.widths) and flips == [tk._FLIP] * len(flips)
    assert all(any(s is k for s in sorted_in) for k in written)


# --- B7 finalize_candidates ------------------------------------------------

@pytest.mark.parametrize("widths, neighbors", [((6,), 1), ((5, 8), 1),
                                               ((4, 5, 6, 8), 2)])
def test_finalize_candidates(widths, neighbors):
    blocks = make_blocks("mixed")
    lengths = ragged_lengths(4)
    sus = jax_sus(blocks, widths, neighbors)
    ml_ref, mo_ref = gk.finalize_candidates(
        tuple(jnp.asarray(s) for s in sus), jnp.asarray(blocks),
        jnp.asarray(lengths), widths, WINDOW, interpret=True)
    ml, mo = tk.finalize_candidates([i32(s) for s in sus],
                                    torch.from_numpy(blocks),
                                    torch.from_numpy(lengths), widths,
                                    WINDOW)
    assert int(np.asarray(ml_ref).max()) == tk.RUN_CAP  # a capped run
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ml_ref))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(mo_ref))


def test_finalize_run_scan_all_same_and_long_runs():
    """Runs of 2^14 - 1, 2^14 and 2^14 + 1 bytes, an all-same block, and
    a run that ends at the row's end, against the reference's doubling
    scan; the twin's chunked result equals one pass over all widths."""
    blocks = np.zeros((4, N), np.uint8)
    blocks[0] = 0x41
    for start, run in ((100, 16383), (20000, 16384), (40000, 16385)):
        blocks[1, start:start + run] = 0x61
    blocks[2, :] = np.arange(N) % 251
    blocks[2, N - 20000:] = 9
    blocks[3, 30000:35000] = 3
    lengths = np.array([N, N, N - 10, 32000], np.int32)
    widths = (4, 8, 5)
    sus = jax_sus(blocks, widths, 1)
    ml_ref, mo_ref = gk.finalize_candidates(
        tuple(jnp.asarray(s) for s in sus), jnp.asarray(blocks),
        jnp.asarray(lengths), widths, WINDOW, interpret=True)
    args = ([i32(s) for s in sus], torch.from_numpy(blocks),
            torch.from_numpy(lengths), widths, WINDOW)
    ml, mo = tk.finalize_candidates(*args)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ml_ref))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(mo_ref))
    one_pass = tk._finalize_chunk_twin(*args, None, True)
    assert torch.equal(one_pass[0], ml) and torch.equal(one_pass[1], mo)


# --- B8 compact_slots_dense ------------------------------------------------

@pytest.mark.parametrize("local_cap", [24, 32])
@pytest.mark.parametrize("ldm", [0, 4])
def test_compact_slots_dense(ldm, local_cap):
    blocks = make_blocks("mixed")
    lengths = ragged_lengths(4)
    widths = (5, 8)
    ml, mo = gk.finalize_candidates(
        tuple(jnp.asarray(s) for s in jax_sus(blocks, widths, 1)),
        jnp.asarray(blocks), jnp.asarray(lengths), widths, WINDOW,
        interpret=True)
    su_l = est = off = None
    if ldm:
        _, minz = gk.hash_keys_winmin(jnp.asarray(blocks), 5, WINDOW,
                                      gk.ldm_stride(ldm, N), interpret=True)
        su_l = gk.ldm_unsorted(jnp.asarray(blocks), ldm, 1, interpret=True,
                               minz=minz)
        est, off = tk._ldm_est(i32(su_l), torch.from_numpy(lengths), N, ldm,
                               1 << 19)
        assert int((est > 0).sum()) > 0  # LDM claims exist
    want = np.asarray(gk.compact_slots_dense(
        ml, mo, WINDOW, su=su_l, lengths=jnp.asarray(lengths),
        span_blocks=ldm, local_cap=local_cap, max_off=1 << 19,
        interpret=True))
    got = tk.compact_slots_dense(i32(ml), i32(mo), WINDOW, est, off,
                                 local_cap)
    assert got.shape == (4 * N // WINDOW, WINDOW // 4)
    np.testing.assert_array_equal(u32(got), want)


# --- the composed device half ----------------------------------------------

SLOT_CASES = {  # level, batch, block length, LDM on
    "L2_b4_128k": (2, 4, 131072, True),
    "L3_b8_32k": (3, 8, 32768, True),
    "L4_b16_32k": (4, 16, 32768, True),
    "L4_b8_32k_no_ldm": (4, 8, 32768, False),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_slot_words(case):
    level, B, n, ldm_on = SLOT_CASES[case]
    p = TPU_LEVEL_TABLE[level]
    assert (B % p.ldm == 0) == ldm_on
    blocks = make_blocks("mixed", B=B, n=n, seed=level)
    lengths = ragged_lengths(B, n)
    kw = dict(widths=p.widths, neighbors=p.neighbors, window=p.window,
              ldm=p.ldm, ldm_max_off=1 << 19, dense=True, sync=False)
    want = np.asarray(jmp.find_matches_positions(
        jnp.asarray(blocks), jnp.asarray(lengths), **kw))
    tk.reset_launches()
    got = u32(tmp.find_matches_positions(torch.from_numpy(blocks),
                                         torch.from_numpy(lengths), **kw))
    assert got.shape == (B * n // WINDOW, WINDOW // 4)
    assert (want != 0xFFFFFFFF).any()
    np.testing.assert_array_equal(got, want)
    assert all(v == 0 for v in tk.launches.values())  # twins launch nothing


def test_partial_batch_drops_ldm():
    """At L2, B=6 is no whole number of 4-block spans: both sides drop
    LDM, and the slot words equal those of ldm=0."""
    blocks = make_blocks("mixed", B=6, n=WINDOW, seed=5)
    lengths = ragged_lengths(6, WINDOW)
    kw = dict(widths=(6,), window=WINDOW, dense=True, ldm_max_off=1 << 19)
    want = np.asarray(jmp.find_matches_positions(
        jnp.asarray(blocks), jnp.asarray(lengths), ldm=4, **kw))
    got = tmp.find_matches_positions(torch.from_numpy(blocks),
                                     torch.from_numpy(lengths), ldm=4, **kw)
    np.testing.assert_array_equal(u32(got), want)
    got0 = tmp.find_matches_positions(torch.from_numpy(blocks),
                                      torch.from_numpy(lengths), ldm=0, **kw)
    assert torch.equal(got, got0)


def test_wrappers_check_shapes():
    blocks = torch.zeros((2, WINDOW), dtype=torch.uint8)
    lengths = torch.zeros(2, dtype=torch.int32)
    key = torch.zeros((2, WINDOW), dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.hash_keys(torch.zeros((2, 30), dtype=torch.uint8), 6, WINDOW)
    with pytest.raises(ValueError):
        tk.hash_keys(blocks, 7, WINDOW)
    with pytest.raises(ValueError):
        tk.hash_keys_winmin(blocks, 6, WINDOW, 48)
    with pytest.raises(ValueError):
        tk.finalize_candidates([key] * 5, blocks, lengths, (4,) * 5, WINDOW)
    with pytest.raises(ValueError):
        tk.finalize_candidates([key[:1].contiguous()], blocks, lengths, (6,),
                               WINDOW)
    with pytest.raises(ValueError):
        tk.finalize_candidates([key], blocks, lengths, (0,), WINDOW)
    with pytest.raises(ValueError):
        tk.compact_slots_dense(key, key, WINDOW,
                               torch.zeros((2, 3), dtype=torch.int32),
                               torch.zeros((2, 3), dtype=torch.int32))
