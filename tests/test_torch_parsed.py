"""The parsed hash path and the bitonic sort against the JAX package, on
the CPU: find_matches_positions(dense=False) (candidates, LDM merged in,
the greedy/lazy parse B10, then B17 compact_slots), B18 compact_operands
and compact_fast_glue around it, and B19 bitonic_sort.

Every input is made once per module from a seed with numpy and handed, as
the same arrays, to the JAX function (Pallas kernels in interpret mode,
the CPU parse `parse_greedy_scan`) and to the port's wrapper, which on a
CPU tensor runs the kernel's plain-torch twin. All values are integers, so
the tolerance is 0: equality, word for word. Each reference result is
built once per module.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops import match_pipeline as jmp
from qat_zstd_plugin_tpu.ops import sort_kernel as jsk
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp
from qat_zstd_plugin_tpu_torch.ops import sort_kernel as tsk

torch.set_num_threads(2)  # the suite runs six workers on a few cores

SURVEY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "SURVEY.md")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


# ---------------------------------------------------------------------------
# find_matches_positions(dense=False): tests/test_fused_dense.py's shapes
# ---------------------------------------------------------------------------

B, N, WINDOW = 8, 8192, 4096


WORDS = [b"the ", b"of ", b"and ", b"compression ", b"data ", b"block ",
         b"sequence ", b"entropy ", b"offset ", b"window "]


@functools.lru_cache
def ldm_blocks() -> np.ndarray:
    """Each block: words in random order (short local matches, where the
    lazy parse differs from the greedy one), then random bytes of a
    12-letter alphabet that every block repeats (long-range repeats at
    the LDM span's distance, as in tests/test_fused_dense.py)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 12, N // 2, np.uint8)
    out = np.empty((B, N), np.uint8)
    for b in range(B):
        text = b"".join(WORDS[i] for i in rng.integers(0, len(WORDS), N // 6))
        out[b, :N // 2] = np.frombuffer(text[:N // 2], np.uint8)
        out[b, N // 2:] = base
    return out


RAGGED = np.array([N, N - 1, N // 2 + 3, 100, 0, N - 7, N, 4000], np.int32)
SLOT_CASES = {  # widths, ldm, lazy, lengths
    **{f"w{''.join(map(str, w))}_ldm{ldm}_{'lazy' if lazy else 'greedy'}":
       (w, ldm, lazy, None)
       for w in ((6,), (5, 8)) for ldm in (4, 0) for lazy in (False, True)},
    "w58_ldm4_lazy_ragged": ((5, 8), 4, True, RAGGED),
}


@functools.lru_cache
def slot_words(case: str):
    """(the reference's slot words, the port's) for one case."""
    widths, ldm, lazy, lengths = SLOT_CASES[case]
    blocks = ldm_blocks()
    lengths = np.full(B, N, np.int32) if lengths is None else lengths
    kw = dict(widths=widths, window=WINDOW, ldm=ldm, lazy=lazy, dense=False)
    ref = jmp.find_matches_positions(jnp.asarray(blocks), jnp.asarray(lengths),
                                     **kw)
    got = tmp.find_matches_positions(t(blocks), t(lengths), **kw)
    return u32(ref), u32(got.numpy())


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_parsed_slot_words(case):
    ref, got = slot_words(case)
    assert got.shape == (B * (N // WINDOW), WINDOW // 4)
    np.testing.assert_array_equal(got, ref)
    assert (got != 0xFFFFFFFF).sum() > 100


def test_lazy_and_ldm_change_the_words():
    """The cases differ where they should: the lazy parse and the LDM
    claims each change some slot words (so each case checks its branch)."""
    base = slot_words("w6_ldm0_greedy")[1]
    assert (slot_words("w6_ldm0_lazy")[1] != base).any()
    assert (slot_words("w6_ldm4_greedy")[1] != base).any()
    far = slot_words("w6_ldm4_greedy")[1]
    assert ((far & 0x3FFFFFFF) >= WINDOW)[far != 0xFFFFFFFF].any()


# ---------------------------------------------------------------------------
# B17 compact_slots alone: a dense mask, several claims a slot
# ---------------------------------------------------------------------------

@functools.lru_cache
def dense_claims():
    """(mlen, moff) of the reference's candidates_hash_split on the LDM
    blocks, widths (5, 8)."""
    mlen, moff = gk.candidates_hash_split(jnp.asarray(ldm_blocks()),
                                          jnp.full((B,), N, jnp.int32),
                                          widths=(5, 8), neighbors=1,
                                          window=WINDOW, interpret=True)
    return np.asarray(mlen), np.asarray(moff)


def test_compact_slots_dense_mask():
    """chosen = mlen >= MIN_MATCH puts up to four claims in a slot; the
    unsigned minimum keeps the smallest subslot k, as the reference's
    sign-flipped minimum does. bool and int32 masks give the same words."""
    mlen, moff = dense_claims()
    chosen = (mlen >= 4).astype(np.int32)
    per_slot = chosen.reshape(B, N // 4, 4).sum(axis=2)
    assert (per_slot >= 2).sum() > 1000  # the case under test
    ref = u32(gk.compact_slots(jnp.asarray(chosen), jnp.asarray(moff), WINDOW,
                               interpret=True))
    for mask in (chosen, chosen.astype(bool)):
        np.testing.assert_array_equal(
            u32(tk.compact_slots(t(mask), t(moff), WINDOW).numpy()), ref)


def test_compact_slots_composes_to_compact_slots_dense():
    """The reference's _unfused check (tests/test_fused_dense.py): B17 over
    the dense mask equals B8 compact_slots_dense without LDM."""
    mlen, moff = (t(a) for a in dense_claims())
    np.testing.assert_array_equal(
        tk.compact_slots(mlen >= 4, moff, WINDOW).numpy(),
        tk.compact_slots_dense(mlen, moff, WINDOW).numpy())


def test_compact_slots_two_claims_probe():
    """Claims at positions 5 and 6 share slot 1: the word is k=1 with
    position 5's offset, 0x4000002a, in the reference and the port."""
    chosen = np.zeros((1, 64), np.int32)
    moff = np.zeros((1, 64), np.int32)
    chosen[0, 5:7] = 1
    moff[0, 5], moff[0, 6] = 42, 7
    ref = u32(gk.compact_slots(jnp.asarray(chosen), jnp.asarray(moff), 64,
                               interpret=True))
    got = u32(tk.compact_slots(t(chosen), t(moff), 64).numpy())
    assert ref[0, 1] == got[0, 1] == 0x4000002A
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# B18 compact_operands and compact_fast_glue: tests/test_glue_kernels.py's
# inputs (SURVEY.md text, widths (5, 8), window 32768)
# ---------------------------------------------------------------------------

GLUE_CASES = {  # blocks, block length, window, max_seq
    "4x64K_nseg2": (4, 65536, 32768, 16384),
    "2x128K_nseg4": (2, 131072, 32768, 16384),
    "2x128K_nseg4_max_seq_1024": (2, 131072, 32768, 1024),
    "4x32K_nseg1": (4, 32768, 32768, 16384),
}


@functools.lru_cache
def parse_inputs(nb: int, n: int):
    """(chosen, mlen, moff, lengths) as numpy arrays: the reference's
    candidates_hash and parse_greedy_scan over SURVEY.md text."""
    with open(SURVEY, "rb") as f:
        text = f.read() * 12
    buf = np.frombuffer(text[:nb * n], np.uint8).reshape(nb, n)
    lengths = np.full(nb, n, np.int32)
    m, o = jmp.candidates_hash(jnp.asarray(buf), jnp.asarray(lengths),
                               widths=(5, 8), neighbors=1, window=32768)
    chosen = jmp.parse_greedy_scan(m)
    return (np.asarray(chosen), np.asarray(m), np.asarray(o), lengths)


@functools.lru_cache
def glue_results(case: str):
    nb, n, window, max_seq = GLUE_CASES[case]
    chosen, m, o, lengths = parse_inputs(nb, n)
    ref = gk.compact_fast_glue(jnp.asarray(chosen), jnp.asarray(m),
                               jnp.asarray(o), jnp.asarray(lengths), max_seq,
                               window, interpret=True)
    got = tk.compact_fast_glue(t(chosen), t(m), t(o), t(lengths), max_seq,
                               window)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("case", sorted(GLUE_CASES))
def test_compact_fast_glue(case):
    ref, got = glue_results(case)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["nseq"].min() > 0
    if "1024" in case:
        assert got["overflow"].all()


@pytest.mark.parametrize("case", ["4x64K_nseg2", "4x32K_nseg1"])
def test_compact_operands(case):
    nb, n, window, _ = GLUE_CASES[case]
    chosen, m, o, _ = parse_inputs(nb, n)
    ref = gk.compact_operands(jnp.asarray(chosen.astype(np.int32)),
                              jnp.asarray(m), jnp.asarray(o), window,
                              interpret=True)
    got = tk.compact_operands(t(chosen), t(m), t(o), window)
    for g, r in zip(got, ref):
        assert g.shape == (nb * (n // min(window, n)), min(window, n))
        np.testing.assert_array_equal(u32(g.numpy()), u32(r))


def test_compact_operands_unmasked_payload():
    """Payloads of 2^16 and more, and negative ones, reach into the position
    key through the reference's unmasked OR; the port keeps those bits."""
    rng = np.random.default_rng(5)
    chosen = rng.random((2, 4096)) < 0.3
    m = rng.integers(-2**31, 2**31, (2, 4096), np.int64).astype(np.int32)
    o = rng.integers(0, 1 << 20, (2, 4096)).astype(np.int32)
    ref = gk.compact_operands(jnp.asarray(chosen.astype(np.int32)),
                              jnp.asarray(m), jnp.asarray(o), 1024,
                              interpret=True)
    got = tk.compact_operands(t(chosen), t(m), t(o), 1024)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(u32(g.numpy()), u32(r))


def test_compact_operands_refuses_wide_segments():
    z = torch.zeros((1, 65536), dtype=torch.int32)
    with pytest.raises(ValueError, match="32768"):
        tk.compact_operands(z, z, z, 65536)


# ---------------------------------------------------------------------------
# B19 bitonic_sort
# ---------------------------------------------------------------------------

def sort_inputs(kind: str, n: int, npay: int, seed: int = 0):
    """(key, pos, payloads) for B=2 rows: random keys with pos the column;
    heavy duplicate keys; or duplicate (key, pos) pairs (the tie case),
    with negative positions."""
    rng = np.random.default_rng(seed)
    shape = (2, n)
    if kind == "random":
        key = rng.integers(-2**31, 2**31, shape, np.int64).astype(np.int32)
        pos = np.broadcast_to(np.arange(n, dtype=np.int32), shape).copy()
    elif kind == "dup_keys":
        key = rng.integers(0, 17, shape).astype(np.int32)
        pos = np.broadcast_to(np.arange(n, dtype=np.int32), shape).copy()
    else:  # dup_pairs
        key = rng.choice(np.array([0, 1, -1, -2**31], np.int32), shape)
        pos = rng.integers(-4, 4, shape).astype(np.int32)
    pay = tuple(rng.integers(-2**31, 2**31, shape, np.int64).astype(np.int32)
                for _ in range(npay))
    return key, pos, pay


SORT_CASES = ["random-1024-0", "random-1024-1", "dup_keys-2048-1",
              "dup_pairs-1024-2", "dup_pairs-2048-2"]


@functools.lru_cache
def reference_sort(case: str):
    kind, n, npay = case.split("-")
    key, pos, pay = sort_inputs(kind, int(n), int(npay))
    ref = jsk.bitonic_sort(*(jnp.asarray(a) for a in (key, pos) + pay))
    return (key, pos, pay), [np.asarray(r) for r in ref]


@pytest.mark.parametrize("case", SORT_CASES)
def test_bitonic_sort_equals_reference(case):
    (key, pos, pay), ref = reference_sort(case)
    got = tsk.bitonic_sort(t(key), t(pos), *(t(p) for p in pay))
    assert len(got) == len(ref) == 2 + len(pay)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def test_bitonic_sort_ties_are_not_a_stable_sorts():
    """With duplicate (key, pos) pairs the reference's payload order is not
    a stable lexsort's, so a twin built on a stable sort would fail the
    case above; keys and positions still equal the lexsort's."""
    (key, pos, pay), ref = reference_sort("dup_pairs-1024-2")
    order = np.lexsort((pos, key.view(np.uint32)), axis=-1)
    np.testing.assert_array_equal(ref[0], np.take_along_axis(key, order, 1))
    np.testing.assert_array_equal(ref[1], np.take_along_axis(pos, order, 1))
    assert (ref[2] != np.take_along_axis(pay[0], order, 1)).any()


@pytest.mark.parametrize("npay", [0, 1])
def test_bitonic_sort_equals_lexsort(npay):
    """N = 4096 against numpy's lexsort (unsigned key, then pos), as
    tests/test_sort_kernel.py holds the reference: unique positions, so
    the stable order is the only one."""
    key, pos, pay = sort_inputs("random", 4096, npay, seed=1)
    got = tsk.bitonic_sort(t(key), t(pos), *(t(p) for p in pay))
    order = np.lexsort((pos, key.view(np.uint32)), axis=-1)
    for g, a in zip(got, (key, pos) + pay):
        np.testing.assert_array_equal(g.numpy(),
                                      np.take_along_axis(a, order, 1))


@pytest.mark.parametrize("n", [512, 1000, 1536])
def test_bitonic_sort_refuses_other_lengths(n):
    z = torch.zeros((2, n), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        tsk.bitonic_sort(z, z)
