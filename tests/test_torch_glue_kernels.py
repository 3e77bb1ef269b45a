"""The port's L1 device ops against the JAX package's, on the CPU.

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
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp

torch.set_num_threads(2)  # six test workers share a few cores

N = 131072
WINDOW = 32768
WORDS = [b"the ", b"of ", b"and ", b"compression ", b"data ", b"block ",
         b"sequence ", b"entropy ", b"offset ", b"window "]


def make_blocks(kind: str, B: int = 4, n: int = N, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (B, n), np.uint8)
    if kind == "same":
        return np.full((B, n), 0x41, np.uint8)
    if kind == "text":
        text = b"".join(WORDS[i] for i in
                        rng.integers(0, len(WORDS), B * n // 3))
        return np.frombuffer(text[:B * n], np.uint8).reshape(B, n).copy()
    # "mixed": text, repeated records, low-entropy and random spans, and a
    # copy of an earlier block (a long-distance repeat for LDM).
    out = rng.integers(0, 16, (B, n), np.uint8)
    text = b"".join(WORDS[i] for i in rng.integers(0, len(WORDS), n // 3))
    out[0, :n // 2] = np.frombuffer(text[:n // 2], np.uint8)
    rec = rng.integers(0, 256, 64, np.uint8)
    out[1, n // 4:n // 4 + 64 * 300] = np.tile(rec, 300)
    out[B // 2, :n // 8] = rng.integers(0, 256, n // 8, np.uint8)
    out[B - 1, n // 2:] = out[0, :n // 2]
    return out


KINDS = ["text", "random", "same", "mixed"]


def ragged_lengths(B: int, n: int = N) -> np.ndarray:
    return np.array([n, n - 1, n // 2 + 3, 100, 0, n - 7][:B], np.int32)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def jax_k1(blocks, width=6, stride=32, window=WINDOW):
    key, minz = gk.hash_keys_winmin_sync(jnp.asarray(blocks), width, window,
                                         stride, interpret=True)
    return np.asarray(key), None if minz is None else np.asarray(minz)


# --- u32 helpers -----------------------------------------------------------

def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, 4096, np.uint64).astype(np.uint32)
    a[:3] = [0, 1, 0xFFFFFFFF]
    for c in (tk._C1, tk._C2, tk._C3):
        want = (a * np.uint32(c)).astype(np.uint32)
        got = tk._mul32(torch.from_numpy(a.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_i32_u32_roundtrip():
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.int64)
    t = tk._i32(torch.from_numpy(vals))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), vals)
    np.testing.assert_array_equal(tk._u32(t).numpy(), vals)


def test_unsigned_winmin_equals_sign_flipped_min():
    """The reference's sign-flipped int32 minimum with fill 0x7FFFFFFF is
    the twin's unsigned minimum with fill 0xFFFFFFFF."""
    rng = np.random.default_rng(4)
    h8 = rng.integers(0, 1 << 32, (2, 300), np.uint64).astype(np.uint32)
    h8[0, 100:140] = 0xFFFFFFFF
    h8[1, ::7] = 0x80000000
    got = tk._winmin_tail(torch.from_numpy(h8.astype(np.int64)), 32)
    m = (h8 ^ np.uint32(0x80000000)).view(np.int32)
    for s in (1, 2, 4, 8, 16):
        sh = np.full_like(m, 0x7FFFFFFF)
        sh[:, :-s] = m[:, s:]
        m = np.minimum(m, sh)
    want = m.view(np.uint32) ^ np.uint32(0x80000000)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sort_rows_is_unsigned():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, (3, 1000), np.uint64).astype(np.uint32)
    x[0, :4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    np.testing.assert_array_equal(u32(tk._sort_rows(i32(x))),
                                  np.sort(x, axis=1))


def test_launch_refuses_cpu_tensors():
    """A kernel is never handed host pointers, even when its entry point
    is called past the wrappers' device dispatch."""
    x = torch.zeros((2, 16), dtype=torch.int32)
    before = tk.launches["neighbor_unsort_keys"]
    with pytest.raises(ValueError, match="CUDA device"):
        tk._launch("neighbor_unsort_keys", x, torch.empty_like(x), 2, 16,
                   4, 1, 15, 0)
    assert tk.launches["neighbor_unsort_keys"] == before


# --- K1 hash_keys_winmin_sync ----------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_hash_keys_winmin_sync(kind):
    blocks = make_blocks(kind)
    key_ref, minz_ref = jax_k1(blocks)
    key, minz = tk.hash_keys_winmin_sync(torch.from_numpy(blocks), 6,
                                         WINDOW, 32)
    assert key.shape == (4 * N // WINDOW, WINDOW // 2)
    np.testing.assert_array_equal(u32(key), key_ref)
    np.testing.assert_array_equal(u32(minz), minz_ref)


@pytest.mark.parametrize("width", [4, 5, 8])
def test_hash_keys_winmin_sync_other_widths(width):
    blocks = make_blocks("mixed", B=2, n=WINDOW, seed=width)
    key_ref, minz_ref = jax_k1(blocks, width=width, stride=64)
    key, minz = tk.hash_keys_winmin_sync(torch.from_numpy(blocks), width,
                                         WINDOW, 64)
    np.testing.assert_array_equal(u32(key), key_ref)
    np.testing.assert_array_equal(u32(minz), minz_ref)


def test_hash_keys_winmin_sync_without_minz():
    blocks = make_blocks("text", B=2, n=WINDOW)
    key_ref, minz_ref = jax_k1(blocks, stride=0)
    key, minz = tk.hash_keys_winmin_sync(torch.from_numpy(blocks), 6,
                                         WINDOW, 0)
    assert minz is None and minz_ref is None
    np.testing.assert_array_equal(u32(key), key_ref)



@pytest.mark.parametrize("flip", [0, 0x80000000], ids=["flip0", "flip"])
@pytest.mark.parametrize("stride", [32, 64, 4096])
@pytest.mark.parametrize("width", [4, 5, 6, 8])
def test_hash_keys_winmin_sync_samples(width, stride, flip):
    """K1 with samples=True gives the reference's keys (XORed with the
    flip word) and its plane's every stride-th word, the LDM samples."""
    blocks = make_blocks("mixed", B=2, n=WINDOW, seed=width + stride)
    key_ref, minz_ref = jax_k1(blocks, width=width, stride=stride)
    key, samples = tk.hash_keys_winmin_sync(torch.from_numpy(blocks), width,
                                            WINDOW, stride, flip=flip,
                                            samples=True)
    assert samples.shape == (2, WINDOW // stride)
    np.testing.assert_array_equal(u32(key), key_ref ^ np.uint32(flip))
    np.testing.assert_array_equal(u32(samples), minz_ref[:, ::stride])
    _, plane = tk.hash_keys_winmin_sync(torch.from_numpy(blocks), width,
                                        WINDOW, stride, flip=flip)
    np.testing.assert_array_equal(u32(plane), minz_ref)

# --- K2 neighbor_unsort_keys -----------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_neighbor_unsort_keys_pair_rows(kind):
    """Pair rows are w/2 = 16384 wide but carry pbits 15 from w = 32768."""
    key_ref, _ = jax_k1(make_blocks(kind), stride=0)
    sk = np.sort(key_ref, axis=1)
    want = np.asarray(gk.neighbor_unsort_keys(
        jnp.asarray(sk), 15, 1, pos_mask=WINDOW - 1, interpret=True))
    got = tk.neighbor_unsort_keys(i32(sk), 15, 1, pos_mask=WINDOW - 1)
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("neighbors", [1, 2])
def test_neighbor_unsort_keys_ldm_rows(neighbors):
    _, minz = jax_k1(make_blocks("mixed"))
    lk = np.sort(np.asarray(gk.ldm_keys(jnp.asarray(minz), 4, 32,
                                        interpret=True)), axis=1)
    want = np.asarray(gk.neighbor_unsort_keys(jnp.asarray(lk), 15,
                                              neighbors, interpret=True))
    got = tk.neighbor_unsort_keys(i32(lk), 15, neighbors)
    np.testing.assert_array_equal(u32(got), want)


# --- K3 ldm_keys -----------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_ldm_keys(kind):
    _, minz = jax_k1(make_blocks(kind))
    want = np.asarray(gk.ldm_keys(jnp.asarray(minz), 4, 32, interpret=True))
    got = tk.ldm_keys(i32(minz), 4, 32)
    assert got.shape == (1, 2 * 4 * N // 32)
    np.testing.assert_array_equal(u32(got), want)


def test_ldm_keys_two_spans():
    """A second span's context half is the first span's samples."""
    _, minz = jax_k1(make_blocks("mixed", B=8, n=WINDOW))
    want = np.asarray(gk.ldm_keys(jnp.asarray(minz), 4, 32, interpret=True))
    np.testing.assert_array_equal(u32(tk.ldm_keys(i32(minz), 4, 32)), want)


def test_ldm_unsorted_and_ldm_est():
    blocks = make_blocks("mixed")
    lengths = ragged_lengths(4)
    _, minz = jax_k1(blocks)
    su_ref = np.asarray(gk.ldm_unsorted(jnp.asarray(blocks), 4, 1,
                                        interpret=True,
                                        minz=jnp.asarray(minz)))
    su = tk.ldm_unsorted(i32(minz), 4, 1)
    np.testing.assert_array_equal(u32(su), su_ref)
    est_ref, off_ref = gk._ldm_est(jnp.asarray(su_ref), jnp.asarray(lengths),
                                   N, 4, 1 << 19)
    est, off = tk._ldm_est(su, torch.from_numpy(lengths), N, 4, 1 << 19)
    assert int((np.asarray(est_ref) > 0).sum()) > 0  # LDM claims exist
    np.testing.assert_array_equal(est.numpy(), np.asarray(est_ref))
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_ref))


# --- K2 and K3 with the sign flip ------------------------------------------
#
# The main path sorts rows signed; K2 and K3 take the flip word 0x80000000
# and XOR it into every word they read (K2) and write (both). Under that
# mapping the twins must give the reference's words: twin(x ^ F, flip=F)
# == ref(x) ^ F for K2, and twin(flip=F) == ref ^ F for K3; with flip 0
# they give the reference's words themselves.

F = np.uint32(0x80000000)


def _full_rows(B=2, seed=3):
    """Sorted full-resolution keys (B rows of WINDOW, pbits 15)."""
    blocks = make_blocks("mixed", B=B, n=WINDOW, seed=seed)
    return np.sort(np.asarray(gk.hash_keys(jnp.asarray(blocks), 4, WINDOW,
                                           interpret=True)), axis=1)


def _crafted_rows(w=4096, seed=7):
    """Rows (pbits 12) whose equal hashes run across many 1024-word
    chunks: sorted over 4 hash values, sorted over one, unsorted."""
    rng = np.random.default_rng(seed)
    pos = rng.permutation(w).astype(np.uint64)
    return np.stack([
        np.sort((rng.integers(0, 4, w).astype(np.uint64) << 12) | pos),
        np.sort((np.uint64(5) << 12) | pos),
        (rng.integers(0, 4, w).astype(np.uint64) << 12)
        | rng.integers(0, w, w).astype(np.uint64)]).astype(np.uint32)


def _k2_case(case):
    """(sorted keys as u32, pbits, neighbors, pos_mask) of a K2 case."""
    if case == "pair rows":
        key, _ = jax_k1(make_blocks("mixed", B=2, n=WINDOW))
        return np.sort(key, axis=1), 15, 1, WINDOW - 1
    if case == "one pair row":
        key, _ = jax_k1(make_blocks("text", B=1, n=WINDOW))
        return np.sort(key, axis=1), 15, 1, WINDOW - 1
    if case == "ldm rows":
        _, minz = jax_k1(make_blocks("mixed"))
        lk = np.asarray(gk.ldm_keys(jnp.asarray(minz), 4, 32,
                                    interpret=True))
        return np.sort(lk, axis=1), 15, 1, None
    if case.startswith("full rows"):
        return _full_rows(), 15, int(case.split()[-1]), None
    if case.startswith("width"):
        return _full_rows()[:, :int(case.split()[-1])].copy(), 15, 2, None
    return _crafted_rows(), 12, int(case.split()[-1]), None


K2_CASES = ["pair rows", "one pair row", "ldm rows", "full rows nb 2",
            "full rows nb 3", "full rows nb 7", "full rows nb 100",
            "width 4100", "width 4097", "crafted nb 1", "crafted nb 3",
            "crafted nb 100"]


@pytest.mark.parametrize("case", K2_CASES)
def test_neighbor_unsort_keys_flip_modes(case):
    sk, pbits, nb, pmask = _k2_case(case)
    want = np.asarray(gk.neighbor_unsort_keys(jnp.asarray(sk), pbits, nb,
                                              pos_mask=pmask,
                                              interpret=True))
    assert (want & ((1 << (32 - pbits)) - 1)).any()  # some entry claims
    got = tk.neighbor_unsort_keys(i32(sk), pbits, nb, pmask, flip=0)
    np.testing.assert_array_equal(u32(got), want)
    got = tk.neighbor_unsort_keys(i32(sk ^ F), pbits, nb, pmask,
                                  flip=tk._FLIP)
    np.testing.assert_array_equal(u32(got), want ^ F)
    np.testing.assert_array_equal(
        u32(tk.neighbor_unsort_keys(i32(sk), pbits, nb, pmask)), want)


K3_CASES = {"span 4": (4, 8, 8192), "span 8": (8, 8, 8192),
            "span 16": (16, 32, 4096), "one span": (4, 4, 8192),
            "two spans": (4, 8, 8192),
            "1027 samples a block": (4, 8, 32 * 1027)}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_ldm_keys_flip_modes(case):
    span, B, n = K3_CASES[case]
    stride = tk.ldm_stride(span, n)
    rng = np.random.default_rng(len(case))
    minz = rng.integers(0, 1 << 32, (B, n), np.uint64).astype(np.uint32)
    minz[0, ::3] = 0xFFFFFFFF
    want = np.asarray(gk.ldm_keys(jnp.asarray(minz), span, stride,
                                  interpret=True))
    for flip in (0, tk._FLIP):
        got = tk.ldm_keys(i32(minz), span, stride, flip=flip)
        np.testing.assert_array_equal(u32(got), want ^ np.uint32(flip))
    np.testing.assert_array_equal(u32(tk.ldm_keys(i32(minz), span, stride)),
                                  want)


@pytest.mark.parametrize("case", ["pair rows", "full rows nb 2",
                                  "crafted nb 3"])
def test_unsorted_equals_reference(case):
    """_unsorted (XOR, signed sort, K2 flipped, signed sort, XOR) gives
    the reference's unsigned sort -> neighbor_unsort_keys -> sort."""
    sk, pbits, nb, pmask = _k2_case(case)
    key = np.random.default_rng(1).permuted(sk, axis=1)
    want = np.asarray(gk._sort_rows(gk.neighbor_unsort_keys(
        gk._sort_rows(jnp.asarray(key)), pbits, nb, pos_mask=pmask,
        interpret=True)))
    np.testing.assert_array_equal(u32(tk._unsorted(i32(key), pbits, nb,
                                                   pmask)), want)


@pytest.mark.parametrize("span", [4, 8, 16])
def test_ldm_unsorted_equals_reference(span):
    """ldm_unsorted (K3 flipped, signed sort, K2 flipped, signed sort,
    XOR) gives the reference's ldm_unsorted."""
    n = 8192
    blocks = make_blocks("text", B=2 * span, n=n, seed=span)
    stride = tk.ldm_stride(span, n)
    _, minz = jax_k1(blocks, stride=stride, window=n)
    want = np.asarray(gk.ldm_unsorted(jnp.asarray(blocks), span, 1,
                                      interpret=True,
                                      minz=jnp.asarray(minz)))
    pbits = (want.shape[1] - 1).bit_length()
    assert (want & ((1 << (32 - pbits)) - 1)).any()  # some sample claims
    np.testing.assert_array_equal(u32(tk.ldm_unsorted(i32(minz), span, 1)),
                                  want)


# --- K4 compact_slots_sync -------------------------------------------------

def _pair_su(blocks):
    key_ref, minz = jax_k1(blocks)
    sk = np.sort(key_ref, axis=1)
    su = np.sort(np.asarray(gk.neighbor_unsort_keys(
        jnp.asarray(sk), 15, 1, pos_mask=WINDOW - 1, interpret=True)),
        axis=1)
    return su, minz


@pytest.mark.parametrize("ldm", [0, 4])
@pytest.mark.parametrize("kind", ["text", "mixed"])
def test_compact_slots_sync(kind, ldm):
    blocks = make_blocks(kind)
    lengths = ragged_lengths(4)
    su, minz = _pair_su(blocks)
    su_l = None
    if ldm:
        su_l = gk.ldm_unsorted(jnp.asarray(blocks), 4, 1, interpret=True,
                               minz=jnp.asarray(minz))
    want = np.asarray(gk.compact_slots_sync(
        jnp.asarray(su), WINDOW, jnp.asarray(lengths), width=6, su_ldm=su_l,
        span_blocks=ldm, local_cap=24, max_off=1 << 19, interpret=True))
    got = tk.compact_slots_sync(
        i32(su), WINDOW, torch.from_numpy(lengths), 6,
        None if su_l is None else i32(np.asarray(su_l)), ldm, 24, 1 << 19)
    assert got.shape == (4 * N // WINDOW, WINDOW // 4)
    np.testing.assert_array_equal(u32(got), want)



@pytest.mark.parametrize("flip", [0, 0x80000000], ids=["flip0", "flip"])
@pytest.mark.parametrize("ldm", [0, 4])
def test_compact_slots_sync_flip_modes(ldm, flip):
    """K4 on words XORed with the flip word (the signed sorts' output)
    gives the reference's compact_slots_sync(su_ldm=...) words, the LDM
    rows taken from K3 on K1's samples."""
    blocks = make_blocks("mixed", seed=3)
    lengths = ragged_lengths(4)
    su, minz = _pair_su(blocks)
    su_l = None
    if ldm:
        su_l = np.asarray(gk.ldm_unsorted(jnp.asarray(blocks), 4, 1,
                                          interpret=True,
                                          minz=jnp.asarray(minz)))
        _, samples = tk.hash_keys_winmin_sync(torch.from_numpy(blocks), 6,
                                              WINDOW, 32, samples=True)
        np.testing.assert_array_equal(
            u32(tk.ldm_unsorted(samples, 4, 1, stride=1)), su_l)
    want = np.asarray(gk.compact_slots_sync(
        jnp.asarray(su), WINDOW, jnp.asarray(lengths), width=6,
        su_ldm=None if su_l is None else jnp.asarray(su_l), span_blocks=ldm,
        interpret=True))
    x = np.uint32(flip)
    got = tk.compact_slots_sync(
        i32(su ^ x), WINDOW, torch.from_numpy(lengths), 6,
        None if su_l is None else i32(su_l ^ x), ldm, flip=flip)
    np.testing.assert_array_equal(u32(got), want)


def test_l1_chain_keeps_the_sign_bit_flipped():
    """On the level-1 chain K1 writes flipped keys and samples, _unsorted
    and ldm_unsorted leave their last sorts' words flipped (flip_out), and
    K4 takes them with the flip word: the words are the reference's with
    the sign bit XORed, and no XOR pass stands between."""
    blocks = make_blocks("text")
    key, samples = tk.hash_keys_winmin_sync(torch.from_numpy(blocks), 6,
                                            WINDOW, 32, flip=tk._FLIP,
                                            samples=True)
    su, minz = _pair_su(blocks)
    np.testing.assert_array_equal(
        u32(tk._unsorted(key, 15, 1, WINDOW - 1, flipped=True,
                         flip_out=True)), su ^ F)
    su_l = np.asarray(gk.ldm_unsorted(jnp.asarray(blocks), 4, 1,
                                      interpret=True, minz=jnp.asarray(minz)))
    np.testing.assert_array_equal(
        u32(tk.ldm_unsorted(samples, 4, 1, stride=1, flip_out=True)),
        su_l ^ F)

# --- the composed device half ----------------------------------------------

def _slots(blocks, lengths, ldm, window=WINDOW):
    kw = dict(window=window, ldm=ldm, ldm_max_off=1 << 19)
    want = np.asarray(jmp.find_matches_positions(
        jnp.asarray(blocks), jnp.asarray(lengths), widths=(6,), dense=True,
        sync=True, **kw))
    got = tmp.find_matches_positions(torch.from_numpy(blocks),
                                     torch.from_numpy(lengths), widths=(6,),
                                     dense=True, sync=True, **kw)
    return u32(got), want


@pytest.mark.parametrize("ldm", [0, 4])
@pytest.mark.parametrize("kind", ["mixed", "random"])
def test_slot_words_b4(kind, ldm):
    blocks = make_blocks(kind)
    got, want = _slots(blocks, np.full(4, N, np.int32), ldm)
    assert got.shape == (4 * N // WINDOW, WINDOW // 4)
    assert (want != 0xFFFFFFFF).any()
    np.testing.assert_array_equal(got, want)


def test_slot_words_ragged_lengths():
    blocks = make_blocks("text")
    np.testing.assert_array_equal(*_slots(blocks, ragged_lengths(4), 4))


def test_slot_words_partial_batch_skips_ldm():
    """B=3 is no whole number of 4-block spans: both sides drop LDM."""
    blocks = make_blocks("mixed")[:3].copy()
    got, want = _slots(blocks, ragged_lengths(3), 4)
    np.testing.assert_array_equal(got, want)
    got0, _ = _slots(blocks, ragged_lengths(3), 0)
    np.testing.assert_array_equal(got, got0)


def test_slot_words_one_segment_blocks():
    """N = 32768: one window segment per block."""
    blocks = make_blocks("mixed", B=4, n=WINDOW, seed=9)
    np.testing.assert_array_equal(
        *_slots(blocks, np.full(4, WINDOW, np.int32), 4))


def test_unpack_segments_matches_reference():
    blocks = make_blocks("mixed")
    got, _ = _slots(blocks, np.full(4, N, np.int32), 4)
    mine = tmp.unpack_segments(got, 4, WINDOW)
    ref = jmp.unpack_segments(got, 4, WINDOW)
    assert len(mine) == len(ref) == 4
    for (p, o), (rp, ro) in zip(mine, ref):
        np.testing.assert_array_equal(p, rp)
        np.testing.assert_array_equal(o, ro)


def test_only_the_sync_path_is_ported():
    """The hash-matcher levels are all dense (sync at level 1, full
    resolution at 2-4), and the content levels take find_matches_packed,
    not this path; the parsed branch (dense=False), which no level takes,
    runs and returns (B*nseg, w/4) slot words."""
    from qat_zstd_plugin_tpu.runtime.tpu_codec import TPU_LEVEL_TABLE
    from qat_zstd_plugin_tpu_torch import GpuCodec
    for level, p in sorted(TPU_LEVEL_TABLE.items()):
        codec = GpuCodec(level=level, device="cpu")
        assert codec.level == level
        if p.matcher == "hash":
            assert p.dense
        else:
            assert codec.params.matcher == "content" and level >= 5
    assert [lv for lv, p in TPU_LEVEL_TABLE.items() if p.sync] == [1]
    blocks = torch.zeros((4, WINDOW), dtype=torch.uint8)
    slots = tmp.find_matches_positions(blocks,
                                       torch.zeros(4, dtype=torch.int32),
                                       dense=False)
    assert slots.shape == (4, WINDOW // 4) and slots.dtype == torch.int32
