"""The port's hybrid device-entropy ops against the JAX package's, on the
CPU: the byte-verified hash matcher (B11 gram_pos_planes, B12
neighbor_verify_keys, B13 finalize_verified), compact(coalesce=True), the
per-block FSE tables, bitconcat, B14 (the FSE state machine) and
encode_sequence_sections.

Every input is made with numpy from a seed and goes through the JAX
function (Pallas kernels in interpret mode, as the JAX package's own tests
run them on a CPU) and through the port, whose wrappers run the kernels'
plain-torch twins on CPU tensors. Everything compared is an integer or a
bit, so the tolerance is 0: equality, word for word. The one difference
is B12's repair of the reference's missing-neighbour fill
(test_reference_fill_fault_*).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.format import fse as jfse
from qat_zstd_plugin_tpu.format import sequences as jseq
from qat_zstd_plugin_tpu.format.bitstream import BackwardBitWriter
from qat_zstd_plugin_tpu.ops import bitconcat as jbc
from qat_zstd_plugin_tpu.ops import bitpack as jbp
from qat_zstd_plugin_tpu.ops import fse_kernel as jfk
from qat_zstd_plugin_tpu.ops import fse_tables as jft
from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops import match_pipeline as jmp
from qat_zstd_plugin_tpu_torch import fse_format
from qat_zstd_plugin_tpu_torch.ops import bitconcat as tbc
from qat_zstd_plugin_tpu_torch.ops.bitpack import backward_stream_bytes
from qat_zstd_plugin_tpu_torch.ops import fse_kernel as tfk
from qat_zstd_plugin_tpu_torch.ops import fse_tables as tft
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp
from qat_zstd_plugin_tpu_torch.runtime import gpu_codec

torch.set_num_threads(2)  # six test workers share a few cores

WINDOW = 32768
PBITS = 15
SHAPES = [(8, 32768), (4, 65536)]
KINDS = ["low", "planted", "run"]


def make_blocks(kind: str, B: int, n: int, seed: int = 0) -> np.ndarray:
    """Low-entropy bytes (dense equal grams), random bytes with a planted
    repeat, or random bytes with a 777-byte run; one row is random bytes
    in every kind."""
    rng = np.random.default_rng(seed)
    if kind == "low":
        out = rng.integers(0, 6, (B, n), np.uint8)
    else:
        out = rng.integers(0, 256, (B, n), np.uint8)
    if kind == "planted":
        out[:, 9000:9200] = out[:, 2000:2200]
        out[:, n - 300:] = out[:, n // 2 - 300:n // 2]  # across segments
    if kind == "run":
        out[:, 5000:5777] = 42
        out[:, WINDOW - 400:WINDOW + 377] = 0xFF  # across a segment edge
    out[min(1, B - 1)] = rng.integers(0, 256, n, np.uint8)
    return out


def ragged_lengths(B: int, n: int) -> np.ndarray:
    """Full rows and lengths that hit B13's tail guard (i + 4 <= len)."""
    base = np.array([n, n - 1, n - 3, n // 2 + 2, 100, 0, 5, n], np.int32)
    return np.resize(base, B)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int32).copy())


def assert_true_matches(blocks: np.ndarray, lengths, mlen, moff) -> int:
    """Every claim (mlen, moff) at i copies bytes [i - moff, i - moff +
    mlen) onto [i, i + mlen) inside the block's length. Returns the claim
    count."""
    count = 0
    for b in range(len(blocks)):
        x = blocks[b].astype(np.int64)
        for i in np.nonzero(mlen[b] > 0)[0]:
            L, o = int(mlen[b, i]), int(moff[b, i])
            assert 0 < o <= i and i + L <= lengths[b], (b, i, o, L)
            assert np.array_equal(x[i:i + L], x[i - o:i - o + L]), (b, i, o)
            count += 1
    return count


# --- B11 gram_pos_planes, the 2-key sort, B12 and B13 -----------------------

@functools.lru_cache
def _verified_case(kind: str, shape: tuple, seed: int, neighbors: int,
                   ragged: bool):
    """(blocks, lengths, the reference's stages), built once per module for
    each case (B11's test and B12's at one neighbour share one)."""
    B, n = shape
    blocks = make_blocks(kind, B, n, seed)
    lengths = ragged_lengths(B, n) if ragged else np.full(B, n, np.int32)
    return blocks, lengths, _jax_verified(blocks, lengths, neighbors)


def _jax_verified(blocks, lengths, neighbors=2):
    """The reference's stages, as numpy arrays (its sorts donate their
    inputs, so each stage is copied out first)."""
    g, p = (np.asarray(a) for a in gk.gram_pos_planes(jnp.asarray(blocks),
                                                      WINDOW))
    sg, sp = (np.asarray(a) for a in gk._sort_rows2(jnp.asarray(g),
                                                    jnp.asarray(p)))
    k = np.asarray(gk.neighbor_verify_keys(jnp.asarray(sg), jnp.asarray(sp),
                                           PBITS, neighbors))
    su = np.asarray(gk._sort_rows(jnp.asarray(k)))
    ml, mo = gk.finalize_verified(jnp.asarray(su), jnp.asarray(blocks),
                                  jnp.asarray(lengths), WINDOW)
    return [g, p, sg, sp, k, su, np.asarray(ml), np.asarray(mo)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=["8x32K", "4x64K"])
def test_gram_pos_planes_and_sort(shape, kind):
    B, n = shape
    blocks, _, ref = _verified_case(kind, shape, 1, 1, False)
    g_ref, p_ref, sg_ref, sp_ref = ref[:4]
    g, p = tk.gram_pos_planes(torch.from_numpy(blocks), WINDOW)
    assert g.shape == p.shape == (B * n // WINDOW, WINDOW)
    np.testing.assert_array_equal(u32(g), g_ref)
    np.testing.assert_array_equal(u32(p), p_ref)
    sg, sp = tk._sort_rows2(g, p, PBITS)
    np.testing.assert_array_equal(u32(sg), sg_ref)  # unsigned gram order
    np.testing.assert_array_equal(u32(sp), sp_ref)


@pytest.mark.parametrize("neighbors", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=["8x32K", "4x64K"])
def test_neighbor_verify_keys(shape, kind, neighbors):
    _, _, sg, sp, k_ref = _verified_case(kind, shape, neighbors, neighbors,
                                         False)[2][:5]
    got = tk.neighbor_verify_keys(i32(sg), i32(sp), PBITS, neighbors)
    np.testing.assert_array_equal(u32(got), k_ref)
    assert (u32(got) & 0x1FFFF).any()  # offsets were claimed


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=["8x32K", "4x64K"])
def test_finalize_verified_ragged(shape, kind):
    blocks, lengths, ref = _verified_case(kind, shape, 3, 2, True)
    *_, su, ml_ref, mo_ref = ref
    ml, mo = tk.finalize_verified(i32(su), torch.from_numpy(blocks),
                                  torch.from_numpy(lengths))
    np.testing.assert_array_equal(ml.numpy(), ml_ref)
    np.testing.assert_array_equal(mo.numpy(), mo_ref)


@pytest.mark.parametrize("kind", KINDS)
def test_candidates_hash_verified_every_claim_true(kind):
    B, n = 4, 65536
    blocks = make_blocks(kind, B, n, seed=4)
    lengths = ragged_lengths(B, n)
    ml_ref, mo_ref = gk.candidates_hash_verified(
        jnp.asarray(blocks), jnp.asarray(lengths), neighbors=2,
        window=WINDOW)
    ml, mo = tk.candidates_hash_verified(torch.from_numpy(blocks),
                                         torch.from_numpy(lengths))
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ml_ref))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(mo_ref))
    assert assert_true_matches(blocks, lengths, ml.numpy(), mo.numpy()) > 100
    if kind == "run":  # the run's interior: exact offset-1 lengths
        assert mo[0, 5001] == 1 and ml[0, 5001] == 5777 - 5001


def fault_block(n: int = 65536, seed: int = 0) -> np.ndarray:
    """A segment that holds exactly one gram below 0xFFFFFFFF: a non-0xFF
    first byte, 0xFF to the segment's end and for the next segment's first
    three bytes, random bytes after them."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, n, np.uint8)
    x[0] = 0x00
    x[1:WINDOW + 3] = 0xFF
    return x


def test_reference_fill_fault_is_repaired():
    """The reference's B12 reads the missing neighbour of sorted entry 1
    (k = 2) as gram 0xFFFFFFFF at position 0, so it claims (32, 1) at
    position 1, a false match: byte 0 is not byte 1. The port's B12 needs
    i >= k: no claim there, every claim true, and everything else equal."""
    blocks = np.stack([fault_block(), make_blocks("low", 1, 65536)[0]])
    lengths = np.full(2, 65536, np.int32)
    _, _, sg, sp, k_ref, _, ml_ref, mo_ref = _jax_verified(blocks, lengths)
    assert (ml_ref[0, 1], mo_ref[0, 1]) == (32, 1)  # the reference's claim
    assert blocks[0, 0] != blocks[0, 1]             # ... is false
    got = u32(tk.neighbor_verify_keys(i32(sg), i32(sp), PBITS, 2))
    assert k_ref[0, 1] & 0x1FFFF == 1 and got[0, 1] & 0x1FFFF == 0
    differ = np.nonzero(got != k_ref)
    assert list(zip(*differ)) == [(0, 1)]  # sorted entry 1 of row 0 only
    ml, mo = tk.candidates_hash_verified(torch.from_numpy(blocks),
                                         torch.from_numpy(lengths))
    assert ml[0, 1] == 0 and mo[0, 1] == 0
    assert_true_matches(blocks, lengths, ml.numpy(), mo.numpy())
    same = np.ones_like(ml_ref, bool)
    same[0, 1] = False
    np.testing.assert_array_equal(ml.numpy()[same], ml_ref[same])


# --- compact(coalesce=True), both branches ---------------------------------

@functools.lru_cache
def _parse_inputs(seed: int):
    """Verified (mlen, moff) of four 64 KiB blocks and their greedy parse;
    plus crafted claims at the payload's limits (lengths to 16383,
    offsets to 32767) on chosen positions >= 4 apart."""
    B, n = 4, 65536
    blocks = make_blocks("low", B, n, seed)
    blocks[2] = make_blocks("run", 1, n, seed)[0]
    lengths = ragged_lengths(B, n)
    ml, mo = gk.candidates_hash_verified(jnp.asarray(blocks),
                                         jnp.asarray(lengths))
    chosen = np.asarray(jmp.parse_greedy_scan(ml))
    rng = np.random.default_rng(seed)
    craft_ch = np.zeros((B, n), bool)
    craft_ch[:, ::4] = rng.random((B, n // 4)) < 0.5
    craft_ml = rng.integers(4, 16384, (B, n)).astype(np.int32)
    craft_ml[:, :50] = 16383
    craft_mo = rng.integers(1, 32768, (B, n)).astype(np.int32)
    craft_mo[:, 7::8] = 32767
    craft_mo[:, 3::4] = craft_mo[:, 2::4]  # chains to coalesce
    return {"parsed": (chosen, np.asarray(ml), np.asarray(mo), lengths),
            "crafted": (craft_ch, craft_ml, craft_mo, lengths)}


@pytest.mark.parametrize("max_seq", [16384, 3000])
@pytest.mark.parametrize("window", [WINDOW, 1 << 30],
                         ids=["segmented", "unsegmented"])
@pytest.mark.parametrize("source", ["parsed", "crafted"])
def test_compact_coalesce(source, window, max_seq):
    chosen, ml, mo, lengths = _parse_inputs(5)[source]
    want = jmp.compact(jnp.asarray(chosen), jnp.asarray(ml), jnp.asarray(mo),
                       jnp.asarray(lengths), max_seq, coalesce=True,
                       window=window)
    got = tmp.compact(torch.from_numpy(chosen), torch.from_numpy(ml),
                      torch.from_numpy(mo), torch.from_numpy(lengths),
                      max_seq, window=window, coalesce=True)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert bool(got["overflow"].any()) == (max_seq < 16384)
    packed = tmp.pack_wide(got)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jmp._pack_wide_jit(want, max_seq)))
    for k, v in tmp.unpack_outputs_wide(packed.numpy()).items():
        np.testing.assert_array_equal(
            v, jmp.unpack_outputs_wide(packed.numpy())[k])


def test_segmented_sum():
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 1000, (3, 500)).astype(np.int32)
    starts = rng.random((3, 500)) < 0.1
    starts[1] = False
    want = jmp._segmented_sum(jnp.asarray(vals), jnp.asarray(starts))
    got = tmp._segmented_sum(torch.from_numpy(vals), torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- FSE tables -------------------------------------------------------------

def test_log2_table_equals_jax():
    want = np.asarray(jnp.log2(jnp.maximum(jnp.arange(65), 1)
                               .astype(jnp.float32)))
    np.testing.assert_array_equal(tft._LOG2.view(np.uint32),
                                  want.view(np.uint32))


def _codes(seed: int, kind: str, B: int = 6, S: int = 600):
    """Code streams of B blocks with 0, 1, 15, 16, 300 and S valid rows:
    skewed, flat and single-symbol mixes."""
    rng = np.random.default_rng(seed)
    K = tft.NSYM[kind]
    codes = rng.integers(0, K, (B, S)).astype(np.int32)
    codes[0, ::2] = rng.integers(0, 3, S // 2)
    codes[3] = 5  # one symbol
    codes[4, : S // 2] = rng.zipf(1.5, S // 2).clip(max=K) - 1
    counts = np.array([0, 1, 15, 16, 300, S])[:B]
    valid = np.arange(S)[None, :] < counts[:, None]
    return codes, valid


@pytest.mark.parametrize("kind", ["ll", "of", "ml"])
def test_histogram_normalize_build_tables(kind):
    al = tft.ALS[kind]
    K = tft.NSYM[kind]
    codes, valid = _codes(7, kind)
    hist_ref = jft.histogram(jnp.asarray(codes), jnp.asarray(valid), K)
    hist = tft.histogram(torch.from_numpy(codes), torch.from_numpy(valid), K)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(hist_ref))
    norm_ref = np.asarray(jft.normalize(hist_ref, al))
    norm = tft.normalize(hist, al)
    np.testing.assert_array_equal(norm.numpy(), norm_ref)
    rows = norm_ref.sum(1) == 1 << al  # blocks with a table to build
    assert rows.sum() >= 4
    t_ref = jft.build_tables(jnp.asarray(norm_ref[rows]), al)
    t = tft.build_tables(norm[torch.from_numpy(rows)], al)
    for name in ("state_table", "dnb", "dfs"):
        np.testing.assert_array_equal(t[name].numpy(),
                                      np.asarray(t_ref[name]), err_msg=name)
    for r, nrm in enumerate(norm_ref[rows]):  # and the port's host copy
        host = fse_format.build_encode_table([int(c) for c in nrm], al)
        np.testing.assert_array_equal(t["state_table"][r].numpy(),
                                      host.state_table)
        np.testing.assert_array_equal(t["dnb"][r].numpy(),
                                      host.delta_nb_bits)
        np.testing.assert_array_equal(t["dfs"][r].numpy(),
                                      host.delta_find_state)


@pytest.mark.parametrize("kind", ["ll", "of", "ml"])
def test_normalize_shaves_excess(kind):
    """Many rare symbols and one dominant one: every present symbol needs
    a slot, so the excess is shaved off the largest counts."""
    K = tft.NSYM[kind]
    hist = np.zeros((3, K), np.int32)
    hist[0, :] = 1
    hist[0, 0] = 100000
    hist[1, : K // 2] = np.arange(1, K // 2 + 1)
    hist[2, 3] = 7
    want = np.asarray(jft.normalize(jnp.asarray(hist), tft.ALS[kind]))
    got = tft.normalize(torch.from_numpy(hist), tft.ALS[kind])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["ll", "of", "ml"])
def test_plan_streams(kind):
    codes, valid = _codes(8, kind)
    use_ref, norm_ref, mixed_ref = jft.plan_streams(
        jnp.asarray(codes), jnp.asarray(valid), kind)
    use, norm, mixed = tft.plan_streams(torch.from_numpy(codes),
                                        torch.from_numpy(valid), kind)
    np.testing.assert_array_equal(use.numpy(), np.asarray(use_ref))
    assert use.any() and not use.all()
    np.testing.assert_array_equal(norm.numpy(), np.asarray(norm_ref))
    for name in mixed_ref:
        np.testing.assert_array_equal(mixed[name].numpy(),
                                      np.asarray(mixed_ref[name]))


# --- bitconcat ---------------------------------------------------------------

def _items(seed: int, R: int, S: int, maxbits: int):
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, maxbits + 1, (R, S)).astype(np.int32)
    nb[rng.random((R, S)) < 0.2] = 0
    vals = rng.integers(0, 1 << 62, (R, S), dtype=np.int64) \
        & ((np.int64(1) << nb.astype(np.int64)) - 1)
    lo = (vals & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (vals >> 32).astype(np.uint32).view(np.int32)
    return lo, hi, nb, vals


@pytest.mark.parametrize("seed, S, maxbits, words", [
    (0, 64, 11, 40), (1, 100, 64, 260), (2, 257, 24, 220),
    (3, 300, 64, 40)])  # the last overflows: equal words all the same
def test_bitconcat(seed, S, maxbits, words):
    lo, hi, nb, vals = _items(seed, 5, S, maxbits)
    w_ref, b_ref, o_ref = jbc.bitconcat(jnp.asarray(lo), jnp.asarray(hi),
                                        jnp.asarray(nb), words,
                                        max_item_bits=maxbits)
    w, b, o = tbc.bitconcat(torch.from_numpy(lo), torch.from_numpy(hi),
                            torch.from_numpy(nb), words,
                            max_item_bits=maxbits)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    assert o.any() == (seed == 3)
    for r in range(5):  # the golden backward writer's stream
        if o[r]:
            continue
        bw = BackwardBitWriter()
        for v, n in zip(vals[r], nb[r]):
            if n:
                bw.add(int(v), int(n))
        assert backward_stream_bytes(w[r].numpy(), int(b[r])) == bw.close()


# --- B14 and encode_sequence_sections ----------------------------------------

COUNTS = [0, 1, 127, 128, 5000]


def _sequences(seed: int, S: int = 5008):
    """Sequences of blocks with COUNTS valid rows: literal lengths to
    70000, match lengths 3 to 70000, offsets 1 to 2^17 (extras that spill
    into the high word)."""
    rng = np.random.default_rng(seed)
    B = len(COUNTS)
    ll = np.zeros((B, S), np.int32)
    of = np.zeros((B, S), np.int32)
    ml = np.zeros((B, S), np.int32)
    ml[:] = 3  # the invalid rows' fill in encode_sequence_sections
    for b, n in enumerate(np.minimum(COUNTS, S)):
        ll[b, :n] = rng.integers(0, 300, n)
        ll[b, :n:7] = rng.integers(0, 70000, len(ll[b, :n:7]))
        of[b, :n] = rng.integers(1, 1 << 17, n)
        of[b, :n:3] = rng.integers(1, 64, len(of[b, :n:3]))
        of[b, :n:101] = (1 << 17) - 3  # offset value 2^17
        ml[b, :n] = rng.integers(4, 40, n)
        ml[b, :n:11] = rng.integers(3, 70000, len(ml[b, :n:11]))
    return ll, of, ml, np.array(COUNTS, np.int32)


def test_codes_equal_jax():
    ll, of, ml, _ = _sequences(9)
    ofv = of.astype(np.int64) + 3
    want = jfk._codes(jnp.asarray(ll), jnp.asarray(ml),
                      jnp.asarray(ofv.astype(np.int32)))
    got = tfk._codes(torch.from_numpy(ll).long(), torch.from_numpy(ml).long(),
                     torch.from_numpy(ofv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("custom", [False, True], ids=["predef", "custom"])
def test_encode_sequence_sections(custom):
    ll, of, ml, nseq = _sequences(10)
    want = jfk.encode_sequence_sections(
        jnp.asarray(ll), jnp.asarray(of), jnp.asarray(ml), jnp.asarray(nseq),
        max_words=8192, custom=custom)
    got = tfk.encode_sequence_sections(
        torch.from_numpy(ll), torch.from_numpy(of), torch.from_numpy(ml),
        torch.from_numpy(nseq), max_words=8192, custom=custom)
    for name, g, w in zip(("words", "bits", "sec_over"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert sorted(got[3]) == sorted(want[3])
    for k in want[3]:
        np.testing.assert_array_equal(got[3][k].numpy(),
                                      np.asarray(want[3][k]), err_msg=k)
    if custom:
        assert got[3]["use_of"][4] and not got[3]["use_ll"][1]
    # The host's section bytes: the port's nbseq_header and write_ncount
    # against the JAX package's (tpu_codec.collect_batch's wrapping).
    words, bits = want[0], want[1]
    plan = {k: np.asarray(v) for k, v in want[3].items()}
    for b, n in enumerate(COUNTS):
        if n == 0:
            continue
        mode, desc = 0, b""
        for shift, kind, al in ((6, "ll", 6), (4, "of", 5), (2, "ml", 6)):
            if plan and plan[f"use_{kind}"][b]:
                mode |= 2 << shift
                desc += jfse.write_ncount(
                    [int(x) for x in plan[f"norm_{kind}"][b]], al)
        ref = (jseq.nbseq_header(n) + bytes([mode]) + desc
               + jbp.backward_stream_bytes(np.asarray(words)[b],
                                           int(np.asarray(bits)[b])))
        sec = gpu_codec.device_sequence_section(
            n, got[0][b].numpy(), int(got[1][b]),
            {k: v.numpy() for k, v in got[3].items()}, b)
        assert sec == ref, b
        if not custom:  # predefined: the golden sequence encoder's bytes
            assert sec == jseq.encode_sequences(
                ll[b, :n].astype(np.int64), of[b, :n].astype(np.int64),
                ml[b, :n].astype(np.int64), force_predefined=True), b


def test_section_overflow_and_empty_blocks():
    """A stream over max_words sets sec_over as the reference does; a block
    of 0 sequences writes the flush item alone."""
    ll, of, ml, nseq = _sequences(11)
    args = [jnp.asarray(a) for a in (ll, of, ml, nseq)]
    w_ref, b_ref, o_ref, _ = jfk.encode_sequence_sections(*args,
                                                          max_words=512)
    w, b, o, _ = tfk.encode_sequence_sections(
        *(torch.from_numpy(a) for a in (ll, of, ml, nseq)), max_words=512)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    assert o.numpy().tolist() == [False, False, False, False, True]
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    assert b[0] == 17  # the flush item alone


@pytest.mark.parametrize("custom", [False, True], ids=["predef", "custom"])
def test_state_machine_twin_equals_pallas(custom):
    """B14 on its own: the twin against the Pallas kernel (interpret mode)
    on the port's reversed codes, tables and initial states."""
    ll, of, ml, nseq = _sequences(12, S=600)
    nseq = np.minimum(nseq, 600)
    prep = tfk.prepare_sections(
        *(torch.from_numpy(a) for a in (ll, of, ml, nseq)), custom=custom)
    codes, tables, inits, n = prep["state_args"]
    lo, nb = tfk.run_state_kernel(codes, tables, inits, n)
    B = len(nseq)
    lo_ref, nb_ref = jfk._run_state_kernel(
        [jnp.asarray(c.numpy()) for c in codes],
        [tuple(jnp.asarray(t.numpy()) for t in tb) for tb in tables],
        [jnp.asarray(i.numpy()).reshape(1, B) for i in inits],
        jnp.asarray(nseq).reshape(1, B))
    S1 = lo.shape[0]
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_ref)[:S1])
    np.testing.assert_array_equal(nb.numpy(), np.asarray(nb_ref)[:S1])
    assert (nb.numpy()[nseq, np.arange(B)] == 17).all()  # the flush items
