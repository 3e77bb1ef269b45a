"""The port's level 5-12 device ops (the exact-LCP content matcher) against
the JAX package's, on the CPU.

Every input is made with numpy from a seed and goes through the JAX
function (Pallas kernels in interpret mode, the XLA parse scan as the
JAX package runs it on a CPU) and through the port, whose wrappers run
the kernels' plain-torch twins on CPU tensors. Everything is integer, so
the tolerance is 0: equality, word for word.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops import match_pipeline as jmp
from qat_zstd_plugin_tpu.ops import parse_kernel as jpk
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp
from qat_zstd_plugin_tpu_torch.ops import parse_kernel as tpk

torch.set_num_threads(2)  # six test workers share a few cores

N = 131072


def make_blocks(kind: str, B: int, seed: int = 0) -> np.ndarray:
    """B blocks of N bytes: the seeded corpus ("mixed", with an all-same
    block, a block of random bytes and runs past 65535, one to the row's
    end), random bytes, or the corpus alone."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (B, N), np.uint8)
    out = np.frombuffer(make_corpus(B * N, seed), np.uint8).reshape(B, N)
    out = out.copy()
    if kind == "mixed":
        out[0, 1000:70000] = 0xC3          # a run past 65535, top bit set
        out[1 % B] = 0x41                  # an all-same block
        out[2 % B, N - 70000:] = 9         # a run to the row's end
        out[3 % B] = rng.integers(0, 256, N, np.uint8)
    return out


def lengths_for(B: int) -> np.ndarray:
    base = np.array([N, N - 1, N // 2 + 3, 100, N, N - 7, 5, N], np.int32)
    return np.resize(base, B)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# --- B9 ldm_winmin ---------------------------------------------------------

@pytest.mark.parametrize("stride", [32, 64])
def test_ldm_winmin(stride):
    blocks = make_blocks("mixed", 8, seed=stride)
    want = np.asarray(gk.ldm_winmin(jnp.asarray(blocks), stride,
                                    interpret=True))
    got = tk.ldm_winmin(t(blocks), stride)
    assert got.shape == (8, N) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_ldm_winmin_equals_hash_keys_winmin_plane():
    blocks = make_blocks("random", 2)
    _, minz = tk.hash_keys_winmin(t(blocks), 6, 32768, 32)
    assert torch.equal(tk.ldm_winmin(t(blocks), 32), minz)


# --- B10 parse_greedy ------------------------------------------------------

def _mlen_rows(B: int, n: int, seed: int) -> np.ndarray:
    """Candidate lengths with every feature the parse reacts to: zeros,
    short and long matches, lazy ties and strict look-ahead wins, and a
    match that ends exactly at n."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((B, n)) < 0.3,
                 rng.integers(0, 40, (B, n)), 0).astype(np.int32)
    m[0, :] = 0
    m[1 % B, :] = rng.integers(4, 9, n)            # every position >= 4
    m[2 % B, 100:110] = 7                          # lazy ties take
    m[2 % B, n - 20] = 20                          # ends exactly at n
    m[3 % B, 8190:8200] = np.arange(4, 14)         # strictly rising
    m[B - 1, n - 3:] = 60                          # past the row's end
    return m


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("shape", [(8, 16384), (4, 131072)])
def test_parse_greedy(shape, lazy):
    mlen = _mlen_rows(*shape, seed=shape[1] + lazy)
    want_scan = np.asarray(jmp.parse_greedy_scan(jnp.asarray(mlen), lazy))
    want_pallas = np.asarray(jpk.parse_greedy_pallas(
        jnp.asarray(mlen), interpret=True, lazy=lazy))
    got = tpk.parse_greedy(t(mlen), lazy)
    assert got.dtype == torch.bool and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want_scan)
    np.testing.assert_array_equal(got.numpy(), want_pallas)


def test_parse_greedy_on_candidates():
    """The parse of real candidate lengths (the corpus at neighbours 4)."""
    blocks = make_blocks("text", 4, seed=5)
    ml, _ = jmp.candidates(jnp.asarray(blocks), jnp.asarray(lengths_for(4)),
                           4)
    want = np.asarray(jmp.parse_greedy_scan(ml, True))
    np.testing.assert_array_equal(
        tpk.parse_greedy(t(np.asarray(ml)), True).numpy(), want)


# --- candidates ------------------------------------------------------------

@pytest.mark.parametrize("neighbors", [4, 16])
@pytest.mark.parametrize("kind", ["mixed", "random"])
def test_candidates(kind, neighbors):
    blocks = make_blocks(kind, 4, seed=neighbors)
    lengths = lengths_for(4)
    want_ml, want_mo = jmp.candidates(jnp.asarray(blocks),
                                      jnp.asarray(lengths), neighbors)
    ml, mo = tmp.candidates(t(blocks), t(lengths), neighbors)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(want_ml))
    np.testing.assert_array_equal(mo.numpy(), np.asarray(want_mo))
    assert int(ml.max()) == 65535 or kind == "random"


def test_candidates_refuse_segmented_sorts():
    blocks = t(make_blocks("random", 1))
    with pytest.raises(ValueError, match="not ported"):
        tmp.candidates(blocks, t(lengths_for(1)), 4, window=32768)


# --- merge_ldm, compact, pack_outputs ---------------------------------------

def _ldm_blocks(B: int = 8, seed: int = 1):
    """Blocks with long-distance repeats, and their lengths."""
    blocks = make_blocks("mixed", B, seed=seed)
    blocks[5] = blocks[1]  # long-distance repeats for the LDM
    blocks[6, :N // 2] = blocks[2, N // 2:]
    return blocks, lengths_for(B)


@functools.lru_cache
def _ldm_inputs(seed: int = 1):
    """_ldm_blocks and the reference's candidates (numpy), built once per
    seed."""
    blocks, lengths = _ldm_blocks(seed=seed)
    ml, mo = jmp.candidates(jnp.asarray(blocks), jnp.asarray(lengths), 4)
    return blocks, lengths, np.asarray(ml), np.asarray(mo)


def test_merge_ldm():
    blocks, lengths, ml, mo = _ldm_inputs()
    su = gk.ldm_unsorted(jnp.asarray(blocks), 4, neighbors=1, interpret=True)
    max_off = (1 << 18) - 1
    want = gk.merge_ldm(jnp.asarray(ml), jnp.asarray(mo), su,
                        jnp.asarray(lengths), 4, local_cap=16,
                        max_off=max_off)
    su_t = tk.ldm_unsorted(tk.ldm_winmin(t(blocks), 32), 4)
    np.testing.assert_array_equal(su_t.numpy().view(np.uint32),
                                  np.asarray(su))
    got = tk.merge_ldm(t(ml), t(mo), su_t, t(lengths), 4, local_cap=16,
                       max_off=max_off)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0]) != ml).any()  # LDM took some


@pytest.mark.parametrize("max_seq", [16384, 2000, 200000])
def test_compact_and_pack_outputs(max_seq):
    blocks, lengths, ml, mo = _ldm_inputs(seed=max_seq % 7)
    chosen = jmp.parse_greedy_scan(jnp.asarray(ml), True)
    want_out = jmp.compact(chosen, jnp.asarray(ml), jnp.asarray(mo),
                           jnp.asarray(lengths), max_seq)
    want = np.asarray(jmp.pack_outputs(want_out, max_seq))
    out = tmp.compact(t(np.asarray(chosen)), t(ml), t(mo), t(lengths),
                      max_seq)
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_out[k]),
                                      err_msg=k)
    got = tmp.pack_outputs(out, max_seq).numpy()
    np.testing.assert_array_equal(got, want)
    if max_seq == 2000:
        assert (got[:, 0, 1] & 1).any()  # some block overflowed
    u_got, u_want = tmp.unpack_outputs(got), jmp.unpack_outputs(want)
    for k in u_want:
        np.testing.assert_array_equal(u_got[k], u_want[k], err_msg=k)


def test_pack_outputs_long_literal_run_overflows():
    """A literal run longer than 65535 sets the overflow bit."""
    B = 2
    mlen = np.zeros((B, N), np.int32)
    mlen[:, 70000] = 8
    mlen[1, 10] = 8
    moff = np.where(mlen > 0, 3, 0).astype(np.int32)
    chosen = mlen >= 4
    lengths = np.full(B, N, np.int32)
    want = np.asarray(jmp.pack_outputs(jmp.compact(
        jnp.asarray(chosen), jnp.asarray(mlen), jnp.asarray(moff),
        jnp.asarray(lengths), 64), 64))
    got = tmp.pack_outputs(tmp.compact(t(chosen), t(mlen), t(moff),
                                       t(lengths), 64), 64).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:, 0, 1] & 1) == [1, 1]


# --- the composition -------------------------------------------------------

@pytest.mark.parametrize("B, ldm", [(8, 4), (6, 4)])  # 6 % 4: no LDM
def test_find_matches_packed(B, ldm):
    blocks, lengths = _ldm_blocks(seed=B)
    blocks, lengths = blocks[:B].copy(), lengths[:B].copy()
    kw = dict(neighbors=8, max_seq=16384, lazy=True, ldm=ldm,
              ldm_max_off=1 << 22)
    want = np.asarray(jmp.find_matches_packed(
        jnp.asarray(blocks), jnp.asarray(lengths), parser="scan", **kw))
    tk.reset_launches()
    got = tmp.find_matches_packed(t(blocks), t(lengths), **kw)
    assert all(n == 0 for n in tk.launches.values())  # twins on a CPU
    np.testing.assert_array_equal(got.numpy(), want)
