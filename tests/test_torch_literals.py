"""The port's device Huffman literals (full device entropy) against the JAX
package's, on the CPU: B15 literal_keys, B16 byte_hist, the Huffman
tables, encode_literals_device and the host's device_literals_section.

Every input is made with numpy from a seed (or by the port's first stage,
whose outputs tests/test_torch_entropy.py and test_torch_content.py hold
equal to the reference's) and goes through the JAX function (the Pallas
kernels in interpret mode, as the JAX package's own tests run them on a
CPU) and through the port, whose wrappers run the kernels' plain-torch
twins on CPU tensors. Everything compared is an integer, a flag or a
byte, so the tolerance is 0: equality. The one difference is B15's
repair of the reference's 16384-position window
(test_literal_keys_repaired_window).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import huffman_tables as jht
from qat_zstd_plugin_tpu.ops import literals_kernel as jlk
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.ops import huffman_tables as tht
from qat_zstd_plugin_tpu_torch.ops import literals_kernel as tlk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp

torch.set_num_threads(2)  # six test workers share a few cores

# (level, B, N): the first stages of the hash path (L1) and the content
# path (L5) at the reference test's block (64 KiB) and the codec's (128 KiB).
STAGES = {"L1_4x64K": (1, 4, 65536), "L1_2x128K": (1, 2, 131072),
          "L5_4x64K": (5, 4, 65536), "L5_2x128K": (5, 2, 131072)}


def _blocks(B: int, N: int, seed: int) -> np.ndarray:
    """Corpus rows, the last one random bytes (nearly every position a
    literal)."""
    out = np.frombuffer(make_corpus(B * N, seed), np.uint8).reshape(B, N)
    out = out.copy()
    out[B - 1] = np.random.default_rng(seed).integers(0, 256, N, np.uint8)
    return out


def _lengths(B: int, N: int) -> np.ndarray:
    lengths = np.full(B, N, np.int32)
    lengths[0] = N - 4321
    return lengths


@functools.lru_cache
def first_stage(case: str):
    """(blocks, lengths, chosen, mlen) numpy, the port's first stage, built
    once per case (B15's test and B16's share it)."""
    level, B, N = STAGES[case]
    blocks = _blocks(B, N, level * 10 + B)
    lengths = _lengths(B, N)
    args = (torch.from_numpy(blocks), torch.from_numpy(lengths))
    if level == 1:
        _, chosen, mlen = tmp.verified_sequences(*args)
    else:
        _, chosen, mlen = tmp.content_sequences(*args, lazy=True,
                                                window=131072)
    return blocks, lengths, chosen.numpy(), mlen.numpy()


def _ref_keys(blocks, lengths, chosen, mlen) -> np.ndarray:
    return np.asarray(jlk.literal_keys(
        jnp.asarray(blocks), jnp.asarray(lengths), jnp.asarray(chosen),
        jnp.asarray(mlen), interpret=True))


def _port_keys(blocks, lengths, chosen, mlen) -> np.ndarray:
    return tlk.literal_keys(*(torch.from_numpy(a) for a in (
        blocks, lengths, chosen, mlen))).numpy().view(np.uint32)


# --- B15 literal_keys and B16 byte_hist --------------------------------------

@pytest.mark.parametrize("case", sorted(STAGES))
def test_literal_keys_equals_reference(case):
    """Wherever every chosen match is at most 16383 long (every match of
    the hash path, and these content blocks), the keys are the
    reference's."""
    blocks, lengths, chosen, mlen = first_stage(case)
    assert chosen.any()
    assert mlen[chosen].max() <= 16383
    want = _ref_keys(blocks, lengths, chosen, mlen)
    got = _port_keys(blocks, lengths, chosen, mlen)
    np.testing.assert_array_equal(got, want)
    assert (got == 0xFFFFFFFF).any() and (got != 0xFFFFFFFF).any()


@pytest.mark.parametrize("length", [16383, 16384, 16385, 40000, 65535])
def test_literal_keys_repaired_window(length):
    """One chosen match of `length` at position 777 of a row (and one that
    ends at the row's end in another): the reference marks the match's
    positions from start + 16384 on as literals; the port does not. The
    two differ exactly there."""
    B, N, start = 2, 131072, 777
    rng = np.random.default_rng(length)
    blocks = rng.integers(0, 256, (B, N), np.uint8)
    lengths = np.full(B, N, np.int32)
    chosen = np.zeros((B, N), bool)
    mlen = rng.integers(0, 100, (B, N)).astype(np.int32)
    starts = (start, N - length)
    for row, s in enumerate(starts):
        chosen[row, s] = True
        mlen[row, s] = length
    want = _ref_keys(blocks, lengths, chosen, mlen)
    got = _port_keys(blocks, lengths, chosen, mlen)
    for row, s in enumerate(starts):
        inside = np.arange(s, s + length)
        assert (got[row, inside] == 0xFFFFFFFF).all()
        outside = np.setdiff1d(np.arange(N), inside)
        assert (got[row, outside] == (outside << 8 | blocks[row, outside])
                ).all()
        differ = np.flatnonzero(got[row] != want[row])
        np.testing.assert_array_equal(differ, inside[16384:])


@pytest.mark.parametrize("case", sorted(STAGES))
def test_byte_hist_equals_reference(case):
    keys = _port_keys(*first_stage(case))
    want = np.asarray(jlk.byte_hist(jnp.asarray(keys), interpret=True))
    got = tlk.byte_hist(torch.from_numpy(keys.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.sum(1), (keys != 0xFFFFFFFF).sum(1))


# --- Huffman tables ----------------------------------------------------------

def _histograms(kind: str) -> np.ndarray:
    """(8, 256) byte histograms of one kind, from a seed."""
    rng = np.random.default_rng(sorted(HIST_KINDS).index(kind))
    h = np.zeros((8, 256), np.int64)
    for b in range(8):
        if kind == "corpus":
            keys = _port_keys(*first_stage("L5_4x64K"))
            h = np.stack([np.bincount(k[k != 0xFFFFFFFF] & 0xFF,
                                      minlength=256) for k in keys])
            break
        if kind == "text":
            syms = rng.choice(256, 40, replace=False)
            h[b, syms] = rng.zipf(1.5, 40).clip(1, 50000)
        elif kind == "two_symbols":
            h[b, rng.choice(256, 2, replace=False)] = rng.integers(1, 60000,
                                                                   2)
        elif kind == "one_symbol":
            h[b, rng.integers(0, 256)] = rng.integers(1, 131072)
        elif kind == "uniform_256":
            h[b] = rng.integers(1, 3) * (b + 1)
        elif kind == "heavy_skew":
            h[b, rng.integers(0, 256)] = 100000
            h[b, rng.choice(256, 100, replace=False)] += 1
        elif kind == "power_of_two_ratios":
            # 2^16, 2^15, ..., 2^(17-m), 2^(17-m): a total of 2^17, so
            # every -log2(p) is an integer.
            m = int(rng.integers(2, 12))
            counts = [1 << (16 - i) for i in range(m)] + [1 << (17 - m)]
            h[b, rng.choice(256, m + 1, replace=False)] = counts
        elif kind == "empty":
            pass
    return h


HIST_KINDS = ["corpus", "text", "two_symbols", "one_symbol", "uniform_256",
              "heavy_skew", "power_of_two_ratios", "empty"]


@pytest.mark.parametrize("kind", HIST_KINDS)
def test_build_tables_equals_reference(kind):
    hist = _histograms(kind).astype(np.int32)
    want = jht.build_tables(jnp.asarray(hist))
    got = tht.build_tables(torch.from_numpy(hist))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    ok = got["ok"].numpy()
    assert ok.any() == (kind not in ("one_symbol", "empty"))


def _jnp_initial(h: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The reference's initial lengths, clipped: float32 p and log2."""
    p = jnp.asarray(h, jnp.float32) / jnp.asarray(t, jnp.float32)
    l0 = jnp.ceil(-jnp.log2(jnp.maximum(p, 1e-9))).astype(jnp.int32)
    return np.asarray(jnp.clip(l0, 1, tht.MAX_BITS))


@pytest.mark.parametrize("sweep", ["all_totals_to_2048", "random_to_131072",
                                   "powers_of_two"])
def test_initial_lengths_integer_rule_equals_log2(sweep):
    """The smallest k with hist << k >= total equals the reference's
    ceil(-log2(float32 hist / float32 total)) (clipped to 1..11)."""
    if sweep == "all_totals_to_2048":
        t = np.repeat(np.arange(1, 2049), np.arange(1, 2049))
        h = np.concatenate([np.arange(1, n + 1) for n in range(1, 2049)])
    elif sweep == "random_to_131072":
        rng = np.random.default_rng(7)
        t = rng.integers(1, 131073, 1 << 20)
        h = rng.integers(1, t + 1)
    else:
        j, k = np.meshgrid(np.arange(18), np.arange(18))
        keep = j <= k
        h, t = (1 << j[keep]), (1 << k[keep])
        small = t < 1 << 15  # and the same ratios at totals 3 * 2^k
        h = np.concatenate([h, 3 * h[small]])
        t = np.concatenate([t, 3 * t[small]])
    got = tht.initial_lengths(torch.from_numpy(h.astype(np.int64))[:, None],
                              torch.from_numpy(t.astype(np.int64))[:, None])
    np.testing.assert_array_equal(got[:, 0].numpy(), _jnp_initial(h, t))


# --- encode_literals_device and device_literals_section ----------------------

@pytest.fixture(scope="module", params=["L1_4x64K", "L5_2x128K"])
def encoded(request):
    """(first stage, the reference's dict as numpy, the port's)."""
    stage = first_stage(request.param)
    blocks, lengths, chosen, mlen = stage
    want = jlk.encode_literals_device(
        jnp.asarray(blocks), jnp.asarray(lengths), jnp.asarray(chosen),
        jnp.asarray(mlen), interpret=True)
    got = tlk.encode_literals_device(*(torch.from_numpy(a) for a in stage))
    return (stage, {k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def test_encode_literals_device_equals_reference(encoded):
    _, want, got = encoded
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["ok"].any()


def _section(d: dict, i: int) -> tuple:
    B = len(d["ok"])
    return (d["nb_bits"][i], d["codes"][i], d["max_bits"][i],
            d["last_symbol"][i], int(d["n_lit"][i]),
            d["words"].reshape(B, 4, -1)[i], d["bits"].reshape(B, 4)[i])


def test_device_literals_section_equals_reference(encoded):
    """Byte-equal sections for every ok block; each regenerates the
    block's literals through the format (n_lit bytes in the header)."""
    _, want, got = encoded
    blocks_ok = np.flatnonzero(got["ok"])
    assert len(blocks_ok)
    for i in blocks_ok:
        ref = jlk.device_literals_section(*_section(want, i))
        mine = tlk.device_literals_section(*_section(got, i))
        assert mine == ref and mine is not None, i
        hdr = int.from_bytes(mine[:5], "little")
        assert hdr & 3 == 2  # Compressed_Literals_Block
        sf = (hdr >> 2) & 3
        regen = (hdr >> 4) & ((1 << (10, 10, 14, 18)[sf]) - 1)
        assert regen == int(got["n_lit"][i])


def test_device_literals_section_none_where_the_format_cannot():
    """A stream over 0xFFFF bytes, or sizes past the 18-bit header: None,
    as in the reference."""
    nb = np.zeros(256, np.int32)
    nb[[0, 1]] = 1
    codes = np.array([0, 1] + [0] * 254, np.int32)
    words = np.zeros((4, 20000), np.int32)
    for bits, n_lit in (((0x10000 * 8, 8, 8, 8), 2000),
                        ((8, 8, 8, 8), 1 << 18)):
        args = (nb, codes, 1, 1, n_lit, words, np.array(bits, np.int32))
        assert tlk.device_literals_section(*args) is None
        assert jlk.device_literals_section(*args) is None


def test_small_and_degenerate_blocks_opt_out():
    """Fewer than 1024 literals, one symbol, no literals: ok is False, as
    in the reference."""
    B, N = 4, 4096
    blocks = np.zeros((B, N), np.uint8)
    blocks[0, :1500] = np.arange(1500) % 7      # 1500 literals, 7 symbols
    blocks[1, :900] = np.arange(900) % 5        # 900 literals
    blocks[2, :2000] = 9                        # one symbol
    lengths = np.array([1500, 900, 2000, 0], np.int32)
    chosen = np.zeros((B, N), bool)
    mlen = np.zeros((B, N), np.int32)
    stage = (blocks, lengths, chosen, mlen)
    want = jlk.encode_literals_device(*(jnp.asarray(a) for a in stage),
                                      interpret=True)
    got = tlk.encode_literals_device(*(torch.from_numpy(a) for a in stage))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["ok"].numpy(),
                                  [True, False, False, False])
