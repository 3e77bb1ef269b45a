"""The hash matcher's packed-sequences contract against the JAX package,
on the CPU: the reference's candidates_hash and candidates_hash_glue
against the port's one candidates_hash_split (B5, K2, B7), its
compact_fast against compact_fast_glue (B18 and the row sorts, the
segment merge), and its find_matches_hash_split, find_matches_fused and
find_matches_packed (matcher "content", "hash" and "hash_glue") against
the port's find_matches_hash_split and find_matches_packed (matcher
"content" and "hash").

The reference's `parser` ("scan" and "pallas" give the same chosen
positions) and its second hash matcher name "hash_glue" have no
counterpart in the port, which parses with B10 alone: the JAX function
takes them here, and the port's call takes none.

The shapes are tests/test_glue_kernels.py's. The same numpy bytes go to
the JAX function (XLA sorts, or Pallas in interpret mode) and to the
port's, which on CPU tensors runs the kernels' plain-torch twins. Every
output is integers, so the tolerance is 0.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops import match_pipeline as jmp
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp

torch.set_num_threads(2)  # six test workers share a few cores

SURVEY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "SURVEY.md")


@functools.lru_cache
def text() -> bytes:
    return open(SURVEY, "rb").read() * 12


def blocks_of(B: int, N: int, seed: int):
    """test_glue_kernels.py's rows: SURVEY.md, block 1 with a run of a
    4-letter alphabet and a byte run, the last block ragged."""
    rng = np.random.default_rng(seed)
    buf = np.frombuffer(text()[:B * N], np.uint8).reshape(B, N).copy()
    if B > 1:
        buf[1, :N // 4] = rng.integers(0, 4, N // 4, np.uint8)
        buf[1, 1000:2000] = 9
    lengths = np.full(B, N, np.int32)
    lengths[-1] = N - 57
    return buf, lengths


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def equal(got, want, what: str = "") -> None:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), what)


CANDIDATES = {  # B, N, widths, neighbors
    "4x65536_w58": (4, 65536, (5, 8), 1),
    "1x131072_w6": (1, 131072, (6,), 1),
    "2x32768_w458": (2, 32768, (4, 5, 8), 1),
    "3x65536_w58": (3, 65536, (5, 8), 1),
    "2x65536_w48_n2": (2, 65536, (4, 8), 2),  # candidates_hash's defaults
}


@pytest.mark.parametrize("case", sorted(CANDIDATES))
def test_candidates_hash(case):
    B, N, widths, neighbors = CANDIDATES[case]
    buf, lengths = blocks_of(B, N, B)
    w = min(32768, N)
    want = jmp.candidates_hash(jnp.asarray(buf), jnp.asarray(lengths),
                               widths=widths, neighbors=neighbors, window=w)
    got = tk.candidates_hash_split(t(buf), t(lengths), widths=widths,
                                   neighbors=neighbors, window=w)
    equal(got[0], want[0], "mlen")
    equal(got[1], want[1], "moff")


def test_candidates_hash_glue_interpret():
    buf, lengths = blocks_of(2, 32768, 5)
    want = gk.candidates_hash_glue(jnp.asarray(buf), jnp.asarray(lengths),
                                   widths=(5, 8), neighbors=1, window=8192,
                                   interpret=True)
    got = tk.candidates_hash_split(t(buf), t(lengths), widths=(5, 8),
                                   neighbors=1, window=8192)
    equal(got[0], want[0], "mlen")
    equal(got[1], want[1], "moff")


@functools.lru_cache
def parsed(B: int, N: int):
    """test_compact_glue_matches_xla's input: the JAX candidates and
    parse on SURVEY.md, as numpy."""
    buf = np.frombuffer(text()[:B * N], np.uint8).reshape(B, N)
    lengths = np.full(B, N, np.int32)
    m, o = jmp.candidates_hash(jnp.asarray(buf), jnp.asarray(lengths),
                               widths=(5, 8), neighbors=1, window=32768)
    chosen = jmp.parse_greedy_scan(m)
    return tuple(np.asarray(x) for x in (chosen, m, o, lengths))


COMPACT = {  # B, N, max_seq, window
    "4x65536": (4, 65536, 16384, 32768),
    "2x131072": (2, 131072, 16384, 32768),
    "2x131072_overflow": (2, 131072, 1000, 32768),  # nseq > max_seq
    "4x65536_max_seq_above_n": (4, 65536, 70000, 32768),  # padded
}


@pytest.mark.parametrize("case", sorted(COMPACT))
def test_compact_fast(case):
    B, N, max_seq, window = COMPACT[case]
    chosen, m, o, lengths = parsed(B, N)
    want = jmp.compact_fast(jnp.asarray(chosen), jnp.asarray(m),
                            jnp.asarray(o), jnp.asarray(lengths), max_seq,
                            window)
    got = tk.compact_fast_glue(t(chosen), t(m), t(o), t(lengths), max_seq,
                               window)
    assert sorted(got) == sorted(want)
    for k in want:
        equal(got[k], want[k], k)
    if "overflow" in case:
        assert np.asarray(want["overflow"]).any()


def test_compact_fast_single_segment():
    """window >= N: one segment a block, no merge."""
    chosen, m, o, lengths = parsed(4, 65536)
    c, mm, oo = (x[:, :32768] for x in (chosen, m, o))
    ln = np.minimum(lengths, 32768).astype(np.int32)
    want = jmp.compact_fast(jnp.asarray(c), jnp.asarray(mm), jnp.asarray(oo),
                            jnp.asarray(ln), 4096, 32768)
    got = tk.compact_fast_glue(t(c), t(mm), t(oo), t(ln), 4096, 32768)
    for k in want:
        equal(got[k], want[k], k)


def test_hash_split_and_fused():
    """test_split_pipeline_matches_fused's case: the port's
    find_matches_hash_split and find_matches_packed(matcher="hash")
    against the reference's fused hash path (XLA) and its split glue path
    (interpret mode)."""
    B, N = 2, 131072
    buf = np.frombuffer(text()[:B * N], np.uint8).reshape(B, N)
    lengths = np.full(B, N, np.int32)
    kw = dict(neighbors=1, max_seq=4096, window=32768)
    want = np.asarray(jmp.find_matches_fused(
        jnp.asarray(buf), jnp.asarray(lengths), matcher="hash",
        widths=(5, 8), parser="scan", **kw))
    want_split = np.asarray(gk.find_matches_hash_split(
        jnp.asarray(buf), jnp.asarray(lengths), widths=(5, 8),
        interpret=True, parser="pallas", **kw))
    equal(want_split, want)
    got = tmp.find_matches_packed(t(buf), t(lengths), matcher="hash",
                                  widths=(5, 8), **kw)
    equal(got, want)
    got = tk.find_matches_hash_split(t(buf), t(lengths), widths=(5, 8), **kw)
    equal(got, want)


MATCHERS = {  # matcher, B, N, widths, window, ldm, lazy
    "content_ldm": ("content", 4, 16384, (4, 8), 1 << 30, 4, True),
    "content": ("content", 3, 16384, (4, 8), 1 << 30, 4, False),
    "hash": ("hash", 4, 65536, (5, 8), 32768, 0, False),
    "hash_glue_lazy": ("hash_glue", 2, 65536, (6,), 16384, 0, True),
}


@pytest.mark.parametrize("case", sorted(MATCHERS))
def test_find_matches_packed_matchers(case):
    """find_matches_packed(matcher=...) on the JAX package's default CPU
    route (fused for "hash", staged for "content") and the port's; the
    reference's "hash_glue" is the port's "hash"."""
    matcher, B, N, widths, window, ldm, lazy = MATCHERS[case]
    buf, lengths = blocks_of(B, N, B + 1)
    kw = dict(neighbors=2 if matcher != "content" else 4, max_seq=8192,
              lazy=lazy, window=window, widths=widths, ldm=ldm)
    want = np.asarray(jmp.find_matches_packed(
        jnp.asarray(buf), jnp.asarray(lengths), parser="scan",
        matcher=matcher, **kw))
    got = tmp.find_matches_packed(
        t(buf), t(lengths), matcher="content" if matcher == "content"
        else "hash", **kw)
    equal(got, want, matcher)
    unpacked = tmp.unpack_outputs(want)
    assert unpacked["nseq"].sum() > 0


@pytest.mark.parametrize("matcher", ["lz4", "hash_glue"])
def test_refusals(matcher):
    """A matcher the port does not have is refused by name: "hash_glue"
    is the reference's second name for "hash" and is not kept."""
    x = torch.zeros((1, 32768), dtype=torch.uint8)
    n = torch.full((1,), 32768, dtype=torch.int32)
    with pytest.raises(ValueError, match="matcher"):
        tmp.find_matches_packed(x, n, matcher=matcher)
