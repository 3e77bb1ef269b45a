"""B10's segmented parse (psegs > 1) and the parsed hash branch's knobs,
against the JAX package on the CPU.

parse_greedy(mlen, lazy, psegs) lays each block out as psegs independent
rows and cuts each candidate at its row's end, as the Pallas kernel's
`trunc` branch does (parse_greedy_pallas(psegs > 1), run here in
interpret mode). GpuCodec passes the level table's `lazy` and `psegs` to
the positions pipeline as TpuCodec does, so a level-1 table with the
parsed branch (dense=False) and either knob gives the same frame in both.
Inputs come from a seed with numpy; every value is an integer, so the
tolerance is 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu import oracle
from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.ops import parse_kernel as jpk
from qat_zstd_plugin_tpu.runtime import tpu_codec
from qat_zstd_plugin_tpu_torch import GpuCodec
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp
from qat_zstd_plugin_tpu_torch.ops import parse_kernel as tpk
from qat_zstd_plugin_tpu_torch.runtime import levels

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072


def crafted(B: int, N: int, psegs: int, seed: int) -> np.ndarray:
    """Candidate lengths with matches across every segment end (starting
    1-40 positions before it, longer than what is left), lengths exactly
    reaching the end, strictly longer look-aheads across it, and random
    rows, all rows (B, N) int32."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((B, N)) < 0.4, rng.integers(0, 48, (B, N)), 0)
    m = m.astype(np.int32)
    np_ = N // psegs
    for end in range(np_, N + 1, np_):
        for b in range(0, B, 2):
            k = int(rng.integers(1, 40))
            m[b, end - k] = k + int(rng.integers(1, 30))  # crosses the end
        m[1, end - 6] = 6                                 # reaches it
        m[3, end - 2] = 3                                 # cut below 4
        if end < N:
            m[5, end - 1] = 4                             # look-ahead over it
            m[5, end] = 40
    return m


@pytest.mark.parametrize("psegs", [2, 4, 8])
@pytest.mark.parametrize("lazy", [False, True])
def test_twin_equals_pallas_trunc(psegs, lazy):
    B, N = 6, 8192
    m = crafted(B, N, psegs, seed=psegs + 10 * lazy)
    want = np.asarray(jpk.parse_greedy_pallas(jnp.asarray(m), lazy=lazy,
                                              psegs=psegs, interpret=True))
    got = tpk.parse_greedy(torch.from_numpy(m), lazy, psegs)
    assert got.dtype == torch.bool and got.shape == (B, N)
    np.testing.assert_array_equal(got.numpy(), want)
    # The cut matters: the unsegmented parse differs on these rows.
    assert not np.array_equal(
        tpk.parse_greedy(torch.from_numpy(m), lazy).numpy(), want)


def test_psegs_one_is_the_unsegmented_parse():
    m = crafted(4, 4096, 1, seed=3)
    for lazy in (False, True):
        want = np.asarray(jpk.parse_greedy_pallas(jnp.asarray(m), lazy=lazy,
                                                  interpret=True))
        np.testing.assert_array_equal(
            tpk.parse_greedy(torch.from_numpy(m), lazy, 1).numpy(), want)


@pytest.mark.parametrize("psegs", [0, 3, 5])
def test_psegs_must_divide_the_block(psegs):
    m = torch.zeros((2, 4096), dtype=torch.int32)
    with pytest.raises(ValueError, match="psegs"):
        tpk.parse_greedy(m, False, psegs)


@pytest.mark.parametrize("lazy", [False, True])
def test_parsed_slot_words_at_psegs_4(lazy):
    """find_matches_positions(dense=False, psegs=4): the candidates, LDM
    merged in, B10's segmented parse, B17."""
    B, N = 4, 16384
    rng = np.random.default_rng(7)
    text = make_corpus(B * N, seed=7)
    blocks = np.frombuffer(text, np.uint8).reshape(B, N).copy()
    blocks[2, :2000] = rng.integers(0, 4, 2000, np.uint8)
    lengths = np.array([N, N - 5, N // 2, N], np.int32)
    kw = dict(widths=(5, 8), window=4096, ldm=4, dense=False, lazy=lazy,
              psegs=4)
    want = np.asarray(gk.find_matches_positions(
        jnp.asarray(blocks), jnp.asarray(lengths), interpret=True, **kw))
    got = tmp.find_matches_positions(torch.from_numpy(blocks),
                                     torch.from_numpy(lengths), **kw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("parser", ["scan", "pallas"])
def test_reference_parsers_give_the_port_words(parser):
    """The reference's `parser` has no counterpart in the port: its two
    parsers give the same slot words, which the port's one call (B10)
    gives too."""
    B, N = 2, 8192
    blocks = np.frombuffer(make_corpus(B * N, seed=5), np.uint8) \
        .reshape(B, N).copy()
    lengths = np.array([N, N - 9], np.int32)
    kw = dict(widths=(5, 8), window=4096, dense=False, lazy=True)
    want = np.asarray(gk.find_matches_positions(
        jnp.asarray(blocks), jnp.asarray(lengths), parser=parser,
        interpret=True, **kw))
    got = tk.find_matches_positions(torch.from_numpy(blocks),
                                    torch.from_numpy(lengths), **kw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


# The parsed branch at level 1 (sync implies dense, so sync=False): the
# one-step lazy parse, four parse segments, and both.
TABLES = {"lazy": dict(lazy=True), "psegs4": dict(psegs=4),
          "psegs4_lazy": dict(lazy=True, psegs=4)}


@pytest.mark.parametrize("case", sorted(TABLES))
def test_codec_passes_lazy_and_psegs(case):
    """GpuCodec(level=1) on a dense=False table with lazy or psegs gives
    TpuCodec's frame. Before GpuCodec passed both knobs it parsed
    greedily in one segment and these frames differed."""
    base_t, base_j = levels.TPU_LEVEL_TABLE[1], tpu_codec.TPU_LEVEL_TABLE[1]
    kw = dict(dense=False, sync=False, **TABLES[case])
    data = make_corpus(4 * BLOCK + 5000, seed=11)
    try:
        levels.TPU_LEVEL_TABLE[1] = dataclasses.replace(base_t, **kw)
        tpu_codec.TPU_LEVEL_TABLE[1] = dataclasses.replace(base_j, **kw)
        want = tpu_codec.TpuCodec(level=1, batch=4).compress(data)
        codec = GpuCodec(level=1, batch=4, device="cpu")
        got = codec.compress(data)
        # The same branch without the knob: greedy, one segment.
        levels.TPU_LEVEL_TABLE[1] = dataclasses.replace(
            base_t, dense=False, sync=False)
        plain = GpuCodec(level=1, batch=4, device="cpu").compress(data)
    finally:
        levels.TPU_LEVEL_TABLE[1] = base_t
        tpu_codec.TPU_LEVEL_TABLE[1] = base_j
    assert got == want
    assert oracle.decompress(got, len(data)) == data
    assert codec.device_blocks == 4 and codec.stats.fallback_blocks == 0
    assert got != plain  # the knob reached the device half
