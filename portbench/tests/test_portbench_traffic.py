"""The traffic generator: what a seed makes, and what it must not
change."""

import numpy as np
import pytest

from conftest import small_cell

BIG_SEED = 2 ** 31 + 987654321


def test_corpus_repeats_for_a_seed():
    from portbench.corpus import make_corpus
    from portbench.traffic import rng_for
    a = make_corpus(500_000, rng_for(7, "x"))
    b = make_corpus(500_000, rng_for(7, "x"))
    c = make_corpus(500_000, rng_for(8, "x"))
    assert len(a) == 500_000 and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # The long-distance copy at the end, as in the program's corpus.
    assert np.array_equal(a[-60_000:], a[-360_000:-300_000])


@pytest.mark.parametrize("seed", [0, 1, BIG_SEED, -5])
def test_size_mix_repeats(seed):
    from portbench.traffic import make_inputs
    cell = small_cell("l9hyb.objects")
    a = make_inputs(cell.traffic, seed)
    b = make_inputs(cell.traffic, seed)
    assert len(a.objects) == cell.traffic["requests"] and a.workers == 2
    assert all(np.array_equal(x, y) for x, y in zip(a.objects, b.objects))


def test_seeds_share_sizes():
    """Seeds rotate one order of one set of sizes; they never change it,
    and every run of STRATA requests holds one size of each band."""
    from portbench.traffic import STRATA, make_inputs
    cell = small_cell("l9hyb.objects")
    runs = [[len(o) for o in make_inputs(cell.traffic, s).objects]
            for s in (3, 4, BIG_SEED)]
    assert sorted(runs[0]) == sorted(runs[1]) == sorted(runs[2])
    assert runs[0] != runs[1]
    n = len(runs[0])
    band = {s: r * STRATA // n for r, s in enumerate(sorted(runs[0]))}
    for order in runs:
        for g in range(0, n, STRATA):
            assert sorted(band[s] for s in order[g:g + STRATA]) == \
                list(range(STRATA))


def test_banded_order_is_a_permutation():
    from portbench.traffic import STRATA, banded_order, rng_for
    p = banded_order(STRATA * 5, rng_for(1, "t"))
    assert sorted(p) == list(range(STRATA * 5))
    for g in range(0, len(p), STRATA):
        assert sorted(p[g:g + STRATA] // 5) == list(range(STRATA))


def test_size_mix_shape():
    """warp's --obj.randsize at 10 MiB: log-uniform over 40 KiB-10 MiB,
    median 640 KiB, mean about 0.18 of the largest."""
    from portbench.traffic import sizes
    s = sizes({"size_min": 40960, "size_max": 10485760}, 2048)
    assert s.min() >= 40960 and s.max() <= 10485760
    assert 600_000 < np.median(s) < 700_000
    assert 0.17 < s.mean() / 10485760 < 0.19
    assert 0.18 < (s < 131072).mean() < 0.24  # about a fifth under a block


def test_fixed_size_inputs():
    from portbench.traffic import make_inputs
    cell = small_cell("l1.bulk")
    a = make_inputs(cell.traffic, BIG_SEED)
    assert a.workers == 1
    assert [len(o) for o in a.objects] == [600_000, 600_000]
    assert not np.array_equal(a.objects[0], a.objects[1])
