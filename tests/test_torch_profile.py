"""The profiler's interval arithmetic, on made-up device events."""

from types import SimpleNamespace

import pytest
import torch

from qat_zstd_plugin_tpu_torch import profile_l1

torch.set_num_threads(2)  # six test workers share a few cores


def _ev(name, start, end):
    tr = SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, time_range=tr)


@pytest.mark.parametrize("spans, busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),
    ([(0, 10), (5, 12), (11, 13)], 13.0),  # overlaps counted once
    ([(5, 12), (0, 20)], 20.0),  # nested
])
def test_busy_is_the_union_of_intervals(spans, busy):
    assert profile_l1._busy_us([_ev("k", s, e) for s, e in spans]) == busy


def test_top_ops_sums_by_name_and_shares():
    ops = profile_l1._top_ops([_ev("sort", 0, 6), _ev("k1", 6, 8),
                               _ev("sort", 8, 10)], n=1)
    assert ops == [{"op": "sort", "ms": 0.008, "share": 0.8}]
