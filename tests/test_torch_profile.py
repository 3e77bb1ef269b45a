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


def test_port_kernels_split_by_name_per_batch():
    """Only the kernels defined under csrc/ count, not PyTorch's (some
    of which sit in anonymous namespaces too), by name without their
    arguments, in ms and launches a batch."""
    evs = [_ev("void (anonymous namespace)::fse_maps_kernel(FseArgs, int)",
               0, 300),
           _ev("void (anonymous namespace)::sort_global_kernel<4>(unsigned "
               "int*, int)", 300, 400),
           _ev("void at::native::vectorized_elementwise_kernel<4>()", 0, 9),
           _ev("void at::native::(anonymous namespace)::where_kernel_impl("
               "at::TensorIterator&)::{lambda()#1}", 0, 7),
           _ev("void (anonymous namespace)::elementwise_kernel_with_index<"
               "int>(int)", 0, 5),
           _ev("(anonymous namespace)::fse_maps_kernel(FseArgs, int)",
               400, 500),
           _ev("void (anonymous namespace)::finalize_tile_kernel<(anonymous "
               "namespace)::VerifiedPass>((anonymous namespace)::"
               "VerifiedPass, unsigned char const*)", 0, 20)]
    kernels = profile_l1.csrc_kernels()
    assert {"fse_maps_kernel", "fse_chain_kernel", "fse_emit_kernel",
            "sort_cluster_kernel", "sort_global_kernel",
            "gather_payloads_kernel", "tile_first_change_kernel",
            "finalize_tile_kernel"} <= kernels
    assert "elementwise_kernel_with_index" not in kernels
    assert profile_l1._port_kernels(evs, 2, kernels) == {
        "fse_maps_kernel": {"ms": 0.2, "launches": 1.0},
        "sort_global_kernel<4>": {"ms": 0.05, "launches": 0.5},
        "finalize_tile_kernel<VerifiedPass>": {"ms": 0.01, "launches": 0.5}}


def test_elementwise_counts_pytorch_elementwise_kernels():
    """The XOR passes around the row sorts are PyTorch elementwise
    kernels; the sorts and the port's kernels are not."""
    evs = [_ev("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::BitwiseXorFunctor<int>>()", 0, 1),
           _ev("void at::native::unrolled_elementwise_kernel<>()", 1, 2),
           _ev("void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<>"
               "()", 2, 5),
           _ev("void (anonymous namespace)::neighbor_unsort_keys_kernel<"
               "true>(unsigned int const*)", 5, 6)]
    assert profile_l1._elementwise(evs) == 2


def test_span_totals_a_call():
    """profile_l1's spans line: count, wall and CPU seconds a call by
    name, and the host half's routes a call."""
    def sp(name, ms, cpu_ms, **attrs):
        return SimpleNamespace(name=name, start_ns=0, end_ns=ms * 10**6,
                               cpu_ns=cpu_ms * 10**6, attrs=attrs)
    spans = [sp("collect.unpack", 200, 180), sp("collect.unpack", 100, 90),
             sp("block.host", 30, 10, route="extend"),
             sp("block.host", 10, 10, route="host_match")]
    got = profile_l1.span_totals(spans, calls=2)
    assert got["by_span"]["collect.unpack"] == pytest.approx(
        {"n": 1.0, "wall_s": 0.15, "cpu_s": 0.135})
    assert got["by_span"]["block.host"] == pytest.approx(
        {"n": 1.0, "wall_s": 0.02, "cpu_s": 0.01})
    assert got["routes"] == {"extend": 0.5, "host_match": 0.5}
