"""B19: the bitonic row sort in PyTorch.

Port of qat_zstd_plugin_tpu.ops.sort_kernel.bitonic_sort (Pallas). It sorts
(B, N) int32 rows ascending by (key read as unsigned, pos as signed int32),
carrying any number of int32 payload rows, for N a power of two >= 1024.
The CUDA kernel is in csrc/sort_kernels.cu; `bitonic_sort` launches it for
CUDA tensors (counted in glue_kernels.launches["bitonic_sort"]) and runs
`bitonic_sort_twin` for CPU tensors.

A bitonic network is not stable: where a row holds equal (key, pos) pairs,
their payloads come out in the network's own order, which a stable sort
(torch.sort, numpy's lexsort) does not give. So the twin runs the
reference's network stage by stage, and the kernel runs the same network
on (key, pos, original column) and gathers the payloads by the column.
"""

from __future__ import annotations

import ctypes

import torch

from .glue_kernels import _SIGN, _check, _launch, _use_twin


def _check_rows(key: torch.Tensor, pos: torch.Tensor, payload) -> None:
    for t in (key, pos, *payload):
        _check(t, "bitonic_sort", torch.int32, 2)
        if t.shape != key.shape or t.device != key.device:
            raise ValueError(f"bitonic_sort: arrays {tuple(t.shape)} on "
                             f"{t.device} and {tuple(key.shape)} on "
                             f"{key.device} differ")
    n = key.shape[1]
    if n < 1024 or n & (n - 1):
        raise ValueError(f"bitonic_sort: row length {n} must be a power of "
                         "two >= 1024")


def bitonic_sort_twin(key: torch.Tensor, pos: torch.Tensor, *payload):
    """Plain-torch B19 (see bitonic_sort): the reference's network, one
    gather of every array by the partner column i ^ j and one select a
    stage. Order word: the key as unsigned, then pos as signed, in one
    int64."""
    _check_rows(key, pos, payload)
    n = key.shape[1]
    arrs = torch.stack((key, pos) + payload)
    i = torch.arange(n, device=key.device)
    k = 2
    while k <= n:
        j = k >> 1
        while j >= 1:
            part = arrs[:, :, i ^ j]
            word = ((arrs[0].to(torch.int64) ^ _SIGN) << 32) \
                | (arrs[1].to(torch.int64) - _SIGN)
            pword = ((part[0].to(torch.int64) ^ _SIGN) << 32) \
                | (part[1].to(torch.int64) - _SIGN)
            # The element that should hold the larger word of its pair:
            # the upper one in an ascending run, the lower in a descending.
            want_high = ((i & j) != 0) ^ ((i & k) != 0)
            swap = torch.where(want_high, word < pword, word > pword)
            arrs = torch.where(swap, part, arrs)
            j >>= 1
        k <<= 1
    return tuple(arrs.unbind(0))


def bitonic_sort(key: torch.Tensor, pos: torch.Tensor, *payload):
    """B19. (B, N) int32 key, pos and payload rows -> the same rows sorted
    ascending by (key as unsigned, pos as signed), each payload moved with
    its (key, pos); N a power of two >= 1024. Equal (key, pos) pairs keep
    the network's order, not a stable sort's."""
    _check_rows(key, pos, payload)
    if _use_twin(key, "bitonic_sort"):
        return bitonic_sort_twin(key, pos, *payload)
    B, n = key.shape
    key_out, pos_out, idx = (torch.empty_like(key) for _ in range(3))
    outs = [torch.empty_like(p) for p in payload]
    srcs = (ctypes.c_void_p * len(payload))(*[p.data_ptr() for p in payload])
    dsts = (ctypes.c_void_p * len(payload))(*[o.data_ptr() for o in outs])
    _launch("bitonic_sort", key, pos, key_out, pos_out, idx,
            srcs if payload else None, dsts if payload else None,
            len(payload), B, n)
    return (key_out, pos_out, *outs)
