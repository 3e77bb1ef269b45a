"""B19: the bitonic row sort in PyTorch.

Port of qat_zstd_plugin_tpu.ops.sort_kernel.bitonic_sort (Pallas). It sorts
(B, N) int32 rows ascending by (key read as unsigned, pos as signed int32),
carrying any number of int32 payload rows, for N a power of two >= 1024.
The CUDA kernels are in csrc/sort_kernels.cu; `bitonic_sort` plans their
launches (`sort_plan`) and makes them for CUDA tensors (counted once a
call in glue_kernels.launches["bitonic_sort"]) and runs
`bitonic_sort_twin` for CPU tensors.

A bitonic network is not stable: where a row holds equal (key, pos) pairs,
their payloads come out in the network's own order, which a stable sort
(torch.sort, numpy's lexsort) does not give. So the twin runs the
reference's network stage by stage, and the kernel runs the same network
on (key, pos, original column) and gathers the payloads by the column (a
single payload rides through the network in the column's place).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .glue_kernels import _SIGN, _check, _launch, _use_twin

# The geometry sort_plan cuts the network by: csrc/sort_kernels.cu's
# kCtaLog, kSpanLog and kGroupBits. The entry point checks every plan
# against its own and refuses one that would pair columns no thread, CTA
# or cluster of it holds, or that misses or repeats a stage.
CTA_ELEMS = 16384  # columns one CTA holds in shared memory
SPAN = 131072      # columns one cluster (8 CTAs) holds
GROUP_BITS = 4     # a register group: 16 columns a thread, 4 stages
_OP_CROSS, _OP_REGS = 0, 1
_KINDS = {"cluster": 0, "global": 1, "cta": 2}


def _cluster_steps(k: int, j_hi: int, cta: int) -> list:
    """The steps of one cluster launch that run stages (k, j) for j from
    j_hi down to 1: a cross-CTA step ("cross", k, j) for each j >= cta,
    then register groups ("regs", k, j, r), each the r <= 4 stages j, j/2,
    ... whose partner bits lie in one thread's 16 columns."""
    steps = []
    j = j_hi
    while j >= cta:
        steps.append(("cross", k, j))
        j >>= 1
    while j >= 1:
        r = min(GROUP_BITS, j.bit_length())
        steps.append(("regs", k, j, r))
        j >>= r
    return steps


def sort_plan(n: int) -> list:
    """The kernel launches of a row sort of length n, in order: each
    ("cta", steps), ("cluster", steps) or ("global", steps). The first
    launch sorts every CTA's min(n, CTA_ELEMS) columns (all k up to it) in
    CTAs of their own; a cluster launch then runs every stage of k up to a
    span of min(n, SPAN) columns; for each k above a span, the stages j >=
    SPAN run as device-memory passes of up to 4 stages each, then one
    cluster launch runs that k's stages j < SPAN."""
    cta, span = min(n, CTA_ELEMS), min(n, SPAN)
    steps = []
    k = 2
    while k <= cta:
        steps += _cluster_steps(k, k >> 1, cta)
        k <<= 1
    plan = [("cta", steps)]
    steps = []
    while k <= span:
        steps += _cluster_steps(k, k >> 1, cta)
        k <<= 1
    if steps:
        plan.append(("cluster", steps))
    while k <= n:
        j = k >> 1
        while j >= span:
            r = min(GROUP_BITS, j.bit_length() - span.bit_length() + 1)
            plan.append(("global", [("regs", k, j, r)]))
            j >>= r
        plan.append(("cluster", _cluster_steps(k, span >> 1, cta)))
        k <<= 1
    return plan


@functools.lru_cache(maxsize=None)
def _plan_array(n: int):
    """sort_plan(n) as the C int array the entry point reads (built once
    for each row length)."""
    words = _plan_words(sort_plan(n))
    return (ctypes.c_int * len(words))(*words)


def _plan_words(plan: list) -> list[int]:
    """The plan as csrc/sort_kernels.cu reads it: per launch [kind, nsteps,
    step words...], a step word op | log2 k << 2 | log2 j << 8 | r << 14."""
    words = []
    for kind, steps in plan:
        words += [_KINDS[kind], len(steps)]
        for op, k, j, *r in steps:
            words.append((_OP_CROSS if op == "cross" else _OP_REGS)
                         | (k.bit_length() - 1) << 2
                         | (j.bit_length() - 1) << 8 | (r[0] if r else 1) << 14)
    return words


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
    plan = _plan_array(n)
    _launch("bitonic_sort", key, pos, key_out, pos_out, idx,
            srcs if payload else None, dsts if payload else None,
            len(payload), B, n, plan, len(plan))
    return (key_out, pos_out, *outs)
