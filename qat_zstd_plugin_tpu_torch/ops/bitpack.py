"""Variable-length bit packing on the device, and the host-side closing of
a packed backward bitstream.

Port of qat_zstd_plugin_tpu.ops.bitpack. `bitpack` packs per-item
(value, nbits) pairs into LSB-first u32 words. The reference recasts the
scatter as sorts and scans (the TPU's scatter is slow); the items' bit
ranges are disjoint, so here each item's offset is an exclusive cumsum
of nbits and its shifted value (at most 96 bits, three words) is added
into its words with `scatter_add_`. Sums are taken modulo 2^32, as the
reference's int32 prefix-sum differences are, so the words are equal on
every input, values with bits above nbits included. The device-entropy
paths pack with ops/bitconcat.py instead (as the reference's do); this is
XLA glue there, not a Pallas kernel, and torch ops here.
`backward_stream_bytes` is a copy of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def bitpack(lo: torch.Tensor, hi: torch.Tensor, nbits: torch.Tensor,
            max_words: int):
    """Pack per-item bitfields into LSB-first u32 word streams.

    lo, hi: (B, S) int32, the low and high words of each item's value
    (masked to nbits; item order is write order). nbits: (B, S) int32 in
    [0, 64], 0 = skip. Returns (words (B, max_words) int32, total_bits (B,)
    int32, overflow (B,) bool): a row whose bits pass max_words * 32 keeps
    the words its items' first max_words words hold and sets overflow."""
    B, S = lo.shape
    W = max_words
    dev = lo.device
    nb = nbits.to(torch.int64)
    csum = nb.cumsum(1)
    boff = csum - nb  # exclusive scan
    total = csum[:, -1] if S else torch.zeros(B, dtype=torch.int64,
                                                device=dev)
    w0 = boff >> 5
    sh = boff & 31
    inv = (32 - sh) & 31
    nz = sh > 0
    lo_u = lo.to(torch.int64) & _M32
    hi_u = hi.to(torch.int64) & _M32
    skip = nb == 0
    # The 96-bit spread of the shifted value: c0 -> word w0, c1 -> w0 + 1,
    # c2 -> w0 + 2.
    c0 = (lo_u << sh) & _M32
    c1 = torch.where(nz, lo_u >> inv, 0) | ((hi_u << sh) & _M32)
    c2 = torch.where(nz, hi_u >> inv, 0)
    acc = torch.zeros((B, W + 1), dtype=torch.int64, device=dev)
    for r, c in enumerate((c0, c1, c2)):
        at = w0 + r
        acc.scatter_add_(1, torch.where(at < W, at, W),
                         torch.where(skip, 0, c))
    words = acc[:, :W] & _M32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    total_bits = total.to(torch.int32)
    return words.to(torch.int32), total_bits, total_bits > W * 32


def backward_stream_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """One block's packed little-endian u32 words -> the closed backward
    stream bytes (the sentinel '1' bit, then zero padding to a byte); the
    words hold every item up to, not including, the sentinel."""
    nbytes_full = (total_bits + 7) // 8
    raw = np.ascontiguousarray(words).view(np.uint8)[:nbytes_full + 1]
    out = bytearray(raw[:nbytes_full])
    used = total_bits & 7
    if used == 0:
        out.append(1)
    else:
        out[-1] |= 1 << used
    return bytes(out)
