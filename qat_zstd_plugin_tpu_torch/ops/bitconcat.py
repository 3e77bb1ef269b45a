"""Variable-length bit packing as a log-depth balanced reduction, in torch.

Port of qat_zstd_plugin_tpu.ops.bitconcat (XLA glue there, not a Pallas
kernel, so torch ops here). Bitstring concatenation is associative, so
packing per-item (value, nbits) fields into one LSB-first stream is a
balanced binary reduction: level k holds groups of 2^k items, each a
bitstring in little-endian u32 words plus a bit count, and two
neighbours combine as

    out = A | (B shifted up by nbits_A bits)

with zeros past each group's bit length, so OR adds. The reference does
the per-group word shift with log2(F) conditional power-of-two rolls;
here it is one gather per level (word f of the shifted group is word
f - base of B, zero below base), which gives the same words, those of
overflowing streams included.

Words are carried in int64 tensors holding u32 values: torch on the CPU
has no uint32 shifts, and an int32 shift that overflows is not a result
to rely on.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _combine(words: torch.Tensor, nbits: torch.Tensor, fout: int):
    """One doubling step: (R, G, F) words + (R, G) bit counts ->
    (R, G/2, fout) + (R, G/2)."""
    R, G, F = words.shape
    a = words[:, 0::2, :]
    b = words[:, 1::2, :]
    nb_a = nbits[:, 0::2]
    nb_b = nbits[:, 1::2]
    if fout > F:
        pad = (0, fout - F)
        a = torch.nn.functional.pad(a, pad)
        b = torch.nn.functional.pad(b, pad)
    elif fout < F:
        a = a[:, :, :fout]
        b = b[:, :, :fout]
    # Word shift by nb_a >> 5 (zero fill), then bit shift by nb_a & 31.
    # The reference's rolls of 1, 2, 4, ... < fout words read only the low
    # (fout - 1).bit_length() bits of the word shift; a shift past the
    # group (a truncated stream, which reports overflow) wraps there and
    # here alike.
    base = (nb_a >> 5) & ((1 << (fout - 1).bit_length()) - 1)
    src = (torch.arange(fout, device=words.device)[None, None, :]
           - base[:, :, None])
    shifted = torch.where(src >= 0, b.gather(2, src.clamp(min=0)), 0)
    sh = (nb_a & 31)[:, :, None]
    lo = (shifted << sh) & _M32
    hi = torch.zeros_like(shifted)
    hi[:, :, 1:] = shifted[:, :, :-1] >> (32 - sh)  # sh == 0 shifts out
    return a | lo | hi, nb_a + nb_b


def bitconcat(lo: torch.Tensor, hi: torch.Tensor, nbits: torch.Tensor,
              max_words: int, max_item_bits: int = 64):
    """Pack per-item bitfields into LSB-first u32 word streams.

    lo/hi (R, S) int32 value words (the value masked to nbits; item order
    is write order), nbits (R, S) int32 in [0, 64] (0 = skip, value 0).
    Returns (words (R, max_words) int32 bit patterns, total_bits (R,)
    int32, overflow (R,) bool). max_item_bits bounds any one item's
    nbits and sizes the early levels' word budgets. Item counts are
    padded to a power of two; groups whose capacity passes max_words + 2
    words are truncated, which can only cut streams longer than
    max_words, and those report overflow."""
    R, S = lo.shape
    S2 = 1 << max(1, (S - 1).bit_length())
    if S2 != S:
        pad = (0, S2 - S)
        lo = torch.nn.functional.pad(lo, pad)
        hi = torch.nn.functional.pad(hi, pad)
        nbits = torch.nn.functional.pad(nbits, pad)
    nb = nbits.to(torch.int64)
    if max_item_bits <= 32:
        words = (lo.to(torch.int64) & _M32)[:, :, None]
    else:
        words = torch.stack([lo.to(torch.int64) & _M32,
                             hi.to(torch.int64) & _M32], dim=2)
    level = 0
    while words.shape[1] > 1:
        level += 1
        need = min(((1 << level) * max_item_bits + 31) // 32 + 1,
                   max_words + 2)
        words, nb = _combine(words, nb, need)
    total_bits = nb[:, 0]
    overflow = total_bits > max_words * 32
    out = words[:, 0, :]
    if out.shape[1] < max_words:
        out = torch.nn.functional.pad(out, (0, max_words - out.shape[1]))
    out = out[:, :max_words]
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(torch.int32), total_bits.to(torch.int32), overflow
