"""Per-block canonical Huffman tables for the device literals, in torch.

Port of qat_zstd_plugin_tpu.ops.huffman_tables.build_tables (XLA glue
there, torch ops here), vectorized over the block batch: byte histograms
-> code lengths (at most 11 bits) from rounded -log2(p), repaired to a
complete Kraft sum by rank-ordered passes -> canonical code values in the
host's valPerRank order, so the host can serialize the weights and any
decoder rebuilds the codes the device used.

Where the reference's formulation needs care:
  * The initial lengths ceil(-log2(hist / total)) are computed in
    integers, as the smallest k with hist << k >= total, so that every
    device gives the same lengths without trusting a float32 log2. Both
    counts are at most 2^17, so a ratio is either an exact power of two or
    at least 2^-17 (relative) away from one, far past any float32 log2
    error: the two agree (tests/test_torch_literals.py sweeps them).
  * Its one-hot permutations (gains moved to rank order, the taken ranks
    moved back) are a scatter by rank and a gather back.
  * Its two while_loops run until no row of the batch changes; a finished
    row is a fixed point of both bodies, so Python loops on .any() give
    the same lengths.
"""

from __future__ import annotations

import torch

from .fse_tables import _rank_desc

MAX_BITS = 11
UNIT = 1 << MAX_BITS
_LOW = -(1 << 30)  # rank key of a symbol that cannot change


def initial_lengths(hist: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """(B, K) counts and (B, 1) totals -> clip(ceil(-log2(hist / total)),
    1, MAX_BITS) where hist > 0, else 0: the smallest k with hist << k >=
    total is the number of k in 0..MAX_BITS-1 with hist << k < total."""
    k = torch.arange(MAX_BITS, device=hist.device)
    l0 = ((hist[:, :, None] << k) < total[:, :, None]).sum(2)
    return torch.where(hist > 0, l0.clamp(min=1), 0)


def _kraft(ln: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    return torch.where(present, UNIT >> ln.clamp(0, MAX_BITS), 0).sum(1)


def _by_rank(gain: torch.Tensor, key: torch.Tensor):
    """(rank order, gains in rank order): rank by descending key, ties by
    index, as the reference's _rank_desc."""
    order = _rank_desc(key)
    return order, torch.zeros_like(gain).scatter_(1, order, gain)


def build_tables(hist: torch.Tensor) -> dict:
    """hist: (B, 256) integer counts -> dict of
      nb_bits (B, 256) int32: code length per symbol (0 = absent)
      codes   (B, 256) int32: canonical code values
      max_bits, last_symbol (B,) int32
      ok (B,) bool: at least 2 present symbols (else the caller keeps raw
        or RLE literals)
    """
    hist = hist.to(torch.int64)
    B, K = hist.shape
    dev = hist.device
    present = hist > 0
    ok = present.sum(1) >= 2
    lengths = initial_lengths(hist, hist.sum(1, keepdim=True).clamp(min=1))

    # Over-subscribed: in ascending-count rank order, lengthen the prefix
    # whose cumulative gain covers the excess; repeat until no row is over.
    while bool((_kraft(lengths, present) > UNIT).any()):
        excess = _kraft(lengths, present) - UNIT
        can = present & (lengths < MAX_BITS)
        gain = torch.where(can, UNIT >> (lengths + 1), 0)
        order, g = _by_rank(gain, torch.where(can, -hist, _LOW))
        cum_excl = g.cumsum(1) - g
        take = ((cum_excl < excess[:, None]) & (g > 0)).gather(1, order)
        lengths = torch.where(take, lengths + 1, lengths)

    # Under-subscribed: in descending-count rank order, shorten the prefix
    # that fits the gap, or else the first symbol that fits; repeat while
    # a row has a gap and a symbol that fits it.
    def fixable() -> bool:
        gap = UNIT - _kraft(lengths, present)
        can_gain = torch.where(present & (lengths > 1), UNIT >> lengths, 0)
        fits = (can_gain <= gap[:, None]) & (can_gain > 0)
        return bool(((gap > 0) & fits.any(1)).any())

    while fixable():
        gap = (UNIT - _kraft(lengths, present))[:, None]
        can = present & (lengths > 1)
        gain = torch.where(can, UNIT >> lengths, 0)
        order, g = _by_rank(gain, torch.where(can, hist, _LOW))
        take = (g.cumsum(1) <= gap) & (g > 0)
        fit = (g <= gap) & (g > 0)
        first_fit = (fit.cumsum(1) == 1) & fit
        take = torch.where(take.any(1, keepdim=True), take, first_fit)
        lengths = torch.where(take.gather(1, order), lengths - 1, lengths)

    max_bits = lengths.max(1).values
    sym = torch.arange(K, device=dev)
    last_symbol = torch.where(present, sym, -1).max(1).values

    # Canonical codes: valPerRank from MAX_BITS down to 1 (ranks above
    # max_bits hold no symbol, so starting there adds nothing), then codes
    # ascend by symbol within a length.
    onehot = (lengths[:, :, None] == torch.arange(MAX_BITS + 1, device=dev)) \
        & present[:, :, None]                            # (B, K, 12)
    nb_per_rank = onehot.sum(1)                          # by length 0..11
    val_per_rank = torch.zeros((B, MAX_BITS + 1), dtype=torch.int64,
                               device=dev)
    mn = torch.zeros(B, dtype=torch.int64, device=dev)
    for n in range(MAX_BITS, 0, -1):
        val_per_rank[:, n] = mn
        mn = (mn + nb_per_rank[:, n]) >> 1
    ahead = onehot.to(torch.int64).cumsum(1) - onehot.to(torch.int64)
    rank_in_len = ahead.gather(2, lengths[:, :, None])[:, :, 0]
    base = val_per_rank.gather(1, lengths)
    codes = torch.where(present, base + rank_in_len, 0)
    return {"nb_bits": lengths.to(torch.int32),
            "codes": codes.to(torch.int32),
            "max_bits": max_bits.to(torch.int32),
            "last_symbol": last_symbol.to(torch.int32), "ok": ok}
