"""Per-block FSE encode tables for the device sequence sections, in torch.

Port of qat_zstd_plugin_tpu.ops.fse_tables (XLA glue there, torch ops
here). For each block of the batch it histograms the LL, OF and ML code
streams, normalizes each to 2^al (the predefined accuracy logs: LL 6,
OF 5, ML 6, so table geometry never changes), builds the encode tables,
and picks per stream and block the custom or the predefined table by
estimated cost. The host writes the table descriptions (write_ncount)
from the normalized counts returned here.

Normalization gives every present symbol >= 1 slot (no -1 entries), so
the spread position of the k-th walk entry is (k * step) mod size and its
inverse a multiplication by step^-1: no scatter is needed.

The cost estimate compares sums of float32 terms hist * (al - log2(c)).
The reference sums them in float32 in XLA's reduction order, which is
neither torch's on the CPU nor on the card; here each term is formed in
float32 as there, from the same log2 table (_LOG2, JAX's float32 values
bit for bit), and the terms are summed in float64, where a sum of these
terms is exact, so the choice is the same on every device. It can differ
from the reference's only where the two costs are within float32
rounding of each other.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fse_format as fmt

ALS = {"ll": fmt.LL_DEFAULT_ACCURACY, "of": fmt.OF_DEFAULT_ACCURACY,
       "ml": fmt.ML_DEFAULT_ACCURACY}
NSYM = {"ll": 36, "of": 32, "ml": 53}
_DIST = {"ll": fmt.LL_DEFAULT_DIST, "of": fmt.OF_DEFAULT_DIST,
         "ml": fmt.ML_DEFAULT_DIST}
# Multiplicative inverse of the spread step modulo the table size:
# size 64 -> step 43, inverse 3; size 32 -> step 23, inverse 7.
_STEP_INV = {64: ((64 >> 1) + (64 >> 3) + 3, 3),
             32: ((32 >> 1) + (32 >> 3) + 3, 7)}
for _sz, (_st, _iv) in _STEP_INV.items():
    assert (_st * _iv) % _sz == 1

# log2(max(c, 1)) for c = 0..64 as float32: the bit patterns of the
# reference's jnp.log2 on the CPU (16 of them are one ulp off the
# correctly rounded value, so they are constants, not computed).
_LOG2_BITS = (
    0x0, 0x0, 0x3f800000, 0x3fcae00d, 0x40000000, 0x40149a78, 0x40257007,
    0x4033abb4, 0x40400000, 0x404ae00d, 0x40549a78, 0x405d6754, 0x40657006,
    0x406cd400, 0x4073abb4, 0x407a0a7f, 0x40800000, 0x4082cc7f, 0x40857007,
    0x4087ef05, 0x408a4d3c, 0x408c8ddd, 0x408eb3aa, 0x4090c105, 0x4092b803,
    0x40949a78, 0x40966a00, 0x4098280a, 0x4099d5da, 0x409b7494, 0x409d053f,
    0x409e88c6, 0x40a00000, 0x40a16bad, 0x40a2cc7f, 0x40a42316, 0x40a57007,
    0x40a6b3d7, 0x40a7ef05, 0x40a92203, 0x40aa4d3c, 0x40ab7111, 0x40ac8ddd,
    0x40ada3f6, 0x40aeb3aa, 0x40afbd43, 0x40b0c105, 0x40b1bf31, 0x40b2b803,
    0x40b3abb4, 0x40b49a78, 0x40b58482, 0x40b66a00, 0x40b74b1f, 0x40b8280a,
    0x40b900e6, 0x40b9d5d9, 0x40baa709, 0x40bb7494, 0x40bc3e9d, 0x40bd053f,
    0x40bdc899, 0x40be88c6, 0x40bf45e0, 0x40c00000)
_LOG2 = np.asarray(_LOG2_BITS, np.uint32).view(np.float32)


def histogram(codes: torch.Tensor, valid: torch.Tensor, nsym: int
              ) -> torch.Tensor:
    """(B, S) codes in [0, nsym) -> (B, nsym) int64 counts over the valid
    rows."""
    B = codes.shape[0]
    idx = torch.where(valid, codes.to(torch.int64), nsym)
    hist = torch.zeros((B, nsym + 1), dtype=torch.int64, device=codes.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx))
    return hist[:, :nsym]


def _rank_desc(key: torch.Tensor) -> torch.Tensor:
    """rank[i] = number of j with (key[j], -j) > (key[i], -i), per row."""
    K = key.shape[1]
    kj = key[:, None, :]
    ki = key[:, :, None]
    j = torch.arange(K, device=key.device)
    gt = (kj > ki) | ((kj == ki) & (j[None, None, :] < j[None, :, None]))
    return gt.sum(2)


def normalize(hist: torch.Tensor, al: int) -> torch.Tensor:
    """Largest-remainder normalization to sum 2^al, at least 1 per present
    symbol, no -1 entries. (B, K) -> (B, K) int64. The reference's
    lax.while_loop of the shave phase is a Python loop here."""
    target = 1 << al
    hist = hist.to(torch.int64)
    total = hist.sum(1, keepdim=True).clamp(min=1)
    present = hist > 0
    scaled = hist * target
    base = scaled // total
    rem = scaled % total
    norm = torch.where(present, base.clamp(min=1), 0)
    # Deficit: the top-`deficit` remainders among present symbols gain 1.
    deficit = target - norm.sum(1, keepdim=True)
    add_rank = _rank_desc(torch.where(present, rem, -1))
    norm = norm + ((add_rank < deficit) & present).to(torch.int64)
    # Excess: shave the largest norms until no row is over.
    while bool((norm.sum(1) > target).any()):
        over = norm.sum(1, keepdim=True) - target
        r = _rank_desc(torch.where(norm > 1, norm, -1))
        norm = norm - ((r < over) & (norm > 1)).to(torch.int64)
    return norm


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for 1 <= x < 2^16."""
    out = torch.zeros_like(x)
    for k in range(1, 16):
        out = out + (x >= 1 << k).to(x.dtype)
    return out


def build_tables(norm: torch.Tensor, al: int) -> dict:
    """Per-block FSE encode tables from normalized counts (no -1s).

    norm: (B, K) summing to 2^al per block. Returns state_table (B, size),
    dnb (B, K) (delta_nb_bits) and dfs (B, K) (delta_find_state), int64,
    equal to fse_format.build_encode_table's for the same counts. A row
    whose counts do not sum to 2^al (a block with no sequences) gets
    tables that plan_streams never selects."""
    B, K = norm.shape
    size = 1 << al
    step, inv = _STEP_INV[size]
    norm = norm.to(torch.int64)
    dev = norm.device
    cum = torch.cumsum(norm, 1) - norm             # exclusive cumsum
    ks = torch.arange(size, device=dev)
    # Walk entry k holds symbol s with cum[s] <= k < cum[s] + norm[s].
    ends = (cum + norm)[:, None, :]
    sym_walk = (ks[None, :, None] >= ends).sum(2)
    # Slot u of the spread holds walk entry (u * inv) mod size.
    slot_sym = sym_walk[:, (ks * inv) % size].clamp(max=K - 1)
    # state_table[cum[s] + rank of u among s's slots] = size + u.
    eq = slot_sym[:, None, :] == slot_sym[:, :, None]
    lower = ks[None, None, :] < ks[None, :, None]
    rank = (eq & lower).sum(2)
    dest = (cum.gather(1, slot_sym) + rank).clamp(0, size - 1)
    state_table = torch.zeros((B, size), dtype=torch.int64, device=dev)
    state_table.scatter_(1, dest, (size + ks).expand(B, size).contiguous())
    c = norm
    safe_c = c.clamp(min=1)
    maxbits = al - _floor_log2((safe_c - 1).clamp(min=1))
    dnb_ge2 = (maxbits << 16) - (safe_c << maxbits.clamp(0, 31))
    dnb_1 = (al << 16) - (1 << al)
    dnb = torch.where(c == 1, dnb_1, dnb_ge2)
    dnb = torch.where(c == 0, ((al + 1) << 16) - (1 << al), dnb)
    dfs = torch.where(c == 0, 0, cum - torch.where(c == 1, 1, safe_c))
    return {"state_table": state_table, "dnb": dnb, "dfs": dfs}


def _predefined(kind: str, K: int):
    """The predefined table of a stream: its counts padded to K (-1 read
    as 1), state table, and dnb/dfs padded to K with the reference's
    poison values."""
    al = ALS[kind]
    dist = _DIST[kind]
    t = fmt.build_encode_table(dist, al)
    pre = np.zeros(K, np.int64)
    pre[:len(dist)] = dist
    pre[pre < 0] = 1
    dnb = np.full(K, ((al + 1) << 16) - (1 << al), np.int64)
    dfs = np.zeros(K, np.int64)
    kp = len(t.delta_nb_bits)
    dnb[:kp] = np.asarray(t.delta_nb_bits, np.int64)[:K]
    dfs[:kp] = np.asarray(t.delta_find_state, np.int64)[:K]
    return pre, np.asarray(t.state_table, np.int64), dnb, dfs, len(dist)


def plan_streams(codes: torch.Tensor, valid: torch.Tensor, kind: str):
    """Per-block plan for one code stream: (use_custom (B,) bool, norm
    (B, K) int64, per-lane tables dict (state_table, dnb, dfs; custom
    where chosen, predefined elsewhere))."""
    al = ALS[kind]
    K = NSYM[kind]
    dev = codes.device
    hist = histogram(codes, valid, K)
    norm = normalize(hist, al)
    n = hist.sum(1)
    npresent = (hist > 0).sum(1)
    log2c = torch.from_numpy(_LOG2).to(dev)

    def stream_bits(nrm: torch.Tensor, bits_al: int) -> torch.Tensor:
        p = log2c[nrm.clamp(0, 1 << al)]
        terms = torch.where(hist > 0, hist.to(torch.float32) * (bits_al - p),
                            0.0)
        return terms.to(torch.float64).sum(1)

    pre, pre_state, pre_dnb, pre_dfs, pre_nsym = _predefined(kind, K)
    pre_bits = stream_bits(torch.from_numpy(pre).to(dev).expand(
        hist.shape), al)
    # Rough description cost: ~al+1 bits per present symbol + zero runs.
    desc_bits = (npresent + 2) * (al + 1) + 16
    custom_bits = stream_bits(norm, al) + desc_bits.to(torch.float64)
    # The predefined OF alphabet has 29 codes of K = 32: a present code
    # past it forces a custom table.
    over_predef = (hist[:, pre_nsym:] > 0).any(1)
    use_custom = ((custom_bits < pre_bits) & (npresent >= 2) & (n >= 16)) \
        | over_predef
    custom_t = build_tables(norm, al)
    sel = use_custom[:, None]
    mixed = {
        "state_table": torch.where(sel, custom_t["state_table"],
                                   torch.from_numpy(pre_state).to(dev)),
        "dnb": torch.where(sel, custom_t["dnb"],
                           torch.from_numpy(pre_dnb).to(dev)),
        "dfs": torch.where(sel, custom_t["dfs"],
                           torch.from_numpy(pre_dfs).to(dev)),
    }
    return use_custom, norm, mixed
