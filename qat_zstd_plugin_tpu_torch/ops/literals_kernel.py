"""Device Huffman literals (full device entropy) in PyTorch, with B15
literal_keys and B16 byte_hist as CUDA kernels.

Port of qat_zstd_plugin_tpu.ops.literals_kernel. For a batch of blocks
and its parse (the chosen positions and their match lengths):

1. B15 `literal_keys` marks the literals, the positions no chosen match
   covers, as (pos << 8 | byte) keys (csrc/literals_kernels.cu on a CUDA
   tensor, `literal_keys_twin` on a CPU one);
2. each literal's rank in position order is a running count;
3. B16 `byte_hist` counts the literal bytes per block, and
   ops/huffman_tables.py builds each block's canonical Huffman table;
4. each literal's (code, nbits) goes to its slot in the 4-stream layout,
   every stream in reverse order (a backward stream is written last
   symbol first), and ops/bitconcat.py packs each stream;
5. the host wraps each block's streams into its Compressed_Literals
   section (`device_literals_section`: the tree description, the jump
   table and the header).

Both kernels count their launches in glue_kernels.launches.

One repair: the reference's literal_keys takes the running maximum of the
match ends by 14 doubling steps, so it sees only the last 16384 positions
and marks the positions from start + 16384 on of a longer chosen match as
literals. The hash path's matches (at most 16383 long) never reach that,
but the content path's offset-1 runs (up to 65535) do, and the
reference's section then holds the wrong literals. Here the maximum runs
over the whole row; wherever every chosen match is at most 16384 long
the keys are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import huffman_format as hfmt
from . import bitconcat, huffman_tables
from .bitpack import backward_stream_bytes
from .glue_kernels import _M32, _check, _i32, _launch, _use_twin

LIT_TILE = 32768  # positions a tile of B15 (kLitTile in the CUDA source)
LIT_BOUND_STRIDE = 32  # words between two tiles' bounds (kLitBoundStride)
LIT_MAX_N = 1 << 29  # B15's 30-bit status words hold ends up to n


def _check_rows(name: str, n: int) -> None:
    if n % 8:
        raise ValueError(f"{name}: the kernel takes rows of a multiple of 8 "
                         f"positions, got {n}")


# ---------------------------------------------------------------------------
# B15 literal_keys
# ---------------------------------------------------------------------------

def _literal_keys_args(blocks, lengths, chosen, mlen) -> tuple[int, int]:
    name = "literal_keys"
    _check(blocks, name, torch.uint8, 2)
    _check(lengths, name, torch.int32, 1)
    _check(chosen, name, torch.bool, 2)
    _check(mlen, name, torch.int32, 2)
    B, N = blocks.shape
    if chosen.shape != (B, N) or mlen.shape != (B, N) \
            or lengths.shape != (B,):
        raise ValueError(f"{name}: blocks {tuple(blocks.shape)}, lengths "
                         f"{tuple(lengths.shape)}, chosen "
                         f"{tuple(chosen.shape)} and mlen "
                         f"{tuple(mlen.shape)} do not fit")
    return B, N


def literal_keys_twin(blocks: torch.Tensor, lengths: torch.Tensor,
                      chosen: torch.Tensor, mlen: torch.Tensor
                      ) -> torch.Tensor:
    """Plain-torch B15 (see literal_keys): the running maximum of the
    chosen matches' ends is torch.cummax."""
    _literal_keys_args(blocks, lengths, chosen, mlen)
    N = blocks.shape[1]
    gp = torch.arange(N, device=blocks.device)
    ends = torch.where(chosen, gp + mlen.to(torch.int64), 0)
    covered = ends.cummax(1).values > gp
    is_lit = ~covered & (gp < lengths.to(torch.int64)[:, None])
    key = ((gp << 8) | blocks.to(torch.int64)) & _M32
    return _i32(torch.where(is_lit, key, _M32))


def literal_keys(blocks: torch.Tensor, lengths: torch.Tensor,
                 chosen: torch.Tensor, mlen: torch.Tensor) -> torch.Tensor:
    """B15. (B, N) uint8 blocks, (B,) int32 lengths, the parse's (B, N)
    bool chosen and int32 mlen -> (B, N) int32 bit patterns of u32 keys:
    (pos << 8 | byte) where pos < length and no chosen match at or before
    pos ends after it, 0xFFFFFFFF elsewhere. Port of the Pallas kernel of
    the same name, with its 16384-position window repaired (module
    docstring)."""
    B, N = _literal_keys_args(blocks, lengths, chosen, mlen)
    if _use_twin(blocks, "literal_keys"):
        return literal_keys_twin(blocks, lengths, chosen, mlen)
    _check_rows("literal_keys", N)
    if N >= LIT_MAX_N:
        raise ValueError(f"literal_keys: the kernel takes rows of fewer "
                         f"than {LIT_MAX_N} positions, got {N}")
    keys = torch.empty((B, N), dtype=torch.int32, device=blocks.device)
    if keys.numel():
        # Each tile's status word and bound line, then the tile counter;
        # the entry point zeroes them on the stream.
        words = B * -(-N // LIT_TILE) * (1 + LIT_BOUND_STRIDE)
        scratch = torch.empty(words + 1, dtype=torch.int32,
                              device=blocks.device)
        _launch("literal_keys", blocks, lengths, chosen, mlen, scratch,
                keys, B, N)
    return keys


# ---------------------------------------------------------------------------
# B16 byte_hist
# ---------------------------------------------------------------------------

def byte_hist_twin(keys: torch.Tensor) -> torch.Tensor:
    """Plain-torch B16 (see byte_hist): scatter_add_ of ones, the empty
    keys into a 257th bin that is dropped."""
    _check(keys, "byte_hist", torch.int32, 2)
    B = keys.shape[0]
    idx = torch.where(keys != -1, keys.to(torch.int64) & 0xFF, 256)
    hist = torch.zeros((B, 257), dtype=torch.int32, device=keys.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return hist[:, :256].contiguous()


def byte_hist(keys: torch.Tensor) -> torch.Tensor:
    """B16. (B, N) int32 literal keys (the byte in bits 0-7, -1 =
    0xFFFFFFFF empty) -> (B, 256) int32 histogram of the literal bytes.
    Port of the Pallas kernel of the same name."""
    _check(keys, "byte_hist", torch.int32, 2)
    if _use_twin(keys, "byte_hist"):
        return byte_hist_twin(keys)
    B, N = keys.shape
    _check_rows("byte_hist", N)
    hist = torch.zeros((B, 256), dtype=torch.int32, device=keys.device)
    if keys.numel():
        _launch("byte_hist", keys, hist, B, N)
    return hist


# ---------------------------------------------------------------------------
# The device half of the literals section
# ---------------------------------------------------------------------------

def streams_rule(n: int) -> str | None:
    """Full device entropy's rule for a block length n: the four literal
    streams take n / 4 slots each. Returns it as text when n breaks it,
    else None."""
    if n % 4:
        return (f"block length {n} is not a multiple of 4 (four literal "
                "streams of n / 4 slots)")
    return None


def encode_literals_device(blocks: torch.Tensor, lengths: torch.Tensor,
                           chosen: torch.Tensor, mlen: torch.Tensor,
                           max_words: int | None = None) -> dict:
    """Per-block 4-stream Huffman-coded literals (reference:
    literals_kernel.encode_literals_device).

    Returns a dict of tensors on the blocks' device: words (B*4, W) int32
    and bits (B*4,) int32, the per-stream backward payloads; nb_bits and
    codes (B, 256), max_bits, last_symbol and n_lit (B,) int32; ok (B,)
    bool. A block with ok False keeps the host's literals section (fewer
    than 1024 literals or 2 symbols, a stream over its words or over the
    16-bit jump table, an empty fourth stream).

    The reference finds each literal's (code, nbits) by a sorted join of
    the literals with the table rows, and its 4-stream slot by a sort on
    the destination that fills the unused slots with the sentinel keys as
    zero-bit items. Here both are what they compute: a gather of the
    table entry by byte, and a scatter into zeros at the destination,
    which gives the same items."""
    B, N = blocks.shape
    broken = streams_rule(N)
    if broken:
        raise ValueError(f"encode_literals_device: {broken}")
    cap = N // 4
    if max_words is None:
        max_words = (cap * 12) // 32 + 8  # 11-bit codes + slack
    dev = blocks.device
    keys = literal_keys(blocks, lengths, chosen, mlen)
    valid = keys != -1
    n_lit = valid.sum(1).to(torch.int32)
    # Keys come out in position order, so a literal's rank is a count.
    rank = valid.to(torch.int64).cumsum(1) - 1
    t = huffman_tables.build_tables(byte_hist(keys))
    entry = t["codes"].to(torch.int64) | (t["nb_bits"].to(torch.int64) << 11)
    ent = entry.gather(1, keys.to(torch.int64) & 0xFF)

    # Stream s holds ranks [s*seg, min((s+1)*seg, n)) at slots [s*cap,
    # s*cap + len_s), in reverse: rank s*seg goes last.
    n = n_lit.to(torch.int64)[:, None]
    seg = ((n + 3) // 4).clamp(min=1)
    stream = torch.clamp(rank // seg, max=3)
    within = rank - stream * seg
    len_s = torch.minimum((n - stream * seg).clamp(min=0), seg)
    dest = torch.where(valid, stream * cap + len_s - 1 - within, N)
    packed = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    packed.scatter_(1, dest, torch.where(valid, ent, 0))
    packed = packed[:, :N]
    lo = (packed & 0x7FF).reshape(B * 4, cap).to(torch.int32)
    nb = (packed >> 11).reshape(B * 4, cap).to(torch.int32)
    words, bits, over = bitconcat.bitconcat(lo, torch.zeros_like(lo), nb,
                                            max_words, max_item_bits=11)
    # Streams must fit the 16-bit jump table and the 4-stream layout
    # needs n >= 1024 (the host takes smaller blocks).
    stream_bytes = (bits.reshape(B, 4) + 7 + 1) // 8  # + the sentinel bit
    ok = (t["ok"] & (n_lit >= 1024) & ~over.reshape(B, 4).any(1)
          & (stream_bytes[:, :3] <= 0xFFFF).all(1)
          & (n_lit - 3 * seg[:, 0] >= 1))
    return {"words": words, "bits": bits, "nb_bits": t["nb_bits"],
            "codes": t["codes"], "max_bits": t["max_bits"],
            "last_symbol": t["last_symbol"], "n_lit": n_lit, "ok": ok}


def device_literals_section(nb_bits: np.ndarray, codes: np.ndarray,
                            max_bits: int, last_symbol: int, n_lit: int,
                            words: np.ndarray, bits: np.ndarray
                            ) -> bytes | None:
    """Host wrapper (numpy; reference: literals_kernel.
    device_literals_section): one block's Compressed_Literals section from
    its device streams, words (4, W) and bits (4,): the header, the
    Huffman tree description, the jump table and the four streams. None
    when the section would not be format-legal (the caller keeps the host
    literals path)."""
    table = hfmt.HuffmanTable(
        nb_bits.astype(np.int32), codes.astype(np.int32), int(max_bits),
        int(last_symbol))
    tree = hfmt.serialize_tree(table)
    streams = [backward_stream_bytes(words[s], int(bits[s]))
               for s in range(4)]
    if any(len(s) > 0xFFFF for s in streams[:3]):
        return None
    jump = b"".join(len(s).to_bytes(2, "little") for s in streams[:3])
    comp = len(tree) + len(jump) + sum(map(len, streams))
    if n_lit < 1024 and comp < 1024:
        sf = 1
    elif n_lit < (1 << 14) and comp < (1 << 14):
        sf = 2
    elif n_lit < (1 << 18) and comp < (1 << 18):
        sf = 3
    else:
        return None
    hdr = hfmt.literals_header(hfmt.LIT_COMPRESSED, sf, n_lit, comp)
    return hdr + tree + jump + b"".join(streams)
