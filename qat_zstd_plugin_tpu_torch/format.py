"""zstd frame assembly of the port (RFC 8878 §3.1.1).

Copy of what the port needs from qat_zstd_plugin_tpu.format: the
sequence record `BlockSequences` and `block_header`, `emit_block`,
`frame_header`, `assemble_frame` from format/frame.py, and the constants
BLOCK_SIZE_MAX, MIN_WINDOW_LOG and MAX_WINDOW_LOG from format/tables.py.
The content checksum (the low 32 bits of XXH64(content, 0)) comes from
the port's own native runtime. `validate_sequences` and MIN_MATCH are
copies of golden/matcher.py's, the byte check done by numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import native

BLOCK_SIZE_MAX = 128 * 1024
MIN_WINDOW_LOG = 10
MAX_WINDOW_LOG = 31

MAGIC = 0xFD2FB528
MIN_MATCH = 3  # the format's shortest match

BLOCK_RAW = 0
BLOCK_RLE = 1
BLOCK_COMPRESSED = 2


@dataclass
class BlockSequences:
    """Sequence IR for one block (the ZSTD_Sequence contract, offsets raw)."""
    lit_lengths: np.ndarray    # literals before each match
    offsets: np.ndarray        # raw offsets >= 1
    match_lengths: np.ndarray  # >= 3
    last_literals: int         # trailing literals after the final match

    @property
    def nseq(self) -> int:
        return len(self.offsets)

    def total_span(self) -> int:
        return int(self.lit_lengths.sum() + self.match_lengths.sum()
                   + self.last_literals)


def validate_sequences(block: np.ndarray, seqs: BlockSequences,
                       ctx_len: int = 0) -> None:
    """Raise AssertionError unless `seqs` is frame-legal and byte-faithful
    for `block` (copy of qat_zstd_plugin_tpu.golden.matcher's, with its
    verdicts): every literal run >= 0 and match >= MIN_MATCH, every
    offset in 1..pos, every matched byte equal to the byte `offset` back,
    and the sequences and last literals spanning the block. `block` may
    carry ctx_len bytes of window context at the front, where offsets
    may reach; the sequences cover only the rest. Sequences are judged in
    order and the first fault is named, as the golden loop does; the byte
    check compares data[p] with data[p - off] for every matched p, so an
    overlapping match (off < ml) needs no special case."""
    data = np.asarray(block, np.uint8)
    ll = np.asarray(seqs.lit_lengths, np.int64)
    off = np.asarray(seqs.offsets, np.int64)
    ml = np.asarray(seqs.match_lengths, np.int64)
    bad_len = (ll < 0) | (ml < MIN_MATCH)
    k = int(np.argmax(bad_len)) if bad_len.any() else len(ll)
    pos = ctx_len + np.cumsum(ll[:k] + ml[:k]) - ml[:k]  # each match start
    bad_off = (off[:k] < 1) | (off[:k] > pos)
    j = int(np.argmax(bad_off)) if bad_off.any() else k
    # Matches [0, e) end inside the data; match e, if any before j, runs
    # past its end, which the golden loop's index also refuses.
    past = pos[:j] + ml[:j] > len(data)
    e = int(np.argmax(past)) if past.any() else j
    m = ml[:e]
    first = np.cumsum(m) - m
    within = np.arange(int(m.sum())) - np.repeat(first, m)
    p = np.repeat(pos[:e], m) + within
    miss = data[p] != data[p - np.repeat(off[:e], m)]
    if miss.any():
        q = int(np.argmax(miss))
        i = int(np.searchsorted(first, q, "right")) - 1
        raise AssertionError(f"seq {i}: mismatch at +{int(within[q])}")
    if e < j:
        raise AssertionError(f"seq {e}: match of {int(ml[e])} at pos "
                             f"{int(pos[e])} runs past {len(data)}")
    if j < k:
        raise AssertionError(f"seq {j}: offset {int(off[j])} at pos "
                             f"{int(pos[j])}")
    if k < len(ll):
        raise AssertionError((k, int(ll[k]), int(ml[k])))
    end = ctx_len + int((ll + ml).sum())
    if end + int(seqs.last_literals) != len(data):
        raise AssertionError("span mismatch")


def content_checksum(data) -> int:
    """Low 32 bits of XXH64(data, 0): the frame's Content_Checksum."""
    return native.xxh64(data, 0) & 0xFFFFFFFF


def block_header(last: bool, btype: int, size: int) -> bytes:
    if size >= 1 << 21:
        raise ValueError(f"block size {size} does not fit a block header")
    v = (1 if last else 0) | (btype << 1) | (size << 3)
    return v.to_bytes(3, "little")


def emit_block(block: np.ndarray, body: bytes | None, last: bool) -> bytes:
    """Choose Raw / RLE / Compressed for one block: never a compressed body
    that is not strictly smaller. The sampled probe rejects most
    non-constant blocks before the full equality scan."""
    n = len(block)
    if n > 0 and (block[::4096] == block[0]).all() \
            and (block == block[0]).all():
        return block_header(last, BLOCK_RLE, n) + bytes([int(block[0])])
    if body is not None and len(body) < n:
        return block_header(last, BLOCK_COMPRESSED, len(body)) + body
    return block_header(last, BLOCK_RAW, n) + block.tobytes()


def frame_header(content_size: int, window_log: int,
                 checksum: bool) -> bytes:
    out = bytearray(MAGIC.to_bytes(4, "little"))
    single_segment = False
    if content_size < 256 and (1 << window_log) >= max(content_size, 1):
        # Tiny frame: single-segment form, window = content size.
        single_segment = True
        fcs_flag = 0
    elif content_size < 65536 + 256:
        fcs_flag = 1
    elif content_size < (1 << 32):
        fcs_flag = 2
    else:
        fcs_flag = 3
    desc = (fcs_flag << 6) | ((1 << 5) if single_segment else 0) | \
        ((1 << 2) if checksum else 0)
    out.append(desc)
    if not single_segment:
        if not MIN_WINDOW_LOG <= window_log <= MAX_WINDOW_LOG:
            raise ValueError(f"window_log {window_log} out of range")
        out.append((window_log - 10) << 3)
    if single_segment:
        out.append(content_size)        # 1-byte FCS (required w/ single seg)
    elif fcs_flag == 1:
        out += (content_size - 256).to_bytes(2, "little")
    elif fcs_flag == 2:
        out += content_size.to_bytes(4, "little")
    else:
        out += content_size.to_bytes(8, "little")
    return bytes(out)


def assemble_frame(data: bytes | np.ndarray,
                   block_bodies: list[bytes | None],
                   block_size: int = BLOCK_SIZE_MAX,
                   checksum: bool = True,
                   window_log: int | None = None) -> bytes:
    """A complete frame from per-block compressed bodies.

    block_bodies[i] is the Compressed_Block content for block i, or None to
    force Raw/RLE. window_log: the stream match window the bodies' offsets
    may reach (cross-block context); None = offsets never cross blocks."""
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    n = len(buf)
    nblocks = max(1, -(-n // block_size))
    if len(block_bodies) != nblocks:
        raise ValueError(f"{len(block_bodies)} bodies for {nblocks} blocks")
    wneed = max(min(n, block_size), 1)
    wlog_need = (wneed - 1).bit_length() if wneed > 1 else 1
    if window_log is not None:
        # Never declare more window than the content could use.
        wlog_need = min(max(window_log, wlog_need),
                        max((n - 1).bit_length(), 1))
    window_log = min(max(wlog_need, MIN_WINDOW_LOG), MAX_WINDOW_LOG)
    out = bytearray(frame_header(n, window_log, checksum))
    for i in range(nblocks):
        blk = buf[i * block_size:(i + 1) * block_size]
        out += emit_block(blk, block_bodies[i], last=(i == nblocks - 1))
    if checksum:
        out += content_checksum(buf).to_bytes(4, "little")
    return bytes(out)
