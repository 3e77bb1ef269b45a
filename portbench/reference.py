"""The plain reference that the benchmark holds the program's frames to.

A zstd frame reader (RFC 8878) in Python and NumPy, written for this
benchmark and importing nothing but the standard library and numpy: not
the program, not its decoder, not JAX. It judges a frame against the
bytes it was made from, so it decodes by verification:

  * the frame header, every block header, Raw and RLE blocks and the
    content checksum (XXH64 of the input, computed here) are read in full;
  * a Compressed_Block's sequences are decoded (FSE states, extra bits,
    repeat offsets) one by one, the only sequential part; its literals and
    matches are then checked with vector operations against the expected
    bytes: the Huffman streams must read, symbol by symbol, exactly the
    literals the sequences leave at their positions, and every match must
    copy bytes equal to its own. A decoder's output equals the input if
    and only if these hold (induction over positions), so the verdict is
    the one a full decode followed by a comparison would give.

A block is decoded on its own where it can be: the program's encoder
writes every block with its own tables and uses a repeat offset only
after its own explicit offsets have set it. Where a block does lean on an
earlier one (treeless literals, a repeated table, a repeat offset from an
earlier block), `check_block` reads the entropy state of the blocks
before it first, so a frame that uses the whole format is judged right.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
MAX_WINDOW_LOG = 31
HUF_TABLELOG_MAX = 12


class FrameError(ValueError):
    """The frame is malformed, or does not reproduce its input."""


class NeedsHistory(Exception):
    """A block uses entropy state from an earlier block of its frame."""


# ------------------------------------------------------ RFC 8878 tables

LL_BASE = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
           20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
           8192, 16384, 32768, 65536]
LL_EXTRA = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195,
                                16387, 32771, 65539]
ML_EXTRA = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
               2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (default distribution, most symbols, largest accuracy log) per kind.
KINDS = {"ll": (LL_DEFAULT, 35, 9), "of": (OF_DEFAULT, 31, 8),
         "ml": (ML_DEFAULT, 52, 9)}
MASK = [(1 << n) - 1 for n in range(65)]


# ----------------------------------------------------------------- XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, \
    1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M = (1 << 64) - 1


def xxh64(data: bytes | np.ndarray, seed: int = 0) -> int:
    """XXH64 of data (the Content_Checksum is its low 32 bits)."""
    mv = memoryview(np.ascontiguousarray(
        np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray)
        else data, np.uint8)).cast("B")
    n = len(mv)
    p = 0
    if n >= 32:
        a = (seed + _P1 + _P2) & _M
        b = (seed + _P2) & _M
        c = seed
        d = (seed - _P1) & _M
        stop = n - n % 32
        for w, x, y, z in struct.iter_unpack("<4Q", mv[:stop]):
            a = (a + w * _P2) & _M
            a = (((a << 31) | (a >> 33)) & _M) * _P1 & _M
            b = (b + x * _P2) & _M
            b = (((b << 31) | (b >> 33)) & _M) * _P1 & _M
            c = (c + y * _P2) & _M
            c = (((c << 31) | (c >> 33)) & _M) * _P1 & _M
            d = (d + z * _P2) & _M
            d = (((d << 31) | (d >> 33)) & _M) * _P1 & _M
        h = (_rotl(a, 1) + _rotl(b, 7) + _rotl(c, 12) + _rotl(d, 18)) & _M
        for v in (a, b, c, d):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M
        p = stop
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(mv[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        p += 8
    if p + 4 <= n:
        h ^= int.from_bytes(mv[p:p + 4], "little") * _P1 & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        p += 4
    while p < n:
        h ^= mv[p] * _P5 & _M
        h = _rotl(h, 11) * _P1 & _M
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M
    h ^= h >> 29
    h = h * _P3 & _M
    return h ^ (h >> 32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    return _rotl(acc, 31) * _P1 & _M


# ------------------------------------------------------------ bit access


def _windows(buf: bytes) -> np.ndarray:
    """uint64 little-endian windows at every byte of buf, with 8 zero bytes
    before and after it: window (p + 64) >> 3 holds bit p of buf."""
    pad = np.zeros(len(buf) + 16, np.uint8)
    pad[8:8 + len(buf)] = np.frombuffer(buf, np.uint8)
    return np.ndarray((len(pad) - 7,), "<u8", pad.tobytes(), 0, (1,))


def _start_bit(stream: bytes) -> int:
    """Bits in a backward stream below its final padding marker."""
    if not stream or stream[-1] == 0:
        raise FrameError("backward bitstream without its end marker")
    return 8 * (len(stream) - 1) + stream[-1].bit_length() - 1


class _Forward:
    """Forward bit reader (FSE table descriptions)."""

    def __init__(self, data: bytes):
        self.v = int.from_bytes(data, "little")
        self.n = 8 * len(data)
        self.p = 0

    def peek(self, nb: int) -> int:
        return (self.v >> self.p) & MASK[nb]

    def read(self, nb: int) -> int:
        if self.p + nb > self.n:
            raise FrameError("table description runs past its block")
        x = self.peek(nb)
        self.p += nb
        return x


# ------------------------------------------------------------ FSE tables


@dataclass
class FseTable:
    log: int
    sym: list = field(default_factory=list)
    nb: list = field(default_factory=list)
    base: list = field(default_factory=list)


def fse_table(norm: list[int], log: int) -> FseTable:
    """Decoding table from normalized counts (RFC 8878 §4.1.1)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise FrameError("normalized counts do not fill the table")
    nxt = [1 if c == -1 else c for c in norm]
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] += 1
        nb[u] = log - (x.bit_length() - 1)
        base[u] = (x << nb[u]) - size
    return FseTable(log, sym, nb, base)


def rle_table(symbol: int) -> FseTable:
    return FseTable(0, [symbol], [0], [0])


def read_ncount(data: bytes, max_symbol: int, max_log: int
                ) -> tuple[list[int], int, int]:
    """FSE_Table_Description -> (normalized counts, accuracy log, bytes)."""
    r = _Forward(data[:512])
    log = r.read(4) + 5
    if log > max_log:
        raise FrameError("FSE accuracy log too large")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    norm: list[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            while True:
                rep = r.read(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
        vmax = 2 * threshold - 1 - remaining
        small = r.peek(nbits - 1)
        if small < vmax:
            r.read(nbits - 1)
            count = small
        else:
            full = r.read(nbits)
            count = full - vmax if full >= threshold else full
        count -= 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        prev0 = count == 0
        while 1 < remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if len(norm) > max_symbol + 1:
            raise FrameError("too many symbols in a table description")
    if remaining != 1:
        raise FrameError("table description overfills its table")
    return norm, log, (r.p + 7) // 8


# ------------------------------------------------------------- Huffman


@dataclass
class HufTable:
    max_bits: int
    sym: np.ndarray  # (1 << max_bits,) symbol of each peeked value
    nb: np.ndarray   # (256,) code length of each symbol, 0 if absent


def huf_weights(data: bytes) -> tuple[list[int], int]:
    """Huffman_Tree_Description -> (weights incl. the last, bytes read)."""
    if not data:
        raise FrameError("empty Huffman tree description")
    head = data[0]
    if head >= 128:
        n = head - 127
        if 1 + (n + 1) // 2 > len(data):
            raise FrameError("truncated Huffman weights")
        ws = [(data[1 + i // 2] >> 4) if i % 2 == 0
              else data[1 + i // 2] & 15 for i in range(n)]
        used = 1 + (n + 1) // 2
    else:
        if 1 + head > len(data):
            raise FrameError("truncated Huffman weights")
        comp = data[1:1 + head]
        norm, log, k = read_ncount(comp, 255, 6)
        t = fse_table(norm, log)
        stream = comp[k:]
        w = _windows(stream).tolist()
        p = _start_bit(stream)

        def read(nb: int) -> int:
            nonlocal p
            p -= nb
            return (w[(p + 64) >> 3] >> ((p + 64) & 7)) & MASK[nb]
        states = [read(log), read(log)]
        ws = []
        while True:  # two interleaved states until the bits run out
            for k in (0, 1):
                s = states[k]
                ws.append(t.sym[s])
                if p < t.nb[s]:
                    ws.append(t.sym[states[1 - k]])
                    break
                states[k] = t.base[s] + read(t.nb[s])
            else:
                if len(ws) > 255:
                    raise FrameError("Huffman weights do not terminate")
                continue
            break
        used = 1 + head
    total = sum(1 << (x - 1) for x in ws if x > 0)
    if total == 0:
        raise FrameError("no Huffman weights")
    log = total.bit_length()
    if log > HUF_TABLELOG_MAX:
        raise FrameError("Huffman table log too large")
    rest = (1 << log) - total
    if rest & (rest - 1):
        raise FrameError("Huffman weights do not sum to a power of two")
    ws.append(rest.bit_length())
    if len(ws) > 256:
        raise FrameError("more than 256 Huffman symbols")
    return ws, used


def huf_table(ws: list[int]) -> HufTable:
    total = sum(1 << (x - 1) for x in ws if x > 0)
    mb = total.bit_length() - 1
    sym = np.zeros(1 << mb, np.int32)
    nb = np.zeros(256, np.int64)
    start = 0
    for w in range(1, mb + 1):  # canonical order: by weight, then symbol
        for s, x in enumerate(ws):
            if x == w:
                sym[start:start + (1 << (w - 1))] = s
                nb[s] = mb + 1 - w
                start += 1 << (w - 1)
    return HufTable(mb, sym, nb)


def huf_stream_ok(table: HufTable, stream: bytes, want: np.ndarray) -> bool:
    """Whether the backward Huffman stream reads exactly the symbols
    `want`, in order, and ends on its last bit."""
    if len(stream) == 0:
        return False
    p0 = _start_bit(stream)
    lens = table.nb[want]
    if len(want) and not lens.all():
        return False
    pos = p0 - np.concatenate([[0], np.cumsum(lens)])
    if pos[-1] != 0:
        return False
    peek = pos[:-1] - table.max_bits + 64  # bits [p - max_bits, p)
    win = _windows(stream)[peek >> 3] >> (peek & 7).astype(np.uint64)
    got = table.sym[(win & np.uint64(MASK[table.max_bits])).astype(np.int64)]
    return bool(np.array_equal(got, want))


# ------------------------------------------------------------- blocks


@dataclass
class Block:
    kind: int      # 0 raw, 1 RLE, 2 compressed
    body: int      # offset of the block's content in the frame
    size: int      # Block_Size field
    last: bool


@dataclass
class Frame:
    content_size: int | None
    window: int
    checksum: int | None
    blocks: list[Block]


def parse_frame(frame: bytes) -> Frame:
    """The frame header, the chain of block headers and the checksum; the
    frame must end where its last block (and checksum) ends."""
    if len(frame) < 6 or int.from_bytes(frame[:4], "little") != MAGIC:
        raise FrameError("not a zstd frame")
    desc = frame[4]
    if desc & 0x08 or desc & 3:
        raise FrameError("reserved bit or dictionary in the frame header")
    single = bool(desc & 0x20)
    pos = 5
    window = None
    if not single:
        wd = frame[pos]
        log = 10 + (wd >> 3)
        if log > MAX_WINDOW_LOG:
            raise FrameError("window too large")
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
        pos += 1
    fcs_len = {0: 1 if single else 0, 1: 2, 2: 4, 3: 8}[desc >> 6]
    content = None
    if fcs_len:
        content = int.from_bytes(frame[pos:pos + fcs_len], "little") \
            + (256 if fcs_len == 2 else 0)
        pos += fcs_len
    if window is None:
        window = content
    blocks = []
    while True:
        if pos + 3 > len(frame):
            raise FrameError("truncated block header")
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        kind, size, last = (bh >> 1) & 3, bh >> 3, bool(bh & 1)
        if kind == 3:
            raise FrameError("reserved block type")
        span = {0: size, 1: 1, 2: size}[kind]
        if pos + 3 + span > len(frame) or size > BLOCK_MAX \
                or size > max(window, 1):
            raise FrameError("block too large or truncated")
        blocks.append(Block(kind, pos + 3, size, last))
        pos += 3 + span
        if last:
            break
    checksum = None
    if desc & 0x04:
        if pos + 4 > len(frame):
            raise FrameError("truncated checksum")
        checksum = int.from_bytes(frame[pos:pos + 4], "little")
        pos += 4
    if pos != len(frame):
        raise FrameError("bytes after the frame's end")
    return Frame(content, window, checksum, blocks)


@dataclass
class Entropy:
    """Entropy state carried from block to block of a frame; None where it
    is not known (a block read on its own)."""
    huf: HufTable | None = None
    tables: dict = field(default_factory=dict)
    reps: list = field(default_factory=lambda: [None, None, None])

    @classmethod
    def frame_start(cls) -> "Entropy":
        return cls(reps=[1, 4, 8])


def _literals_header(body: bytes) -> tuple[int, int, int, int, int]:
    """(type, size format, regenerated size, header bytes, end of the
    Literals_Section) of a block body."""
    b0 = body[0]
    kind, sf = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if sf in (0, 2):
            regen, hdr = b0 >> 3, 1
        elif sf == 1:
            regen, hdr = (b0 >> 4) | (body[1] << 4), 2
        else:
            regen, hdr = (b0 >> 4) | (body[1] << 4) | (body[2] << 12), 3
        return kind, sf, regen, hdr, hdr + (regen if kind == 0 else 1)
    hdr = (3, 3, 4, 5)[sf]
    v = int.from_bytes(body[:hdr], "little")
    bits = (10, 10, 14, 18)[sf]
    return kind, sf, (v >> 4) & MASK[bits], hdr, \
        hdr + ((v >> (4 + bits)) & MASK[bits])


def _table(mode: int, kind: str, data: bytes, pos: int, ent: Entropy
           ) -> tuple[FseTable, int]:
    (dist, log), max_sym, max_log = KINDS[kind]
    if mode == 0:
        return fse_table(dist, log), pos
    if mode == 1:
        return rle_table(data[pos]), pos + 1
    if mode == 2:
        norm, log, used = read_ncount(data[pos:], max_sym, max_log)
        return fse_table(norm, log), pos + used
    if kind not in ent.tables:
        raise NeedsHistory("repeated sequence table")
    return ent.tables[kind], pos


def _sequences(data: bytes, nseq: int, ent: Entropy
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a Sequences_Section after its nbSeq field into literal
    lengths, match lengths and offsets (repeat offsets resolved)."""
    modes = data[0]
    if modes & 3:
        raise FrameError("reserved bits in the sequence modes")
    pos = 1
    lt, pos = _table(modes >> 6, "ll", data, pos, ent)
    ot, pos = _table((modes >> 4) & 3, "of", data, pos, ent)
    mt, pos = _table((modes >> 2) & 3, "ml", data, pos, ent)
    ent.tables = {"ll": lt, "of": ot, "ml": mt}
    stream = data[pos:]
    w = _windows(stream).tolist()
    p = _start_bit(stream)

    def read(nb: int) -> int:
        nonlocal p
        p -= nb
        return (w[(p + 64) >> 3] >> ((p + 64) & 7)) & MASK[nb]
    sl, so, sm = read(lt.log), read(ot.log), read(mt.log)
    lsym, lnb, lbase = lt.sym, lt.nb, lt.base
    osym, onb, obase = ot.sym, ot.nb, ot.base
    msym, mnb, mbase = mt.sym, mt.nb, mt.base
    lls, mls, offs = [0] * nseq, [0] * nseq, [0] * nseq
    r0, r1, r2 = ent.reps
    for i in range(nseq):
        oc, mc, lc = osym[so], msym[sm], lsym[sl]
        if oc > 31 or mc > 52 or lc > 35:
            raise FrameError("sequence code out of range")
        ov = (1 << oc) + read(oc)
        ml = ML_BASE[mc] + read(ML_EXTRA[mc])
        ll = LL_BASE[lc] + read(LL_EXTRA[lc])
        if ov > 3:
            off = ov - 3
            r0, r1, r2 = off, r0, r1
        else:
            k = ov - 1 if ll else ov
            if k == 0:
                off = r0
            elif k == 1:
                off = r1
                r0, r1 = r1, r0
            elif k == 2:
                off = r2
                r0, r1, r2 = r2, r0, r1
            else:
                off = r0 - 1 if r0 is not None else None
                r0, r1, r2 = off, r0, r1
            if off is None:
                raise NeedsHistory("repeat offset from an earlier block")
        lls[i], mls[i], offs[i] = ll, ml, off
        if i + 1 < nseq:
            sl = lbase[sl] + read(lnb[sl])
            sm = mbase[sm] + read(mnb[sm])
            so = obase[so] + read(onb[so])
    if p != 0:
        raise FrameError("sequence bitstream not consumed exactly")
    ent.reps = [r0, r1, r2]
    return (np.array(lls, np.int64), np.array(mls, np.int64),
            np.array(offs, np.int64))


def _nseq(data: bytes) -> tuple[int, int]:
    b0 = data[0]
    if b0 < 128:
        return b0, 1
    if b0 < 255:
        return ((b0 - 128) << 8) + data[1], 2
    return int.from_bytes(data[1:3], "little") + 0x7F00, 3


def compressed_block_ok(body: bytes, data: np.ndarray, start: int,
                        length: int | None, window: int, ent: Entropy
                        ) -> int:
    """Check that the Compressed_Block `body`, decoded with entropy state
    `ent` (updated), regenerates data[start:start + length] (length None:
    as many bytes as it decodes to), given the frame's content
    data[:start] before it; returns the length, raises FrameError."""
    kind, sf, regen, hdr, lit_end = _literals_header(body)
    if kind >= 2:
        table_at = hdr
        if kind == 2:
            ws, used = huf_weights(body[hdr:lit_end])
            ent.huf = huf_table(ws)
            table_at = hdr + used
        elif ent.huf is None:
            raise NeedsHistory("treeless literals")
    if lit_end > len(body):
        raise FrameError("literals run past the block")
    seqs = body[lit_end:]
    nseq, shdr = _nseq(seqs)
    if nseq:
        ll, ml, off = _sequences(seqs[shdr:], nseq, ent)
    else:
        if len(seqs) != shdr:
            raise FrameError("bytes after an empty sequence section")
        ll = ml = off = np.zeros(0, np.int64)
    # Where each literal run and match starts in the frame's content.
    nlit = int(ll.sum())
    if nlit > regen:
        raise FrameError("sequences take more literals than there are")
    last = regen - nlit
    total = nlit + int(ml.sum()) + last
    if length is None:
        length = total
    if total != length or start + length > len(data):
        raise FrameError(f"block regenerates {total} bytes, not {length}")
    run = ll + ml
    lit_at = start + np.concatenate([[0], np.cumsum(run)[:-1]]) \
        if nseq else np.zeros(0, np.int64)
    match_at = lit_at + ll
    # The literals the sequences place, in order, then the last ones.
    first = np.cumsum(ll) - ll
    idx = np.repeat(lit_at - first, ll) + np.arange(nlit)
    want = np.concatenate([data[idx],
                           data[start + length - last:start + length]])
    if kind == 0:
        ok = np.array_equal(np.frombuffer(body, np.uint8,
                                          regen, hdr), want)
    elif kind == 1:
        ok = bool((want == body[hdr]).all())
    else:
        ok = _huf_literals_ok(ent.huf, body[table_at:lit_end], sf, want)
    if not ok:
        raise FrameError("literals differ from the input")
    if nseq:
        if (off < 1).any() or (off > match_at).any() or (off > window).any():
            raise FrameError("an offset reaches outside the window")
        m0 = np.cumsum(ml) - ml
        pos = np.repeat(match_at - m0, ml) + np.arange(int(ml.sum()))
        src = pos - np.repeat(off, ml)
        if not np.array_equal(data[pos], data[src]):
            raise FrameError("a match copies bytes that differ")
    return length


def _huf_literals_ok(table: HufTable, payload: bytes, sf: int,
                     want: np.ndarray) -> bool:
    if sf == 0:  # one stream
        return huf_stream_ok(table, payload, want)
    if len(payload) < 6:
        return False
    s = [int.from_bytes(payload[i:i + 2], "little") for i in (0, 2, 4)]
    rest = payload[6:]
    if sum(s) > len(rest):
        return False
    seg = (len(want) + 3) // 4
    if 3 * seg > len(want):
        return False
    cuts = [0, s[0], s[0] + s[1], s[0] + s[1] + s[2], len(rest)]
    return all(huf_stream_ok(table, rest[cuts[i]:cuts[i + 1]],
                             want[i * seg:min((i + 1) * seg, len(want))])
               for i in range(4))


# ------------------------------------------------------------- verdicts


def check_block(frame: bytes, info: Frame, k: int, data: np.ndarray,
                block_size: int) -> None:
    """Check block k of a parsed frame against the input `data`, whose
    blocks are block_size bytes each but the last; raise FrameError."""
    b = info.blocks[k]
    start = k * block_size
    length = min(block_size, len(data) - start)
    if b.kind == 0:
        ok = b.size == length and np.array_equal(
            np.frombuffer(frame, np.uint8, b.size, b.body),
            data[start:start + length])
    elif b.kind == 1:
        ok = b.size == length and bool(
            (data[start:start + length] == frame[b.body]).all())
    else:
        body = frame[b.body:b.body + b.size]
        try:
            try:
                compressed_block_ok(body, data, start, length, info.window,
                                    Entropy())
            except NeedsHistory:
                compressed_block_ok(body, data, start, length, info.window,
                                    _entropy_before(frame, info, k))
        except FrameError:
            raise
        except (IndexError, ValueError, struct.error) as e:
            raise FrameError(f"malformed block ({type(e).__name__})") from e
        return
    if not ok:
        raise FrameError(f"block {k} ({'raw' if b.kind == 0 else 'RLE'}) "
                         "differs from the input")


def _entropy_before(frame: bytes, info: Frame, k: int) -> Entropy:
    """Entropy state at the start of block k: the literal tables, sequence
    tables and repeat offsets of blocks 0..k-1 read in order (contents
    not checked)."""
    ent = Entropy.frame_start()
    for b in info.blocks[:k]:
        if b.kind != 2:
            continue
        body = frame[b.body:b.body + b.size]
        kind, _, _, hdr, lit_end = _literals_header(body)
        if kind == 2:
            ent.huf = huf_table(huf_weights(body[hdr:lit_end])[0])
        seqs = body[lit_end:]
        nseq, shdr = _nseq(seqs)
        if nseq:
            _sequences(seqs[shdr:], nseq, ent)
    return ent


def layout_faults(frame: bytes, data: np.ndarray, block_size: int,
                  checksum: bool) -> tuple[Frame | None, list[str]]:
    """The frame read in full but for its compressed blocks' contents:
    header, content size, block count and sizes of the configuration's
    layout, Raw and RLE blocks' bytes, and the checksum's presence."""
    try:
        info = parse_frame(frame)
    except FrameError as e:
        return None, [str(e)]
    except (IndexError, ValueError, KeyError) as e:
        return None, [f"malformed frame ({type(e).__name__})"]
    faults = []
    n = len(data)
    if info.content_size is not None and info.content_size != n:
        faults.append(f"content size {info.content_size}, input {n}")
    if len(info.blocks) != max(1, -(-n // block_size)):
        faults.append(f"{len(info.blocks)} blocks for {n} bytes")
    if (info.checksum is not None) != checksum:
        faults.append("checksum " + ("missing" if checksum else "present"))
    if faults:
        return info, faults
    for k, b in enumerate(info.blocks):
        if b.kind != 2:
            try:
                check_block(frame, info, k, data, block_size)
            except FrameError as e:
                faults.append(str(e))
    return info, faults


def checksum_ok(info: Frame, data: np.ndarray) -> bool:
    return info.checksum is None \
        or info.checksum == xxh64(data) & 0xFFFFFFFF


def frame_faults(frame: bytes, data: np.ndarray) -> list[str]:
    """A whole frame decoded block after block against `data`, whatever
    its block layout: every block, the content size and the checksum."""
    try:
        info = parse_frame(frame)
        ent = Entropy.frame_start()
        pos = 0
        for b in info.blocks:
            if b.kind == 2:
                pos += compressed_block_ok(frame[b.body:b.body + b.size],
                                           data, pos, None, info.window, ent)
                continue
            got = np.frombuffer(frame, np.uint8, b.size, b.body) \
                if b.kind == 0 else np.full(b.size, frame[b.body], np.uint8)
            if not np.array_equal(got, data[pos:pos + b.size]):
                raise FrameError("a raw or RLE block differs from the input")
            pos += b.size
    except NeedsHistory as e:
        return [f"frame start with {e}"]
    except FrameError as e:
        return [str(e)]
    except (IndexError, ValueError, KeyError, struct.error) as e:
        return [f"malformed frame ({type(e).__name__})"]
    faults = []
    if pos != len(data):
        faults.append(f"frame decodes to {pos} bytes, input {len(data)}")
    elif not checksum_ok(info, data):
        faults.append("content checksum differs")
    if info.content_size is not None and info.content_size != pos:
        faults.append("content size field differs from the content")
    return faults
