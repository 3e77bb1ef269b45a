"""The port's zstd frame decoder (pure Python/NumPy, RFC 8878).

Copy of qat_zstd_plugin_tpu.golden.decoder (golden/decoder.py), with its
pieces from the port's own copies: `read_ncount`, `build_decode_table`
and the code tables from fse_format.py, `BackwardBitReader` from
huffman_format.py, XXH64 from xxhash.py. The JAX package keeps it under
golden/ beside its golden matcher and codec; the port has no golden
compression fallback (device="cpu" runs the kernels' twins), so its copy
is just the decoder.

decompress() of the package uses it when stock libzstd is absent, so the
port decodes its frames without libzstd and without a g++ build. It is
also a second reader of frames, independent of libzstd: it decodes the
full feature set that real encoders emit, including what the port's
encoder never writes but stock zstd does (repcodes, treeless literals,
repeat FSE tables). Its verdicts were hardened by the differential
decoder fuzzer (tools/fuzz_decoder.py against stock libzstd) and stay
the JAX package's, but for the Huffman tree description, which it reads
as libzstd does (_read_huffman_weights; ROADMAP.md §C):
tests/test_torch_decoder.py holds them against it. Speed is not a goal
(about 1 MB/s); libzstd stays the fast decoder.
"""

from __future__ import annotations

import numpy as np

from . import fse_format
from .format import MAX_WINDOW_LOG
from .huffman_format import BackwardBitReader
from .xxhash import xxh64

MAGIC = 0xFD2FB528
HUF_TABLELOG_MAX = 12  # libzstd's bound on a Huffman table's log
SKIPPABLE_LO = 0x184D2A50


class DecodeError(ValueError):
    pass


# ---------------------------------------------------------------- huffman


def _read_huffman_weights(data: bytes) -> tuple[list[int], int]:
    """Huffman_Tree_Description -> (weights incl. derived last, bytes read)."""
    if not data:
        raise DecodeError("empty tree description")
    head = data[0]
    if head >= 128:
        n = head - 127
        ws = []
        for i in range(n):
            byte = data[1 + i // 2]
            ws.append((byte >> 4) if i % 2 == 0 else (byte & 0xF))
        consumed = 1 + (n + 1) // 2
    else:
        comp = data[1:1 + head]
        norm, al, used = fse_format.read_ncount(comp, 255)
        table = fse_format.build_decode_table(norm, al)
        r = BackwardBitReader(comp[used:])
        s1 = r.read(al)
        s2 = r.read(al)
        ws = []
        # Two interleaved states, alternating outputs, until bits run dry.
        states = [s1, s2]
        while len(ws) <= 255:  # alphabet bound: weights cover <= 255 syms
            for k in (0, 1):
                st = states[k]
                ws.append(int(table.symbol[st]))
                nb = int(table.nb_bits[st])
                if r.bits_remaining < nb:
                    # Last state flushes without a transition; the OTHER
                    # state emits one final symbol too.
                    other = states[1 - k]
                    ws.append(int(table.symbol[other]))
                    break
                states[k] = int(table.next_state[st]) + r.read(nb)
            else:
                continue
            break
        else:
            raise DecodeError("huffman weight stream does not terminate")
        consumed = 1 + head
    total = sum((1 << (w - 1)) for w in ws if w > 0)
    if total == 0:
        raise DecodeError("no huffman weights")
    # The tree description is read as libzstd's HUF_readStats reads it
    # (designed differences from golden/decoder.py, ROADMAP.md §C): the
    # last weight tops the sum up to the power of two strictly above it
    # (RFC 8878 §4.2.1.3), where golden/decoder.py takes the one at or
    # above it, so that a sum that is already one (symbols at 1/4, 1/4,
    # 1/2) gets a last weight of 0 there and the valid frame is refused;
    # the table log is at most HUF_TABLELOG_MAX; and the weights of 1 are
    # even in number and at least two, which golden/decoder.py does not
    # check, so it decodes such trees where libzstd refuses them.
    table_log = total.bit_length()
    if table_log > HUF_TABLELOG_MAX:
        raise DecodeError("huffman table log too large")
    rest = (1 << table_log) - total
    if rest & (rest - 1):
        raise DecodeError("non-power-of-2 weight remainder")
    last_w = rest.bit_length()  # log2(rest)+1, rest is a power of two
    ws.append(last_w)
    ones = ws.count(1)
    if ones < 2 or ones & 1:
        raise DecodeError("huffman weights of 1: odd or fewer than two")
    return ws, consumed


class HufTable:
    def __init__(self, weights: list[int]):
        # tableLog comes from the weight *sum* (2^mb == sum of 2^(w-1)),
        # not the max weight: nbBits = mb + 1 - w.
        total = sum((1 << (w - 1)) for w in weights if w > 0)
        if total == 0 or total & (total - 1):
            raise DecodeError("incomplete huffman weights")
        self.max_bits = total.bit_length() - 1
        size = 1 << self.max_bits
        self.symbols = np.zeros(size, np.int32)
        self.nbits = np.zeros(size, np.int32)
        rank_start = {}
        next_start = 0
        for w in range(1, self.max_bits + 1):
            rank_start[w] = next_start
            next_start += sum(1 for x in weights if x == w) << (w - 1)
        for sym, w in enumerate(weights):
            if w == 0:
                continue
            length = 1 << (w - 1)
            st = rank_start[w]
            self.symbols[st:st + length] = sym
            self.nbits[st:st + length] = self.max_bits + 1 - w
            rank_start[w] = st + length

    def decode_stream(self, stream: bytes, count: int) -> np.ndarray:
        r = BackwardBitReader(stream)
        out = np.zeros(count, np.uint8)
        mb = self.max_bits
        for i in range(count):
            avail = min(mb, r.bits_remaining)
            if avail <= 0:
                raise DecodeError("huffman stream underflow")
            peek = r.read(avail) << (mb - avail)
            sym = int(self.symbols[peek])
            nb = int(self.nbits[peek])
            out[i] = sym
            # Put back unused bits.
            r._bitpos += avail - nb
        if r.bits_remaining != 0:
            # Stock requires every Huffman stream consumed exactly
            # (HUF's endOfDStream check); accepting leftovers let
            # mutated frames decode that stock rejects (differential
            # decoder fuzzer).
            raise DecodeError("huffman stream not fully consumed")
        return out


# --------------------------------------------------------------- sequences

_PREDEF = {
    0: (fse_format.LL_DEFAULT_DIST, fse_format.LL_DEFAULT_ACCURACY),
    1: (fse_format.OF_DEFAULT_DIST, fse_format.OF_DEFAULT_ACCURACY),
    2: (fse_format.ML_DEFAULT_DIST, fse_format.ML_DEFAULT_ACCURACY),
}


class _SeqTables:
    """Across-block entropy state (repeat modes)."""

    def __init__(self):
        self.ll = None
        self.of = None
        self.ml = None
        self.huf: HufTable | None = None


def _seq_table(mode: int, kind: int, data: bytes, pos: int, prev):
    """Returns (DecodeTable-like, rle_symbol|None, new_pos)."""
    if mode == 0:
        dist, al = _PREDEF[kind]
        return fse_format.build_decode_table(dist, al), None, pos
    if mode == 1:
        return None, data[pos], pos + 1
    if mode == 2:
        norm, al, used = fse_format.read_ncount(data[pos:], 63)
        return fse_format.build_decode_table(norm, al), None, pos + used
    if prev is None:
        raise DecodeError("repeat mode without previous table")
    return prev[0], prev[1], pos


def _decode_sequences(data: bytes, nseq: int, state: _SeqTables
                      ) -> list[tuple[int, int, int]]:
    """Returns [(lit_len, offset_value, match_len)] (raw offset codes)."""
    modes = data[0]
    pos = 1
    llt, ll_rle, pos = _seq_table((modes >> 6) & 3, 0, data, pos,
                                  state.ll)
    oft, of_rle, pos = _seq_table((modes >> 4) & 3, 1, data, pos,
                                  state.of)
    mlt, ml_rle, pos = _seq_table((modes >> 2) & 3, 2, data, pos,
                                  state.ml)
    state.ll = (llt, ll_rle)
    state.of = (oft, of_rle)
    state.ml = (mlt, ml_rle)

    r = BackwardBitReader(data[pos:])
    ll_state = r.read(llt.accuracy_log) if llt is not None else 0
    of_state = r.read(oft.accuracy_log) if oft is not None else 0
    ml_state = r.read(mlt.accuracy_log) if mlt is not None else 0

    out = []
    for i in range(nseq):
        ll_code = int(llt.symbol[ll_state]) if llt is not None else ll_rle
        of_code = int(oft.symbol[of_state]) if oft is not None else of_rle
        ml_code = int(mlt.symbol[ml_state]) if mlt is not None else ml_rle
        if of_code > 31:
            raise DecodeError("offset code too large")
        of_val = (1 << of_code) + (r.read(of_code) if of_code else 0)
        ml = fse_format.ML_BASELINES[ml_code] \
            + r.read(fse_format.ML_BITS[ml_code])
        ll = fse_format.LL_BASELINES[ll_code] \
            + r.read(fse_format.LL_BITS[ll_code])
        out.append((ll, of_val, ml))
        if i + 1 < nseq:
            if llt is not None:
                ll_state = int(llt.next_state[ll_state]) \
                    + r.read(int(llt.nb_bits[ll_state]))
            if mlt is not None:
                ml_state = int(mlt.next_state[ml_state]) \
                    + r.read(int(mlt.nb_bits[ml_state]))
            if oft is not None:
                of_state = int(oft.next_state[of_state]) \
                    + r.read(int(oft.nb_bits[of_state]))
    if r.bits_remaining != 0:
        # Same exact-consumption contract as the literal streams
        # (stock's BIT_endOfDStream check on the sequences stream).
        raise DecodeError("sequence bitstream not fully consumed")
    return out


# ----------------------------------------------------------------- blocks


def _decode_literals(data: bytes, state: _SeqTables
                     ) -> tuple[np.ndarray, int]:
    b0 = data[0]
    lit_type = b0 & 3
    if lit_type in (0, 1):  # Raw / RLE
        sf = (b0 >> 2) & 3
        if sf in (0, 2):
            regen = b0 >> 3
            hdr = 1
        elif sf == 1:
            regen = (b0 >> 4) | (data[1] << 4)
            hdr = 2
        else:
            regen = (b0 >> 4) | (data[1] << 4) | (data[2] << 12)
            hdr = 3
        if lit_type == 0:
            if hdr + regen > len(data):
                raise DecodeError("truncated raw literals")
            return np.frombuffer(data[hdr:hdr + regen], np.uint8), \
                hdr + regen
        if hdr >= len(data):
            raise DecodeError("truncated RLE literals")
        return np.full(regen, data[hdr], np.uint8), hdr + 1
    # Compressed / Treeless
    sf = (b0 >> 2) & 3
    if sf == 0 or sf == 1:
        v = int.from_bytes(data[:3], "little")
        regen = (v >> 4) & 0x3FF
        comp = (v >> 14) & 0x3FF
        hdr = 3
    elif sf == 2:
        v = int.from_bytes(data[:4], "little")
        regen = (v >> 4) & 0x3FFF
        comp = (v >> 18) & 0x3FFF
        hdr = 4
    else:
        v = int.from_bytes(data[:5], "little")
        regen = (v >> 4) & 0x3FFFF
        comp = (v >> 22) & 0x3FFFF
        hdr = 5
    if hdr + comp > len(data):
        raise DecodeError("truncated compressed literals")
    payload = data[hdr:hdr + comp]
    if lit_type == 2:
        ws, used = _read_huffman_weights(payload)
        state.huf = HufTable(ws)
        payload = payload[used:]
    elif state.huf is None:
        raise DecodeError("treeless literals without previous table")
    table = state.huf
    four = not (lit_type == 2 and sf == 0) and not (lit_type == 3 and sf == 0)
    if not four:
        return table.decode_stream(payload, regen), hdr + comp
    seg = (regen + 3) // 4
    s1 = int.from_bytes(payload[0:2], "little")
    s2 = int.from_bytes(payload[2:4], "little")
    s3 = int.from_bytes(payload[4:6], "little")
    p = payload[6:]
    if s1 + s2 + s3 > len(p):
        raise DecodeError("literal stream sizes exceed payload")
    sizes = [s1, s2, s3, len(p) - s1 - s2 - s3]
    counts = [seg, seg, seg, regen - 3 * seg]
    outs = []
    off = 0
    for sz, cnt in zip(sizes, counts):
        outs.append(table.decode_stream(p[off:off + sz], cnt))
        off += sz
    return np.concatenate(outs), hdr + comp


def _execute(literals: np.ndarray, seqs: list[tuple[int, int, int]],
             window_size: int | None, out: bytearray,
             reps: list[int], limit: int | None = None) -> None:
    lpos = 0
    for ll, of_val, ml in seqs:
        if limit is not None and len(out) + ll + ml > limit:
            # Output budget (the decompression-bomb guard: sequence
            # totals are unbounded by input size — a few crafted bytes
            # can demand gigabytes). Enforced per sequence so a hostile
            # frame never allocates past the caller's cap.
            raise DecodeError("output exceeds caller limit")
        if lpos + ll > len(literals):
            # NumPy slices truncate silently; stock rejects sequences
            # demanding more literals than the section regenerated
            # (differential decoder fuzzer).
            raise DecodeError("sequences demand more literals than exist")
        out += literals[lpos:lpos + ll].tobytes()
        lpos += ll
        if of_val > 3:
            offset = of_val - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            idx = of_val - 1 if ll != 0 else of_val
            if idx == 0:
                offset = reps[0]
            elif idx == 1:
                offset = reps[1]
                reps[:] = [offset, reps[0], reps[2]]
            elif idx == 2:
                offset = reps[2]
                reps[:] = [offset, reps[0], reps[1]]
            else:
                offset = reps[0] - 1
                if offset == 0:
                    raise DecodeError("zero repcode offset")
                reps[:] = [offset, reps[0], reps[1]]
        if offset > len(out):
            raise DecodeError("offset beyond window")
        if window_size is not None and offset > window_size:
            raise DecodeError("offset exceeds declared window")
        for _ in range(ml):
            out.append(out[len(out) - offset])
    if limit is not None and len(out) + len(literals) - lpos > limit:
        raise DecodeError("output exceeds caller limit")
    out += literals[lpos:].tobytes()


# ------------------------------------------------------------------ frame


def decompress(frame: bytes, max_output: int | None = None) -> bytes:
    """Decode one zstd frame (skippable frames are skipped).

    max_output caps the total decoded size (DecodeError past it) — the
    decompression-bomb guard for untrusted frames: sequence totals are
    unbounded by input size. Malformed input always raises DecodeError
    (never a stray IndexError/ValueError) — the reject contract the
    differential decoder fuzzer (tools/fuzz_decoder.py) enforces
    against stock libzstd's error behavior."""
    try:
        return _decompress(frame, max_output)
    except DecodeError:
        raise
    except MemoryError:
        raise
    except Exception as exc:  # malformed input tripped a parse step
        raise DecodeError(f"malformed frame ({type(exc).__name__})") \
            from exc


def _decompress(frame: bytes, max_output: int | None) -> bytes:
    pos = 0
    out_all = bytearray()
    while pos < len(frame):
        magic = int.from_bytes(frame[pos:pos + 4], "little")
        if (magic & 0xFFFFFFF0) == SKIPPABLE_LO:
            size = int.from_bytes(frame[pos + 4:pos + 8], "little")
            if pos + 8 + size > len(frame):
                # The skip must land inside the buffer: stock rejects a
                # skippable frame whose size field points past the end;
                # skipping "to" it silently dropped trailing real frames
                # (differential decoder fuzzer, finding #2).
                raise DecodeError("skippable frame size exceeds input")
            pos += 8 + size
            continue
        if magic != MAGIC:
            raise DecodeError(f"bad magic {magic:#x}")
        pos += 4
        desc = frame[pos]
        pos += 1
        fcs_flag = desc >> 6
        single_segment = bool(desc & 0x20)
        checksum = bool(desc & 0x04)
        dict_flag = desc & 3
        if desc & 0x08:
            raise DecodeError("reserved frame descriptor bit set")
        window_size = None
        if not single_segment:
            # Window_Descriptor (RFC 8878 §3.1.1.1.2): enforce it — an
            # offset reaching past the declared window is corruption even
            # when the bytes happen to exist in the output so far.
            wd = frame[pos]
            exponent = 10 + (wd >> 3)
            if exponent > MAX_WINDOW_LOG:  # reject >2GB windows
                raise DecodeError("window too large")
            base = 1 << exponent
            window_size = base + (base // 8) * (wd & 7)
            pos += 1
        if dict_flag:
            raise DecodeError("dictionaries unsupported (reference parity)")
        fcs_len = {0: 1 if single_segment else 0, 1: 2, 2: 4, 3: 8}[fcs_flag]
        # Frame_Content_Size is a PROMISE, not a skip field: stock
        # rejects frames whose decoded size differs from it, and the
        # differential decoder fuzzer caught this decoder silently
        # accepting such frames (finding #1). None = unknown (flag 0
        # without single-segment).
        fcs = None
        if fcs_len:
            if pos + fcs_len > len(frame):
                raise DecodeError("truncated frame header")
            fcs = int.from_bytes(frame[pos:pos + fcs_len], "little")
            if fcs_flag == 1:
                fcs += 256
        pos += fcs_len

        out = bytearray()
        reps = [1, 4, 8]
        state = _SeqTables()
        self_window = window_size  # None = single-segment (window = FCS)
        frame_lim = (None if max_output is None
                     else max_output - len(out_all))
        while True:
            if frame_lim is not None and len(out) > frame_lim:
                raise DecodeError("output exceeds caller limit")
            # Bounds are explicit everywhere a slice could silently
            # shorten: Python slicing truncates at the buffer end, which
            # parsed a 1-byte tail as a whole valid block header
            # (differential decoder fuzzer, finding #3 — stock rejects
            # every truncated read).
            if pos + 3 > len(frame):
                raise DecodeError("truncated block header")
            bh = int.from_bytes(frame[pos:pos + 3], "little")
            pos += 3
            last = bh & 1
            btype = (bh >> 1) & 3
            bsize = bh >> 3
            if frame_lim is not None and btype <= 1 \
                    and len(out) + bsize > frame_lim:
                raise DecodeError("output exceeds caller limit")
            if btype == 0:
                if pos + bsize > len(frame):
                    raise DecodeError("truncated raw block")
                out += frame[pos:pos + bsize]
                pos += bsize
            elif btype == 1:
                if pos >= len(frame):
                    raise DecodeError("truncated RLE block")
                out += bytes([frame[pos]]) * bsize
                pos += 1
            elif btype == 2:
                if pos + bsize > len(frame):
                    raise DecodeError("truncated compressed block")
                body = frame[pos:pos + bsize]
                pos += bsize
                literals, used = _decode_literals(body, state)
                sdata = body[used:]
                b0 = sdata[0]
                if b0 < 128:
                    nseq = b0
                    shdr = 1
                elif b0 < 255:
                    nseq = ((b0 - 128) << 8) + sdata[1]
                    shdr = 2
                else:
                    nseq = int.from_bytes(sdata[1:3], "little") + 0x7F00
                    shdr = 3
                if nseq == 0:
                    if len(sdata) != shdr:
                        # Stock consumes the block body exactly; with
                        # zero sequences there is no bitstream, so any
                        # tail bytes are garbage it rejects (the nseq>0
                        # path gets this from the exact-consumption
                        # check on the sequences bitstream).
                        raise DecodeError(
                            "trailing bytes after zero-sequence header")
                    if frame_lim is not None \
                            and len(out) + len(literals) > frame_lim:
                        raise DecodeError("output exceeds caller limit")
                    out += literals.tobytes()
                else:
                    seqs = _decode_sequences(sdata[shdr:], nseq, state)
                    _execute(literals, seqs, self_window, out, reps,
                             limit=frame_lim)
            else:
                raise DecodeError("reserved block type")
            if last:
                break
        if fcs is not None and len(out) != fcs:
            raise DecodeError(
                f"frame content size mismatch: header promises {fcs}, "
                f"decoded {len(out)}")
        if checksum:
            if pos + 4 > len(frame):
                raise DecodeError("truncated content checksum")
            want = int.from_bytes(frame[pos:pos + 4], "little")
            pos += 4
            got = xxh64(bytes(out), 0) & 0xFFFFFFFF
            if got != want:
                raise DecodeError("content checksum mismatch")
        out_all += out
    return bytes(out_all)
