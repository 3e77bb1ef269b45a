"""Huffman literals format pieces of the port (RFC 8878 §3.1.1.3.1, §4.2).

Copies of what the device literals sections need from the JAX package's
format layer, beside fse_format.py (which holds `build_encode_table` and
`write_ncount`):

  * from qat_zstd_plugin_tpu.format.huffman: `HuffmanTable`, `weights`,
    `_fse_compress_weights` and `serialize_tree` (the Huffman tree
    description, direct or FSE-compressed weights);
  * from qat_zstd_plugin_tpu.format.fse: `normalize_counts` and
    `FseEncoder`;
  * from qat_zstd_plugin_tpu.format.bitstream: `BackwardBitWriter`, and
    for the decoder (decoder.py) `BackwardBitReader` (bitstream.py:64-100);
  * from qat_zstd_plugin_tpu.format.frame: `LIT_COMPRESSED` and
    `_literals_header` (here `literals_header`).

The literals sections equal the JAX package's only while these do;
tests/test_torch_selfcontained.py holds them against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import fse_format
from .fse_format import EncodeTable

MAX_FSE_WEIGHT_ACCURACY = 6

LIT_RAW = 0
LIT_RLE = 1
LIT_COMPRESSED = 2


class BackwardBitWriter:
    """Accumulate LSB-first bitfields; emits the backward-read stream."""

    __slots__ = ("_acc", "_nbits", "_out")

    def __init__(self) -> None:
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def add(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        assert 0 <= value < (1 << nbits), (value, nbits)
        self._acc |= value << self._nbits
        self._nbits += nbits
        while self._nbits >= 8:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8

    def add_masked(self, value: int, nbits: int) -> None:
        """Add the low `nbits` of value (value may have high garbage)."""
        self.add(value & ((1 << nbits) - 1), nbits)

    def close(self) -> bytes:
        """Append the sentinel '1' bit, pad to byte, return the stream."""
        self.add(1, 1)
        if self._nbits:
            self._out.append(self._acc & 0xFF)
            self._acc = 0
            self._nbits = 0
        out = bytes(self._out)
        self._out = bytearray()
        return out


class BackwardBitReader:
    """Read a backward stream: the decoder's Huffman and FSE streams."""

    __slots__ = ("_data", "_bitpos")

    def __init__(self, data: bytes) -> None:
        if not data:
            raise ValueError("empty backward bitstream")
        last = data[-1]
        if last == 0:
            raise ValueError("corrupted stream: zero padding byte")
        sentinel = last.bit_length() - 1  # position of highest set bit
        self._data = data
        self._bitpos = (len(data) - 1) * 8 + sentinel  # bits available

    def read(self, nbits: int) -> int:
        """Read `nbits`, the field added last coming out first."""
        if nbits == 0:
            return 0
        if nbits > self._bitpos:
            raise ValueError("bitstream underflow")
        self._bitpos -= nbits
        start = self._bitpos
        # Extract bits [start, start+nbits) of the LSB-first stream.
        byte0 = start >> 3
        nbytes = (start % 8 + nbits + 7) // 8
        chunk = int.from_bytes(self._data[byte0:byte0 + nbytes], "little")
        return (chunk >> (start % 8)) & ((1 << nbits) - 1)

    @property
    def bits_remaining(self) -> int:
        return self._bitpos

    @property
    def exhausted(self) -> bool:
        return self._bitpos == 0


class FseEncoder:
    """Single FSE state machine writing into a shared BackwardBitWriter."""

    __slots__ = ("table", "state")

    def __init__(self, table: EncodeTable, first_symbol: int) -> None:
        # FSE_initCState2: the decoder's first state read yields
        # first_symbol with no preceding bits.
        self.table = table
        tt_nb = int(table.delta_nb_bits[first_symbol])
        nb_out = (tt_nb + (1 << 15)) >> 16
        value = (nb_out << 16) - tt_nb
        idx = (value >> nb_out) + int(table.delta_find_state[first_symbol])
        self.state = int(table.state_table[idx])

    def encode(self, symbol: int, writer: BackwardBitWriter) -> None:
        t = self.table
        nb = (self.state + int(t.delta_nb_bits[symbol])) >> 16
        writer.add_masked(self.state, nb)
        idx = (self.state >> nb) + int(t.delta_find_state[symbol])
        self.state = int(t.state_table[idx])

    def flush(self, writer: BackwardBitWriter) -> None:
        writer.add_masked(self.state, self.table.accuracy_log)


def normalize_counts(hist: np.ndarray, accuracy_log: int,
                     total: int | None = None) -> list[int]:
    """Largest-remainder normalization to 2^accuracy_log with a
    low-probability (-1) cutoff, the sum repaired against the largest
    buckets; stable sorts fix the tie-breaks."""
    hist = np.asarray(hist, dtype=np.int64)
    if total is None:
        total = int(hist.sum())
    size = 1 << accuracy_log
    assert total > 0
    last = int(np.nonzero(hist)[0][-1])
    hist = hist[: last + 1]
    npresent = int((hist > 0).sum())
    if npresent == 1:
        raise ValueError("single-symbol histogram: use RLE mode instead")
    if npresent > size:
        raise ValueError("accuracy log too small for alphabet")

    scaled = hist.astype(np.float64) * size / total
    norm = np.floor(scaled).astype(np.int64)
    lowprob = (hist > 0) & (scaled < 1.0)
    norm[lowprob] = -1
    norm[(hist > 0) & (norm == 0) & ~lowprob] = 1

    def current_sum() -> int:
        return int(np.where(norm == -1, 1, norm).sum())

    delta = size - current_sum()
    if delta != 0:
        order = np.argsort(-(scaled - np.maximum(norm, 0)), kind="stable")
        i = 0
        while delta > 0:
            s = int(order[i % len(order)])
            if norm[s] >= 1:
                norm[s] += 1
                delta -= 1
            i += 1
            if i > 10 * len(order):  # degenerate: dump on the max bucket
                s = int(np.argmax(norm))
                norm[s] += delta
                delta = 0
        big = np.argsort(-norm, kind="stable")
        i = 0
        while delta < 0:
            s = int(big[i % len(big)])
            if norm[s] > 1:
                take = min(norm[s] - 1, -delta)
                norm[s] -= take
                delta += take
            i += 1
            if i > 10 * len(big):
                raise ValueError("cannot normalize histogram")
    if int(norm.max()) >= size:
        raise ValueError("single-symbol dominance: use RLE mode instead")
    assert current_sum() == size
    return [int(v) for v in norm]


@dataclass
class HuffmanTable:
    nb_bits: np.ndarray   # (256,) int32, 0 = symbol absent
    codes: np.ndarray     # (256,) int32
    max_bits: int
    last_symbol: int      # largest present symbol


def weights(table: HuffmanTable) -> list[int]:
    """Weights for symbols 0..last_symbol-1 (last symbol's weight derived)."""
    out = []
    for s in range(table.last_symbol):
        nb = int(table.nb_bits[s])
        out.append(0 if nb == 0 else table.max_bits + 1 - nb)
    return out


def _fse_compress_weights(ws: list[int]) -> bytes | None:
    """Two-state interleaved FSE compression of the weight list."""
    if len(ws) < 2:
        return None
    hist = np.bincount(np.asarray(ws, dtype=np.int64), minlength=13)
    if int((hist > 0).sum()) < 2:
        return None  # single-valued: FSE can't help (RLE not allowed here)
    # FSE accuracy logs are >= 5 (the 4-bit field counts from 5).
    max_al = min(MAX_FSE_WEIGHT_ACCURACY,
                 max(5, (len(ws) - 1).bit_length()))
    try:
        norm = normalize_counts(hist, max_al, total=len(ws))
    except ValueError:
        return None
    desc = fse_format.write_ncount(norm, max_al)
    enc_table = fse_format.build_encode_table(norm, max_al)
    w = BackwardBitWriter()
    n = len(ws)
    # C1 handles even indices, C2 odd; inits consume the top index of each
    # parity, then strictly alternating descending encodes, flush C2 then C1.
    if n % 2 == 1:
        c1 = FseEncoder(enc_table, ws[n - 1])
        c2 = FseEncoder(enc_table, ws[n - 2])
    else:
        c2 = FseEncoder(enc_table, ws[n - 1])
        c1 = FseEncoder(enc_table, ws[n - 2])
    for i in range(n - 3, -1, -1):
        (c2 if i % 2 == 1 else c1).encode(ws[i], w)
    c2.flush(w)
    c1.flush(w)
    out = desc + w.close()
    if len(out) >= 128 or len(out) >= len(ws):
        return None
    return out


def serialize_tree(table: HuffmanTable) -> bytes:
    """Huffman_Tree_Description: header byte + weights."""
    ws = weights(table)
    fse_ws = _fse_compress_weights(ws)
    n = len(ws)
    direct: bytes | None = None
    if n <= 128:
        body = bytearray()
        for i in range(0, n, 2):
            hi = ws[i] << 4
            lo = ws[i + 1] if i + 1 < n else 0
            body.append(hi | lo)
        direct = bytes([127 + n]) + bytes(body)
    if fse_ws is not None and (direct is None
                               or len(fse_ws) + 1 < len(direct)):
        return bytes([len(fse_ws)]) + fse_ws
    if direct is None:
        raise ValueError("cannot serialize huffman tree (too many weights)")
    return direct


def literals_header(lit_type: int, size_format: int, regen: int,
                    comp: int | None) -> bytes:
    """Literals_Section_Header (RFC 8878 §3.1.1.3.1)."""
    if lit_type in (LIT_RAW, LIT_RLE):
        if size_format == 0:          # 5-bit size, 1 byte
            assert regen < 32
            return bytes([lit_type | (regen << 3)])
        if size_format == 1:          # 12-bit size, 2 bytes
            assert regen < 4096
            v = lit_type | (1 << 2) | (regen << 4)
            return v.to_bytes(2, "little")
        assert size_format == 3 and regen < (1 << 20)
        v = lit_type | (3 << 2) | (regen << 4)
        return v.to_bytes(3, "little")
    assert comp is not None
    if size_format == 0:              # 1 stream, 10+10 bits, 3 bytes
        assert regen < 1024 and comp < 1024
        v = lit_type | (0 << 2) | (regen << 4) | (comp << 14)
        return v.to_bytes(3, "little")
    if size_format == 1:              # 4 streams, 10+10 bits, 3 bytes
        assert regen < 1024 and comp < 1024
        v = lit_type | (1 << 2) | (regen << 4) | (comp << 14)
        return v.to_bytes(3, "little")
    if size_format == 2:              # 4 streams, 14+14 bits, 4 bytes
        assert regen < (1 << 14) and comp < (1 << 14)
        v = lit_type | (2 << 2) | (regen << 4) | (comp << 18)
        return v.to_bytes(4, "little")
    assert regen < (1 << 18) and comp < (1 << 18)
    v = lit_type | (3 << 2) | (regen << 4) | (comp << 22)
    return v.to_bytes(5, "little")
