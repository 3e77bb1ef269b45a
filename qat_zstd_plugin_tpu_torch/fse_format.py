"""FSE and sequence-section format pieces of the port (RFC 8878 §3.1.1.3.2,
§4.1).

Copies of what the device FSE sequence sections need from the JAX
package's format layer:

  * from qat_zstd_plugin_tpu.format.tables: the LL/ML code baselines and
    extra-bit counts, the three predefined distributions and their
    accuracy logs, and the format's maximum accuracy logs;
  * from qat_zstd_plugin_tpu.format.fse: `spread_symbols`,
    `EncodeTable`, `build_encode_table` and `write_ncount`, and for the
    decoder (decoder.py) `DecodeTable`, `build_decode_table` (fse.py:49-72)
    and `read_ncount` (fse.py:202-247);
  * from qat_zstd_plugin_tpu.format.bitstream: `ForwardBitWriter` and
    `ForwardBitReader`;
  * from qat_zstd_plugin_tpu.format.sequences: `nbseq_header`.

The section bytes equal the JAX package's only while these do, and the
decoder's verdicts only while the decode pieces do;
tests/test_torch_selfcontained.py and tests/test_torch_decoder.py hold
them against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Literals-length codes: code -> (baseline, extra bits).
LL_BASELINES = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536,
]
LL_BITS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
]

# Match-length codes: lengths 3..34 are codes 0..31.
ML_BASELINES = [
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
    2051, 4099, 8195, 16387, 32771, 65539,
]
ML_BITS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
]

# Predefined FSE distributions; -1 is a less-than-one probability.
LL_DEFAULT_DIST = [
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
    -1, -1, -1, -1,
]
LL_DEFAULT_ACCURACY = 6

ML_DEFAULT_DIST = [
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    -1, -1, -1, -1, -1,
]
ML_DEFAULT_ACCURACY = 6

OF_DEFAULT_DIST = [
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1,
]
OF_DEFAULT_ACCURACY = 5

# Maximum accuracy logs allowed by the format for each table kind.
LL_MAX_ACCURACY = 9
ML_MAX_ACCURACY = 9
OF_MAX_ACCURACY = 8


def nbseq_header(n: int) -> bytes:
    """Number_of_Sequences varint (RFC 8878 §3.1.1.3.2)."""
    if n < 128:
        return bytes([n])
    if n < 0x7F00:
        return bytes([(n >> 8) + 128, n & 0xFF])
    return bytes([0xFF]) + (n - 0x7F00).to_bytes(2, "little")


class ForwardBitWriter:
    """Plain LSB-first little-endian bit packer (FSE table descriptions)."""

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

    def close(self) -> bytes:
        """Zero-pad to byte boundary and return."""
        if self._nbits:
            self._out.append(self._acc & 0xFF)
            self._acc = 0
            self._nbits = 0
        return bytes(self._out)


class ForwardBitReader:
    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        byte0 = self._pos >> 3
        nbytes = (self._pos % 8 + nbits + 7) // 8
        chunk = int.from_bytes(self._data[byte0:byte0 + nbytes], "little")
        val = (chunk >> (self._pos % 8)) & ((1 << nbits) - 1)
        self._pos += nbits
        return val

    def peek(self, nbits: int) -> int:
        save = self._pos
        val = self.read(nbits)
        self._pos = save
        return val

    @property
    def byte_pos(self) -> int:
        """Bytes consumed, rounded up."""
        return (self._pos + 7) // 8


def spread_symbols(norm: list[int], accuracy_log: int) -> np.ndarray:
    """The canonical symbol-spread over the state table (RFC 8878 §4.1.1)."""
    size = 1 << accuracy_log
    mask = size - 1
    table = np.full(size, -1, dtype=np.int32)
    high = size - 1
    for s, c in enumerate(norm):
        if c == -1:
            table[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            table[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("corrupted normalized counts (spread did not close)")
    return table


@dataclass
class DecodeTable:
    """FSE decode table (decoder.py's sequence and weight tables)."""
    accuracy_log: int
    symbol: np.ndarray      # (size,) int32
    nb_bits: np.ndarray     # (size,) int32
    next_state: np.ndarray  # (size,) int32 (baseline; add read bits)


def build_decode_table(norm: list[int], accuracy_log: int) -> DecodeTable:
    size = 1 << accuracy_log
    table = spread_symbols(norm, accuracy_log)
    symbol_next = np.array([1 if c == -1 else c for c in norm], dtype=np.int64)
    nb_bits = np.zeros(size, dtype=np.int32)
    next_state = np.zeros(size, dtype=np.int32)
    for u in range(size):
        s = table[u]
        x = int(symbol_next[s])
        symbol_next[s] += 1
        nb = accuracy_log - (x.bit_length() - 1)
        nb_bits[u] = nb
        next_state[u] = (x << nb) - size
    return DecodeTable(accuracy_log, table.astype(np.int32), nb_bits, next_state)


@dataclass
class EncodeTable:
    """FSE compression table (the mirror of the decode construction)."""
    accuracy_log: int
    # next-state lookup: index (state >> nbBits) + delta_find_state
    state_table: np.ndarray      # (size,) int32, values in [size, 2*size)
    delta_nb_bits: np.ndarray    # (nsymbols,) int64
    delta_find_state: np.ndarray  # (nsymbols,) int64


def build_encode_table(norm: list[int], accuracy_log: int) -> EncodeTable:
    size = 1 << accuracy_log
    nsym = len(norm)
    spread = spread_symbols(norm, accuracy_log)

    cumul = np.zeros(nsym + 1, dtype=np.int64)
    for s, c in enumerate(norm):
        cumul[s + 1] = cumul[s] + (1 if c == -1 else c)
    assert cumul[nsym] == size

    state_table = np.zeros(size, dtype=np.int32)
    fill = cumul[:nsym].copy()
    for u in range(size):
        s = spread[u]
        state_table[fill[s]] = size + u
        fill[s] += 1

    delta_nb = np.zeros(nsym, dtype=np.int64)
    delta_fs = np.zeros(nsym, dtype=np.int64)
    total = 0
    for s, c in enumerate(norm):
        if c == 0:
            # Symbol never emitted; poison so misuse fails loudly.
            delta_nb[s] = ((accuracy_log + 1) << 16) - (1 << accuracy_log)
            delta_fs[s] = 0
        elif c == -1 or c == 1:
            delta_nb[s] = (accuracy_log << 16) - (1 << accuracy_log)
            delta_fs[s] = total - 1
            total += 1
        else:
            max_bits_out = accuracy_log - ((c - 1).bit_length() - 1)
            min_state_plus = c << max_bits_out
            delta_nb[s] = (max_bits_out << 16) - min_state_plus
            delta_fs[s] = total - c
            total += c
    return EncodeTable(accuracy_log, state_table, delta_nb, delta_fs)


def write_ncount(norm: list[int], accuracy_log: int) -> bytes:
    """Serialize a normalized count table (forward bitstream)."""
    assert 5 <= accuracy_log <= 12
    size = 1 << accuracy_log
    w = ForwardBitWriter()
    w.add(accuracy_log - 5, 4)

    remaining = size + 1
    threshold = size
    nb_bits = accuracy_log + 1
    symbol = 0
    previous_is_0 = False
    nsym = len(norm)
    while remaining > 1 and symbol < nsym:
        if previous_is_0:
            start = symbol
            while symbol < nsym and norm[symbol] == 0:
                symbol += 1
            if symbol == nsym:
                raise ValueError("trailing zero counts beyond last symbol")
            run = symbol
            while run >= start + 24:
                start += 24
                w.add(0xFFFF, 16)
            while run >= start + 3:
                start += 3
                w.add(3, 2)
            w.add(run - start, 2)
        count = norm[symbol]
        symbol += 1
        vmax = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1  # +1 so that stored 0 means "-1" (less-than-one)
        if count >= threshold:
            count += vmax
        if count < vmax:
            w.add(count, nb_bits - 1)
        else:
            w.add(count, nb_bits)
        previous_is_0 = count == 1
        if remaining < 1:
            raise ValueError("normalized counts exceed table size")
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("normalized counts do not sum to table size")
    return w.close()


def read_ncount(data: bytes, max_symbol: int
                ) -> tuple[list[int], int, int]:
    """NCount reader (the decoder's FSE table descriptions).

    Returns (norm_counts, accuracy_log, bytes_consumed).
    """
    r = ForwardBitReader(data)
    accuracy_log = r.read(4) + 5
    size = 1 << accuracy_log
    remaining = size + 1
    threshold = size
    nb_bits = accuracy_log + 1
    norm: list[int] = []
    previous_is_0 = False
    while remaining > 1:
        if previous_is_0:
            while True:
                rep = r.read(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
        vmax = (2 * threshold - 1) - remaining
        small = r.peek(nb_bits - 1)
        if small < vmax:
            r.read(nb_bits - 1)
            count = small
        else:
            full = r.read(nb_bits)
            count = full - vmax if full >= threshold else full
        count -= 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        previous_is_0 = count == 0
        while remaining < threshold and remaining > 1:
            nb_bits -= 1
            threshold >>= 1
        if len(norm) > max_symbol + 1:
            raise ValueError("too many symbols in NCount")
    return norm, accuracy_log, r.byte_pos
