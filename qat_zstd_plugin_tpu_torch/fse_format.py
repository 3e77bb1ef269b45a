"""FSE and sequence-section format pieces of the port (RFC 8878 §3.1.1.3.2,
§4.1).

Copies of what the device FSE sequence sections need from the JAX
package's format layer:

  * from qat_zstd_plugin_tpu.format.tables: the LL/ML code baselines and
    extra-bit counts, the three predefined distributions and their
    accuracy logs;
  * from qat_zstd_plugin_tpu.format.fse: `spread_symbols`,
    `EncodeTable`, `build_encode_table` and `write_ncount`;
  * from qat_zstd_plugin_tpu.format.bitstream: `ForwardBitWriter`;
  * from qat_zstd_plugin_tpu.format.sequences: `nbseq_header`.

The section bytes equal the JAX package's only while these do;
tests/test_torch_selfcontained.py holds them against it.
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
