"""The LZ4s token-stream contract: the QAT engine's output format.

Copy of qat_zstd_plugin_tpu.format.lz4s (format/lz4s.py): `ML_BITS`,
`RUN_MASK`, `LZ4_MIN_MATCH`, `Lz4sFormatError`, `Sequence`, `decode` with
its capacity guard and `encode`. The QAT accelerator emits LZ4s (an LZ4
variant with a 3-byte minimum match); the reference's CPU hot loop decodes
it into ZSTD_Sequence entries (src/qatseqprod.c:1013-1091, QZSTD_decLz4s).
The port's device half emits sequences directly, so this module is the
format contract that its triples map onto, and a golden model beside
native.dec_lz4s (the same decoder in C++):

* token byte: literal-length high nibble, match-length low nibble
  (RUN_BITS/ML_BITS = 4, src/qatseqprod.c:99-104);
* nibble value 15 extends with 255-saturated continuation bytes;
* little-endian 16-bit offsets (readLE16, :1048): a block of at most
  65536 bytes is the largest whose every offset fits, and `encode` keeps
  only an offset's low 16 bits, as the JAX package's does;
* match length bias +2 (LZ4MINMATCH, :104) giving a 3-byte minimum match;
* zero-match tokens accumulate their literal run into the next real
  sequence (histLiteralLen, :1077-1084);
* the stream terminates in a final literals-only sequence
  {lit+hist, offset=0, match=0} (:1037-1045), counted in the return.

tests/test_torch_lz4s.py holds it against the JAX package's, case for case.
"""

from __future__ import annotations

from dataclasses import dataclass

ML_BITS = 4
ML_MASK = (1 << ML_BITS) - 1
RUN_MASK = ML_MASK
LZ4_MIN_MATCH = 2  # bias added to non-zero match nibbles -> 3-byte minimum


class Lz4sFormatError(ValueError):
    pass


@dataclass
class Sequence:
    """ZSTD_Sequence triple (offset, lit_length, match_length)."""
    offset: int
    lit_length: int
    match_length: int


def decode(stream: bytes, capacity: int | None = None) -> list[Sequence]:
    """Decode an LZ4s token stream into ZSTD_Sequence entries.

    Mirrors QZSTD_decLz4s including the capacity guard (:1073-1076): if the
    sequence count would exceed `capacity`, raises Lz4sFormatError (the
    reference returns the producer-error sentinel).
    """
    out: list[Sequence] = []
    ip = 0
    end = len(stream)
    hist_literals = 0
    while ip < end:
        token = stream[ip]
        ip += 1
        lit_len = token >> ML_BITS
        if lit_len == RUN_MASK:
            while True:
                if ip >= end:
                    raise Lz4sFormatError("truncated literal-length run")
                b = stream[ip]
                ip += 1
                lit_len += b
                if b != 255:
                    break
        ip += lit_len  # skip the literal bytes themselves
        if ip > end:
            raise Lz4sFormatError("literals overrun stream")
        if ip == end:
            # Final literals-only sequence terminates the block (:1037).
            out.append(Sequence(0, lit_len + hist_literals, 0))
            hist_literals = 0
            break
        if ip + 2 > end:
            raise Lz4sFormatError("truncated offset")
        offset = stream[ip] | (stream[ip + 1] << 8)  # readLE16 (:966-990)
        ip += 2
        match_len = token & ML_MASK
        if match_len == ML_MASK:
            while True:
                if ip >= end:
                    raise Lz4sFormatError("truncated match-length run")
                b = stream[ip]
                ip += 1
                match_len += b
                if b != 255:
                    break
        if match_len != 0:
            match_len += LZ4_MIN_MATCH  # 3-byte minimum match (:1060-1062)
            if offset == 0:
                raise Lz4sFormatError("zero offset with non-zero match")
            out.append(Sequence(offset, lit_len + hist_literals, match_len))
            hist_literals = 0
            if capacity is not None and len(out) > capacity:
                raise Lz4sFormatError("sequence capacity exceeded")
        else:
            # Literal-run continuation token (:1077-1084).
            hist_literals += lit_len
    else:
        # Stream ended exactly after a match: emit the empty final
        # literals sequence the reference appends (seqsIdx+1, :1090).
        out.append(Sequence(0, hist_literals, 0))
    return out


def encode(sequences: list[Sequence], literals: bytes) -> bytes:
    """Build an LZ4s token stream (test vector generator; the reference has
    no encoder — hardware produced the streams)."""
    out = bytearray()
    lpos = 0

    def put_len(value: int) -> bytes:
        """Extension bytes when the 4-bit nibble saturates at 15."""
        if value < 15:
            return b""
        rest = value - 15
        ext = bytearray()
        while rest >= 255:
            ext.append(255)
            rest -= 255
        ext.append(rest)
        return bytes(ext)

    for i, seq in enumerate(sequences):
        is_final = i == len(sequences) - 1
        lit = seq.lit_length
        ml = seq.match_length
        if is_final:
            assert ml == 0 and seq.offset == 0, "final must be literal-only"
            token_lit = min(lit, 15)
            out.append(token_lit << ML_BITS)
            out += put_len(lit)
            out += literals[lpos:lpos + lit]
            lpos += lit
        else:
            assert ml >= 3, "LZ4s minimum match is 3"
            stored_ml = ml - LZ4_MIN_MATCH
            token_lit = min(lit, 15)
            token_ml = min(stored_ml, 15)
            out.append((token_lit << ML_BITS) | token_ml)
            out += put_len(lit)
            out += literals[lpos:lpos + lit]
            lpos += lit
            out.append(seq.offset & 0xFF)
            out.append((seq.offset >> 8) & 0xFF)
            out += put_len(stored_ml)
    return bytes(out)
