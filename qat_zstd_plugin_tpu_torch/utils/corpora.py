"""Deterministic probe corpora with distinct compositions.

Copy of qat_zstd_plugin_tpu.utils.corpora: `corpus_text`,
`corpus_binary` and `corpus_redundant` give the same bytes as the JAX
package's for the same size and seed.

* text     — short-word natural-language-like data with long-range
             paragraph repeats (short-match economics, rep chains).
* binary   — fixed-stride records, small alphabet, ~2% noise (offset
             coherence: greedy longest-wins churns stride multiples).
* redundant— large verbatim repeats at long distances (LDM reach).
* mixed    — the port's corpus.make_corpus, NOT the JAX package's, which
             loads bench.make_corpus and so reads /bin/ls and
             /etc/services: this one reads no file and is the same on
             every machine.

`adversarial` is a copy of tests/test_fuzz.py's `_gen`, the seeded
counterpart of the reference's fuzzing shim: with its defaults it draws
the same bytes for the same generator state.
"""

from __future__ import annotations

import numpy as np

from ..corpus import make_corpus


def corpus_text(nbytes: int, seed: int = 7) -> bytes:
    """Text-heavy: natural-language-like with long-range repeats."""
    rng = np.random.default_rng(seed)
    words = (b"the quick brown fox jumps over the lazy dog "
             b"compression ratio entropy sequence literal match offset "
             b"window frame block stream device kernel lattice ").split()
    paras = []
    while sum(map(len, paras)) < nbytes:
        para = b" ".join(words[i] for i in rng.integers(0, len(words), 600))
        paras.append(para + b"\n\n")
        if rng.random() < 0.3 and paras:  # long-range paragraph repeat
            paras.append(paras[int(rng.integers(0, len(paras)))])
    return b"".join(paras)[:nbytes]


def corpus_binary(nbytes: int, seed: int = 11) -> bytes:
    """Structured binary: fixed-stride records, few distinct values."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < nbytes:
        stride = int(rng.integers(16, 128))
        rec = rng.integers(0, 64, stride, np.uint8)
        block = np.tile(rec, int(rng.integers(50, 400)))
        noise = rng.integers(0, 256, block.size, np.uint8)
        mask = rng.random(block.size) < 0.02
        block = np.where(mask, noise, block).astype(np.uint8)
        parts.append(block.tobytes())
    return b"".join(parts)[:nbytes]


def corpus_redundant(nbytes: int, seed: int = 13) -> bytes:
    """High-redundancy: big verbatim repeats at long distances."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, nbytes // 8, np.uint8).tobytes()
    parts = [base]
    while sum(map(len, parts)) < nbytes:
        s = int(rng.integers(0, len(base) - 5000))
        ln = int(rng.integers(500, 5000))
        parts.append(base[s:s + ln])
    return b"".join(parts)[:nbytes]


def corpus_mixed(nbytes: int, seed: int = 0) -> bytes:
    """The port's seeded mix (corpus.make_corpus), which reads no file."""
    return make_corpus(nbytes, seed=seed)


CORPORA = {
    "text": corpus_text,
    "binary": corpus_binary,
    "redundant": corpus_redundant,
    "mixed": corpus_mixed,
}

# tests/test_fuzz.py's sizes: format edges (Raw_Literals header forms,
# Huffman 1-stream vs 4-stream, the 128 KiB block boundary).
FUZZ_SIZES = (0, 1, 2, 3, 4, 5, 31, 32, 33, 255, 256, 1023, 1024, 4095,
              4096, 65535, 65536, 131071, 131072, 131073, 200000)
FUZZ_KINDS = ("random", "single byte", "short period", "long period",
              "text-like", "runs and noise", "low entropy", "sparse")


def adversarial(rng: np.random.Generator, sizes=FUZZ_SIZES,
                kind: int | None = None) -> bytes:
    """One adversarial buffer, of FUZZ_KINDS[kind] (drawn from rng when
    None) at a size drawn from `sizes`."""
    if kind is None:
        kind = int(rng.integers(0, 8))
    n = int(rng.choice(sizes))
    if kind == 0:  # pure random
        return rng.integers(0, 256, n, np.uint8).tobytes()
    if kind == 1:  # single byte
        return bytes([int(rng.integers(0, 256))]) * n
    if kind == 2:  # short period
        p = rng.integers(0, 256, int(rng.integers(1, 9)), np.uint8).tobytes()
        return (p * (n // max(len(p), 1) + 1))[:n]
    if kind == 3:  # long period
        p = rng.integers(0, 256, int(rng.integers(100, 5000)),
                         np.uint8).tobytes()
        return (p * (n // max(len(p), 1) + 1))[:n]
    if kind == 4:  # text-like
        words = [b"a", b"the ", b"of ", b"zstd", b" compression", b"\n"]
        out, size = [], 0  # _gen's draws, joined once
        while size < n:
            out.append(words[int(rng.integers(0, len(words)))])
            size += len(out[-1])
        return b"".join(out)[:n]
    if kind == 5:  # runs + noise
        parts, size = [], 0
        while size < n:
            if rng.integers(0, 2):
                parts.append(bytes([int(rng.integers(0, 4))])
                             * int(rng.integers(1, 300)))
            else:
                parts.append(rng.integers(0, 256, 50, np.uint8).tobytes())
            size += len(parts[-1])
        return b"".join(parts)[:n]
    if kind == 6:  # low-entropy bytes
        return rng.integers(0, 3, n, np.uint8).tobytes()
    # sparse: zeros with random islands
    buf = np.zeros(n, np.uint8)
    for _ in range(max(n // 500, 1)):
        i = int(rng.integers(0, max(n, 1)))
        buf[i:i + 20] = rng.integers(0, 256, len(buf[i:i + 20]), np.uint8)
    return buf.tobytes()
