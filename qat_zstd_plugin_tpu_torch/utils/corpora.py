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
