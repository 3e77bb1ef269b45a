"""Seeded input bytes of the benchmark, made in bulk with numpy.

The mix is that of the program's test corpus (qat_zstd_plugin_tpu_torch/
corpus.py): parts of markov-ish text (2000 words of a 16-word
vocabulary), structured records (a 64-byte record repeated 20-199 times),
low-entropy binary (8000 bytes below 16), runs (one byte 100-3999 times)
and incompressible bytes (4000), drawn 4:2:2:1:1; inputs over 400 000
bytes end with a copy of a 60 000-byte stretch from 300 000 bytes back
for the long-distance matcher.

Unlike the original, what a part is (its kind, and its record count or
run length) comes from a plan of about 1 MiB that the caller fixes; the
input is that plan's parts again and again, each chunk in an order the
caller may fix too, and with bytes drawn from the seed. So every seed
compresses alike: seeds differ in the bytes, not in how much of each
kind there is or where it lies, and a run's ratio and rate do not swing
with the seed.
"""

from __future__ import annotations

import numpy as np

WORDS = [b"the ", b"of ", b"and ", b"compression ", b"data ", b"block ",
         b"sequence ", b"entropy ", b"offset ", b"window ", b"frame ",
         b"match ", b"literal ", b"stream ", b"device ", b"kernel "]
_WLEN = np.array([len(w) for w in WORDS], np.int64)
_WTAB = np.zeros((len(WORDS), int(_WLEN.max())), np.uint8)
for _i, _w in enumerate(WORDS):
    _WTAB[_i, :len(_w)] = np.frombuffer(_w, np.uint8)
TEXT, RECORDS, LOW, RUN, RANDOM = range(5)
_KIND = np.array([TEXT] * 4 + [RECORDS] * 2 + [LOW] * 2 + [RUN, RANDOM])
_MEAN = {TEXT: 2000 * _WLEN.mean(), RECORDS: 64 * 109.5, LOW: 8000,
         RUN: 2050, RANDOM: 4000}
_BATCH = 256  # text parts made at once
CHUNK = 1 << 20  # bytes a plan covers


def plan(nbytes: int, rng: np.random.Generator
         ) -> tuple[np.ndarray, np.ndarray]:
    """Kinds of parts for about nbytes, in the mix's proportions, and each
    part's count (records: repeats, run: length; 0 for the others)."""
    mean = sum(_MEAN[k] for k in _KIND) / len(_KIND)
    k = max(1, round(nbytes / mean / len(_KIND)))
    kinds = np.repeat(_KIND, k)  # the mix's proportions exactly
    n = len(kinds)
    counts = np.where(kinds == RECORDS, rng.integers(20, 200, n),
                      np.where(kinds == RUN, rng.integers(100, 4000, n), 0))
    return kinds, counts


def _text(rng: np.random.Generator, n: int):
    """n text parts of 2000 words each, made _BATCH at a time."""
    for s in range(0, n, _BATCH):
        idx = rng.integers(0, len(WORDS), (min(_BATCH, n - s), 2000))
        lens = _WLEN[idx]
        out = _WTAB[idx.ravel()][np.arange(_WTAB.shape[1])
                                 < lens.reshape(-1, 1)]
        yield from np.split(out, np.cumsum(lens.sum(1))[:-1])


def make_corpus(nbytes: int, rng: np.random.Generator,
                parts: tuple[np.ndarray, np.ndarray] | None = None,
                order: np.random.Generator | None = None) -> np.ndarray:
    """nbytes of the mix as a uint8 array: the plan `parts` (drawn from
    rng if None) a chunk after another, each chunk's parts in an order
    drawn from `order` (rng if None) and with bytes drawn from rng, so
    that every stretch of a chunk or more holds the mix in the same
    proportions."""
    if parts is None:
        parts = plan(CHUNK, rng)
    out = []
    total = 0
    while total < nbytes:
        out.append(_chunk(parts, (order or rng).permutation(len(parts[0])),
                          rng))
        total += len(out[-1])
    data = np.concatenate(out)[:nbytes].copy()
    if nbytes > 400_000:
        data[-60_000:] = data[-360_000:-300_000]
    return data


def _chunk(parts: tuple[np.ndarray, np.ndarray], order: np.ndarray,
           rng: np.random.Generator) -> np.ndarray:
    kinds, counts = parts
    text = _text(rng, int((kinds == TEXT).sum()))
    out = []
    for kind, count in zip(kinds[order], counts[order]):
        if kind == TEXT:
            out.append(next(text))
        elif kind == RECORDS:
            out.append(np.tile(rng.integers(0, 256, 64, np.uint8), count))
        elif kind == LOW:
            out.append(rng.integers(0, 16, 8000, np.uint8))
        elif kind == RUN:
            out.append(np.full(count, rng.integers(0, 256), np.uint8))
        else:
            out.append(rng.integers(0, 256, 4000, np.uint8))
    return np.concatenate(out)
