"""Seeded test corpus of the port: the same bytes on every machine.

The mix is bench.make_corpus's (text, structured records, low-entropy
binary, runs, incompressible) without its file reads. Inputs longer than
400 000 bytes end with a copy of a 60 000-byte stretch from 300 000 bytes
back, so the long-distance matcher has a match to find.
"""

from __future__ import annotations

import numpy as np

WORDS = [b"the ", b"of ", b"and ", b"compression ", b"data ", b"block ",
         b"sequence ", b"entropy ", b"offset ", b"window ", b"frame ",
         b"match ", b"literal ", b"stream ", b"device ", b"kernel "]


def make_corpus(nbytes: int, seed: int = 0) -> bytes:
    """nbytes of the mix, made with numpy from seed."""
    rng = np.random.default_rng(seed)
    parts = []
    total = 0
    while total < nbytes:
        kind = int(rng.integers(0, 10))
        if kind < 4:  # markov-ish text
            part = b"".join(WORDS[i] for i in
                            rng.integers(0, len(WORDS), 2000))
        elif kind < 6:  # structured records
            rec = rng.integers(0, 256, 64, np.uint8).tobytes()
            part = rec * int(rng.integers(20, 200))
        elif kind < 8:  # low-entropy binary
            part = rng.integers(0, 16, 8000, np.uint8).tobytes()
        elif kind < 9:  # runs
            part = bytes([int(rng.integers(0, 256))]) \
                * int(rng.integers(100, 4000))
        else:  # incompressible
            part = rng.integers(0, 256, 4000, np.uint8).tobytes()
        parts.append(part)
        total += len(part)
    data = bytearray(b"".join(parts)[:nbytes])
    if nbytes > 400_000:
        data[-60_000:] = data[-360_000:-300_000]
    return bytes(data)
