"""The general traffic generator: a traffic file's parameters and a seed
in, the inputs of a run out.

Every mix is a closed loop: `workers` clients each compress their next
input as soon as their last call has returned (loops.closed), as a
backup writer or the clients of an object-store benchmark do. What
`traffic/<mix>.json` gives decides the inputs:

  object_bytes  `objects` inputs of that size, each made from the seed
                and cycled (large objects back to back);
  size_min,     `requests` inputs, each a slice of a `pool_bytes` seeded
  size_max      pool, of sizes log-uniform between size_min and size_max
                (MinIO warp's `--obj.randsize`), cycled.

Every seed gets the same work: the parts of the corpus mix where the mix
puts them (corpus.py), and in a size mix the same requests: the n
quantiles of the distribution at (i + 0.5) / n, at slices of the pool
fixed for the mix, in one order fixed for the mix in which every run of
`STRATA` consecutive requests holds one size of each of `STRATA` equal
bands. The seed changes the bytes and where in that order the run
starts, not the amount of work nor its sizes, so a window that completes
a few hundred requests completes the same mix whatever the seed, and
runs of different seeds spread as little as runs of one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .corpus import CHUNK, make_corpus, plan

STRATA = 64  # bands of a size mix, one of each in every run of 64


@dataclass
class Inputs:
    workers: int
    objects: list[np.ndarray]   # the inputs, cycled through


def rng_for(seed: int, *names: str) -> np.random.Generator:
    """A generator for one purpose of one seed (any whole number)."""
    words = [abs(int(seed)) % (1 << 64), int(seed < 0)]
    words += [int.from_bytes(n.encode(), "little") for n in names]
    return np.random.default_rng(np.random.SeedSequence(words))


def sizes(traffic: dict, n: int) -> np.ndarray:
    """The n request sizes of a size mix, in ascending order."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = np.log(traffic["size_min"]), np.log(traffic["size_max"])
    return np.exp(lo + q * (hi - lo)).astype(np.int64)


def banded_order(n: int, rng: np.random.Generator) -> np.ndarray:
    """A permutation of range(n) (n a multiple of STRATA) whose every
    group of STRATA consecutive entries holds one index of each band of
    n // STRATA consecutive indices."""
    m = n // STRATA
    bands = np.stack([s * m + rng.permutation(m) for s in range(STRATA)])
    return np.concatenate([rng.permutation(bands[:, g]) for g in range(m)])


def make_inputs(traffic: dict, seed: int) -> Inputs:
    """The inputs of a run, in the order the clients take them."""
    layout = plan(CHUNK, rng_for(0, "plan"))
    if "object_bytes" in traffic:
        return Inputs(traffic["workers"], [make_corpus(
            traffic["object_bytes"], rng_for(seed, "object", str(i)),
            layout, rng_for(0, "order", str(i)))
            for i in range(traffic["objects"])])
    n = traffic["requests"]
    if n % STRATA:
        raise ValueError(f"requests must be a multiple of {STRATA}")
    fixed = rng_for(0, "schedule")  # one order and layout for the mix
    size = sizes(traffic, n)[banded_order(n, fixed)]
    at = fixed.integers(0, traffic["pool_bytes"] - size + 1)
    shift = STRATA * int(rng_for(seed, "shift").integers(n // STRATA))
    pool = make_corpus(traffic["pool_bytes"], rng_for(seed, "pool"),
                       layout, rng_for(0, "order", "pool"))
    return Inputs(traffic["workers"], [
        pool[a:a + s] for a, s in zip(np.roll(at, -shift),
                                      np.roll(size, -shift))])
