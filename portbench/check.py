"""The comparison that decides `correct`: the frames the timed path
returned, judged by the plain reference (reference.py) against the
inputs they were made from, once the window has closed.

Three numbers, each with the limit 0 (an exact comparison):

  missing      calls of the window that raised or never returned;
  bad_frames   frames, of every call that returned, whose header, block
               chain, Raw and RLE blocks or checksum field break the
               configuration's guarantees: a zstd frame of the input's
               size, checksum as configured, blocks of `block_size`
               bytes but the last;
  bad_decodes  of a sample drawn from the seed, whole frames that do not
               decode to their input (every block, the content size and
               the checksum; the longest request is always among them),
               compressed blocks of the other frames that do not decode
               to their bytes, and frames whose checksum is not XXH64 of
               their input.

The traffic file's "check" says how large the sample is: "frames" whole
frames, "blocks_per_row" further compressed blocks for each row of a
device batch (block k of a frame is row k mod batch of its batch, so a
fault confined to one row is in the sample in every run), "checksums"
further checksums.
"""

from __future__ import annotations

import numpy as np

from . import reference as ref
from .traffic import rng_for

LIMITS = {"missing": 0, "bad_frames": 0, "bad_decodes": 0}


def judge(calls, config: dict, sample: dict, seed: int
          ) -> tuple[dict[str, int], list[str]]:
    """(numbers compared, the first faults found) for the window's calls."""
    bs, checksum = config["block_size"], config["checksum"]
    done = [c for c in calls if c.frame is not None]
    notes: list[str] = []
    numbers = {"missing": len(calls) - len(done), "bad_frames": 0,
               "bad_decodes": 0}
    notes += [f"call of {len(c.data)} bytes: {c.error or 'no answer'}"
              for c in calls if c.frame is None][:5]
    infos = []
    for c in done:
        info, faults = ref.layout_faults(c.frame, c.data, bs, checksum)
        infos.append(info if not faults else None)
        if faults:
            numbers["bad_frames"] += 1
            notes.append(f"frame of {len(c.data)} bytes: {faults[0]}")
    ok = [i for i, info in enumerate(infos) if info is not None]
    rng = rng_for(seed, "check")
    whole = []
    if sample.get("frames") and ok:
        longest = max(ok, key=lambda i: len(done[i].data))
        rest = [i for i in ok if i != longest]
        k = min(len(rest), sample["frames"] - 1)
        whole = [longest] + list(rng.choice(rest, k, replace=False))
    for i in whole:
        faults = ref.frame_faults(done[i].frame, done[i].data)
        if faults:
            numbers["bad_decodes"] += 1
            notes.append(f"frame of {len(done[i].data)} bytes: {faults[0]}")
    chosen = set(whole)
    others = [i for i in ok if i not in chosen]
    rows: dict[int, list[tuple[int, int]]] = {}
    for i in others:
        for k, b in enumerate(infos[i].blocks):
            if b.kind == 2:
                rows.setdefault(k % config["batch"], []).append((i, k))
    picked = [row[j] for _, row in sorted(rows.items())
              for j in _pick(rng, len(row), sample.get("blocks_per_row", 0))]
    for i, k in picked:
        try:
            ref.check_block(done[i].frame, infos[i], k, done[i].data, bs)
        except ref.FrameError as e:
            numbers["bad_decodes"] += 1
            notes.append(f"block {k} of a {len(done[i].data)}-byte frame: "
                         f"{e}")
    for j in _pick(rng, len(others), sample.get("checksums", 0)):
        i = others[j]
        if not ref.checksum_ok(infos[i], done[i].data):
            numbers["bad_decodes"] += 1
            notes.append(f"frame of {len(done[i].data)} bytes: checksum "
                         "differs")
    return numbers, notes


def _pick(rng: np.random.Generator, n: int, k: int) -> list[int]:
    return sorted(rng.choice(n, min(n, k), replace=False).tolist())


def compared(numbers: dict[str, int]) -> dict[str, dict]:
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}


def correct(numbers: dict[str, int]) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
