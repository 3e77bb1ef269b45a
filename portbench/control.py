"""Readings that set the limits of check.py: the program's numbers on a
dozen seeds and more, the control's, and planted faults', at a cell's own
sizes and load, in one process.

    python3 -m portbench.control --workload l1.bulk --seconds 8
        --runs none:11,12,13 checksum_off:21,22,23 alter:31,32,33

Each run makes the cell's inputs from its seed, drives a short window of
the cell's traffic (long enough to finish its longest requests; the
sample the check draws is as large as a full run's) and prints one JSON
line with the numbers check.judge compares. The kinds of run:

  none          the program as the configuration states it (sound);
  checksum_off  the control: the program's own path without the content
                checksum, which breaks a guarantee the configuration
                states (compress(..., checksum=False));
  alter         one byte of every compressed block body altered where
                the host half produces it (finish_block_host);
  row           the same in the last row of each device batch alone
                (block k with k mod batch = batch - 1);
  stale         every call returns the previous call's frame (state
                left unchanged);
  half          the second half of every device batch's blocks given the
                first half's bodies (half of the batch left out, the rest
                standing in for it).

The faults are planted on the codec instance for their run and taken off
after it. portbench/tests/test_portbench_faults.py drives the same plants
through a whole run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def plant(kind: str, codec, compress, checksum: bool):
    """The call the window makes under fault `kind`; `undo()` removes the
    plant from the codec."""
    if kind == "none":
        return compress
    if kind == "checksum_off":
        return lambda data: codec.compress(data, checksum=not checksum)
    if kind in ("alter", "row"):
        host = codec.finish_block_host
        last = codec.batch - 1

        def altered(buf, i, *a, **k):
            body = host(buf, i, *a, **k)
            if body and (kind == "alter" or i % codec.batch == last):
                b = bytearray(body)
                b[len(b) // 2] ^= 0x5A
                body = bytes(b)
            return body
        codec.finish_block_host = altered
        return compress
    if kind == "stale":
        last: list[bytes] = []

        def stale(data):
            frame = compress(data)
            out = last[0] if last else frame
            last[:] = [frame]
            return out
        return stale
    if kind == "half":
        bodies = codec.compress_bodies

        def halved(buf, *a, **k):
            out = bodies(buf, *a, **k)
            full = len(buf) // codec.block_size
            for s in range(0, full, codec.batch):
                b = min(codec.batch, full - s)
                for i in range(s + (b + 1) // 2, s + b):
                    out[i] = out[i - (b + 1) // 2]
            return out
        codec.compress_bodies = halved
        return compress
    raise ValueError(f"unknown kind {kind!r}")


def undo(codec) -> None:
    for name in ("finish_block_host", "compress_bodies"):
        codec.__dict__.pop(name, None)


def read(cell, codec, compress, kind: str, seed: int, seconds: float,
         warm: bool = True) -> dict:
    """One run of `kind` on `seed`: check.judge's numbers and more."""
    from .check import correct, judge
    from .run import drive, warm_up
    from .traffic import make_inputs
    inputs = make_inputs(cell.traffic, seed)
    if warm:
        warm_up(compress, inputs)
    call = plant(kind, codec, compress, cell.config["checksum"])
    try:
        w = drive(call, inputs, seconds)
    finally:
        undo(codec)
    numbers, notes = judge(w.calls, cell.config, cell.traffic["check"],
                           seed)
    return {"kind": kind, "seed": seed, "numbers": numbers,
            "correct": correct(numbers), "calls": len(w.calls),
            "window_s": w.seconds, "first_fault": notes[:1]}


def main() -> int:
    from .run import load_cell, make_codec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--runs", nargs="+", required=True,
                    help="kind:seed,seed,...")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    codec, compress = make_codec(cell.config, "cuda")
    warm = True
    for spec in args.runs:
        kind, seeds = spec.split(":")
        for seed in (int(s) for s in seeds.split(",")):
            print(json.dumps(read(cell, codec, compress, kind, seed,
                                  args.seconds, warm)), flush=True)
            warm = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
