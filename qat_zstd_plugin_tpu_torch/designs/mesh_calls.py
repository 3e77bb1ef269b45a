"""compress_mesh's device-call size, on one CUDA device.

    python3 -m qat_zstd_plugin_tpu_torch.designs.mesh_calls [--seed S]
        [--level 1] [--mb 64] [--mib 64 32 16 8]

Run from the repository root on a machine with a CUDA device. A rank of
parallel.pipeline.compress_mesh cuts its blocks into device calls of
whole LDM spans, each behind its own context span, and unpacks and
finishes one call's blocks on the host while the card runs the next.
This times compress_mesh in a world of one (no process group) on the
seeded corpus (--mb MiB plus a 5000-byte tail) with calls of each --mib
size of input rows, in turns (each size, then the sizes in reverse),
after a warm-up, beside GpuCodec.compress at chip_smoke.py's phase-4
batch (128 at level 1, else 64) first and last. Every frame must equal
the first one. It prints the card's name and power limit, then one JSON
object per run: the size, seconds on the host clock and MB/s.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..corpus import make_corpus
from ..parallel import pipeline
from ..profile_l1 import card_line
from ..runtime.gpu_codec import GpuCodec
from ..runtime.levels import TPU_LEVEL_TABLE

BLOCK = 131072
TAIL = 5000


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--level", type=int, default=1, choices=range(1, 13))
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--mib", type=int, nargs="+", default=[64, 32, 16, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mesh_calls: torch sees no CUDA device")
    print(card_line(), flush=True)
    data = make_corpus((args.mb << 20) + TAIL, args.seed)
    span = TPU_LEVEL_TABLE[args.level].ldm or 1
    batch = 128 if args.level == 1 else 64
    codec = GpuCodec(level=args.level, batch=batch, max_seq=16384,
                     device="cuda", device_entropy=False)
    codec.compress(data[:8 * BLOCK + TAIL])  # warm-up
    pipeline.compress_mesh(data[:8 * BLOCK + TAIL], level=args.level)
    want = None

    def run(what: str, fn) -> None:
        nonlocal want
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = fn()
        seconds = time.perf_counter() - t0
        want = frame if want is None else want
        if frame != want:
            raise AssertionError(f"{what}: the frame differs")
        print(json.dumps({"level": args.level, "run": what,
                          "input_bytes": len(data), "seconds": seconds,
                          "e2e_mbs": len(data) / seconds / 1e6}),
              flush=True)

    def gpu_codec() -> bytes:
        return codec.compress(data, checksum=True)

    run(f"GpuCodec batch {batch}", gpu_codec)
    for mib in args.mib + args.mib[::-1]:
        spans = max(1, (mib << 20) // (span * BLOCK))
        run(f"compress_mesh {mib} MiB calls",
            lambda: pipeline._compress_mesh(data, None, args.level, True,
                                            16384, BLOCK, "cuda", spans))
    run(f"GpuCodec batch {batch}", gpu_codec)


if __name__ == "__main__":
    main()
