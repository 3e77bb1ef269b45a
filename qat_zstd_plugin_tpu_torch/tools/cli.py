"""File compress/decompress CLI — the reference test/test.c analog.

Port of qat_zstd_plugin_tpu.tools.cli:

    python -m qat_zstd_plugin_tpu_torch.tools.cli compress INPUT [-o OUT]
        [-l N] [--device cuda|cpu] [--device-entropy off|hybrid|full]
    python -m qat_zstd_plugin_tpu_torch.tools.cli decompress INPUT [-o OUT]
    python -m qat_zstd_plugin_tpu_torch.tools.cli roundtrip INPUT [-l N]

compress and roundtrip run GpuCodec(level, device=--device,
device_entropy=...) with its batch from QZ_BATCH, as the JAX CLI runs
TpuCodec. Where the JAX CLI auto-detects the device (the software path
without one), --device defaults to cuda, which raises without a card;
--cpu keeps its JAX meaning, the software codec (runtime.soft_codec), and
writes the JAX --cpu file byte for byte. `roundtrip` mirrors
test/test.c:53-146: compress, decompress with stock zstd, memcmp, print
sizes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import decompress
from ..runtime.gpu_codec import GpuCodec
from ..runtime.soft_codec import SoftwareCodec


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qz")
    ap.add_argument("mode", choices=["compress", "decompress", "roundtrip"])
    ap.add_argument("input")
    ap.add_argument("-o", "--output")
    ap.add_argument("-l", "--level", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="force the software path (no device)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device half's device: cuda (the card; raises "
                         "without one) or cpu (the kernels' plain-torch "
                         "twins)")
    ap.add_argument("--device-entropy", default=None,
                    choices=["off", "hybrid", "full"],
                    help="entropy placement: off = host entropy, "
                         "hybrid = device FSE sequence sections + host "
                         "literals, full = complete device bodies "
                         "(default: QZ_DEVICE_ENTROPY env, else off)")
    args = ap.parse_args(argv)

    if not os.path.exists(args.input):
        print(f"qz: {args.input}: no such file", file=sys.stderr)
        return 2
    with open(args.input, "rb") as f:
        data = f.read()

    if args.mode == "decompress":
        out = decompress(data)
        dst = args.output or (args.input.removesuffix(".zst")
                              if args.input.endswith(".zst")
                              else args.input + ".out")
        with open(dst, "wb") as f:
            f.write(out)
        print(f"{args.input}: {len(data)} -> {len(out)} bytes -> {dst}")
        return 0

    if args.cpu:
        codec = SoftwareCodec(level=args.level)
    else:
        de = {None: None, "off": False, "hybrid": "hybrid",
              "full": True}[args.device_entropy]
        codec = GpuCodec(level=args.level, device=args.device,
                         device_entropy=de)
    t0 = time.perf_counter()
    frame = codec.compress(data)
    dt = time.perf_counter() - t0

    if args.mode == "compress":
        dst = args.output or args.input + ".zst"
        with open(dst, "wb") as f:
            f.write(frame)
        print(f"{args.input}: {len(data)} -> {len(frame)} bytes "
              f"({100 * len(frame) / max(len(data), 1):.1f}%) "
              f"in {dt:.2f}s -> {dst}")
        return 0

    # roundtrip (test/test.c parity): stock zstd decodes, memcmp.
    regen = decompress(frame, len(data))
    ok = regen == data
    print(f"source size: {len(data)}")          # test/test.c prints sizes
    print(f"compressed size: {len(frame)} "
          f"({100 * len(frame) / max(len(data), 1):.1f}%)")
    print("round-trip:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run())
