"""B5, B6 and B9 beside their parent and other tile sizes, on one CUDA
device.

    python3 -m qat_zstd_plugin_tpu_torch.designs.winmin [--seed S]
        [--parent DIR]

Run from the repository root on a machine with a CUDA device. It builds
csrc/'s dense_kernels.cu and content_kernels.cu once for each tile size
of hash_keys_kernel (common.cuh's kHashRows rows of 128 positions a warp,
kHashWarps warps a CTA) into build/torch_kernels/winmin-<key>/, and,
with --parent, the same two sources of the tree at DIR (its entry points
without the flip word and scratch: a commit before the warp-tiled
design), and times each over 20 back-to-back calls behind a 2 ms spin
on the card (the median of 5 runs, as chip_smoke.py's stream_ms), on
the mixed bytes of chip_smoke.py (B=64 blocks of 128 KiB of the seeded
corpus, an all-same block and long runs):

  B5  hash_keys, width 6, flip 0 and the sign flip;
  B6  hash_keys_winmin, width 4, strides 64 and 32, the sign flip;
  B9  ldm_winmin, strides 32 and 64;

beside torch's widening copies of the same bytes (to int32: n read, 4n
written; to int64: 8n written). The parent runs first and last, csrc's
kernels (through the wrappers) second and second to last. Every other
build's output must equal csrc's (the parent's keys with flip 0), or
the run fails. It prints the card's name and power limit, then one JSON
object per timing.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

BLOCK = 131072
BATCH = 64
WINDOW = 32768
TILES = [(8, 4), (4, 4), (16, 4), (8, 8), (4, 8), (2, 8)]  # (rows, warps)
SOURCES = ("common.cuh", "dense_kernels.cu", "content_kernels.cu")
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
NEW = {"qz_hash_keys": (_P, _P, _I, _I, _I, _I, _I, _U, _P),
       "qz_hash_keys_winmin": (_P, _P, _P, _P) + (_I,) * 6 + (_U, _P),
       "qz_ldm_winmin": (_P, _P, _P, _I, _I, _I, _P)}
OLD = {"qz_hash_keys": (_P, _P) + (_I,) * 5 + (_P,),
       "qz_hash_keys_winmin": (_P, _P, _P) + (_I,) * 6 + (_P,),
       "qz_ldm_winmin": (_P, _P, _I, _I, _I, _P)}


def _sources(csrc: str, tile) -> dict:
    """The three sources of csrc, with common.cuh's tile set to `tile`
    (None: as they are)."""
    out = {}
    for name in SOURCES:
        with open(os.path.join(csrc, name)) as f:
            out[name] = f.read()
    if tile is not None:
        for const, value in zip(("kHashRows", "kHashWarps"), tile):
            out["common.cuh"], hits = re.subn(
                rf"constexpr int {const} = \d+;",
                f"constexpr int {const} = {value};", out["common.cuh"])
            if hits != 1:
                raise SystemExit(f"common.cuh has no {const}")
    return out


def _libraries(builds: dict) -> dict:
    """Build each {label: sources} into its own shared library (one nvcc
    per build, all at once); returns {label: path}."""
    from ..ops import _build
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for label, srcs in sorted(builds.items()):
        h.update(label.encode() + b"".join(s.encode() for s in
                                           srcs.values()))
    root = os.path.join(_build.BUILD_ROOT, f"winmin-{h.hexdigest()[:16]}")
    paths, cmds = {}, []
    for i, (label, srcs) in enumerate(builds.items()):
        d = os.path.join(root, str(i))
        paths[label] = os.path.join(d, "libqz_winmin.so")
        if os.path.exists(paths[label]):
            continue
        os.makedirs(d, exist_ok=True)
        for name, text in srcs.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     paths[label], os.path.join(d, "dense_kernels.cu"),
                     os.path.join(d, "content_kernels.cu")])
    _build._run(cmds)
    return paths


def _load(path: str, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _mixed(torch, seed: int):
    """chip_smoke.py's mixed bytes: the corpus with an all-same block and
    runs past the caps."""
    from ..corpus import make_corpus
    data = make_corpus(BATCH * BLOCK, seed)
    x = torch.from_numpy(np.frombuffer(data, np.uint8)
                         .reshape(BATCH, BLOCK).copy()).cuda()
    x[1] = 0x41
    x[2, 20000:60000] = 7
    x[3, BLOCK - 20000:] = 9
    x[4, 1000:70000] = 0xC3
    return x


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", help="root of a tree whose csrc/ has the "
                    "entry points without flip and scratch")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from ..ops import _build
    from ..ops import glue_kernels as tk
    from .k2_k3 import stream_ms
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = {f"tile {r}x{w}": _sources(_build.CSRC, (r, w))
              for r, w in TILES[1:]}
    if args.parent:
        builds["parent"] = _sources(os.path.join(
            args.parent, "qat_zstd_plugin_tpu_torch", "csrc"), None)
    libs = _libraries(builds)
    x = _mixed(torch, args.seed)
    B, n = x.shape
    flip = tk._FLIP
    stream = torch.cuda.current_stream().cuda_stream

    def entry(lib, name):
        fn = getattr(lib, name)

        def call(*a):
            rc = fn(*[t.data_ptr() if isinstance(t, torch.Tensor) else t
                      for t in a], stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return call

    def out():
        return torch.empty((B, n), dtype=torch.int32, device=x.device)

    def runs(lib, old: bool):
        """{case: (fn, outputs)} of one build's entry points."""
        keys, minz = out(), out()
        hk = entry(lib, "qz_hash_keys")
        hw = entry(lib, "qz_hash_keys_winmin")
        lw = entry(lib, "qz_ldm_winmin")
        if old:
            return {"B5 width 6, flip 0x0": (lambda: hk(x, keys, B, n, 6, 15,
                                                      WINDOW - 1), (keys,)),
                    **{f"B6 stride {s}, flip 0x0": (
                        lambda s=s: hw(x, keys, minz, B, n, 4, 15,
                                       WINDOW - 1, s), (keys, minz))
                       for s in (64, 32)},
                    **{f"B9 stride {s}": (lambda s=s: lw(x, minz, B, n, s),
                                          (minz,)) for s in (32, 64)}}
        return {**{f"B5 width 6, flip {f:#x}": (
                    lambda f=f: hk(x, keys, B, n, 6, 15, WINDOW - 1, f),
                    (keys,)) for f in (0, flip)},
                **{f"B6 stride {s}, flip {f:#x}": (
                    lambda s=s, f=f: hw(x, keys, minz, None, B, n, 4, 15,
                                        WINDOW - 1, s, f), (keys, minz))
                   for s in (64, 32) for f in (0, flip)},
                **{f"B9 stride {s}": (lambda s=s: lw(x, minz, None, B, n, s),
                                      (minz,)) for s in (32, 64)}}

    csrc = {**{f"B5 width 6, flip {f:#x}": (
                lambda f=f: tk.hash_keys(x, 6, WINDOW, flip=f), None)
               for f in (0, flip)},
            **{f"B6 stride {s}, flip {f:#x}": (
                lambda s=s, f=f: tk.hash_keys_winmin(x, 4, WINDOW, s,
                                                     flip=f), None)
               for s in (64, 32) for f in (0, flip)},
            **{f"B9 stride {s}": (lambda s=s: tk.ldm_winmin(x, s), None)
               for s in (32, 64)}}
    want = {}
    for case, (fn, _) in csrc.items():
        r = fn()
        want[case] = tuple(t.clone() for t in (r if isinstance(r, tuple)
                                               else (r,)))

    def emit(design, cases, check):
        for case, (fn, outs) in cases.items():
            if check:
                fn()
                torch.cuda.synchronize()
                got = outs if outs is not None else want[case]
                if not all(torch.equal(a.reshape(-1), b.reshape(-1))
                           for a, b in zip(got, want[case])):
                    raise SystemExit(f"{design} ({case}) differs from csrc")
            print(json.dumps({"case": case, "design": design,
                              "stream_ms": stream_ms(torch, fn)}),
                  flush=True)

    order = [("csrc", csrc, False)]
    if args.parent:
        parent = runs(_load(libs["parent"], OLD), True)
        order = [("parent", parent, True)] + order
    tiles = [(f"tile {r}x{w}", runs(_load(libs[f"tile {r}x{w}"], NEW),
                                    False), True) for r, w in TILES[1:]]
    for design, cases, check in order + tiles + order[::-1]:
        emit(design, cases, check)
    for dtype in (torch.int32, torch.int64):
        print(json.dumps({"case": f"copy to {dtype}", "design": "torch",
                          "stream_ms": stream_ms(torch,
                                                 lambda: x.to(dtype))}),
              flush=True)


if __name__ == "__main__":
    main()
