"""B8 and B15 beside their parent and other designs, on one CUDA device.

    python3 -m qat_zstd_plugin_tpu_torch.designs.slots_literals [--seed S]
        [--parent DIR] [--designs NAMES]

Run from the repository root on a machine with a CUDA device. It builds
csrc/'s dense_kernels.cu and literals_kernels.cu once for each design
(a constant of csrc set to another value, DESIGNS below) into
build/torch_kernels/slots-literals-<key>/, and, with --parent, the same
two sources of the tree at DIR (e.g. the parent commit unpacked from
`git archive` under build/), all at once, and times each over 20
back-to-back calls behind a 2 ms spin on the card (the median of 5 runs,
as chip_smoke.py's stream_ms), at B=64 blocks of 128 KiB:

  B8   compact_slots_dense on level 4's claims (widths 4, 5, 6, 8,
       neighbors 2, ragged lengths) of the mixed bytes of chip_smoke.py,
       LDM spans 0, 4 and 16 (sample slots every 8 and 16 slots), local
       caps 24 and 32;
  B15  literal_keys on the L1 and L9 parses of the corpus (full device
       entropy's first stage), full and ragged lengths, on crafted long
       matches (to 65535, across step and tile edges, past the row's
       end), on rows with no chosen position (every carry is 0) and on
       rows that one match covers from position 0 (every tile but the
       first rewritten after its look-back);

beside the library calls that compute their core: torch.cummax of B15's
(B, N) int32 match ends alone, and, on each B15 case's keys, B16
byte_hist and its twin's scatter_add_ into (B, 257) alone, its int64
index made beforehand. The parent runs first and last, csrc's kernels
(through the wrappers) second and second to last. Every output must
equal csrc's, and csrc's its twin's, or the run fails. --designs takes a
comma-separated subset of DESIGNS ("" for none). It prints the card's
name and power limit, then one JSON object per timing.
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
SOURCES = ("common.cuh", "dense_kernels.cu", "literals_kernels.cu")
# name: (kernel, source, {constant: value}), csrc's other constants kept
DESIGNS = {
    "B8 1 slot a thread": ("B8", "dense_kernels.cu", {"kSlotsPer": "1"}),
    "B8 4 slots a thread": ("B8", "dense_kernels.cu", {"kSlotsPer": "4"}),
    "B8 8 slots a thread": ("B8", "dense_kernels.cu", {"kSlotsPer": "8"}),
    "B8 plain loads": ("B8", "dense_kernels.cu", {"kSlotsStream": "false"}),
    "B15 tiles of 8 steps": ("B15", "literals_kernels.cu",
                             {"kLitSteps": "8"}),
    "B15 tiles of 32 steps": ("B15", "literals_kernels.cu",
                              {"kLitSteps": "32"}),
    "B15 16 positions a thread": ("B15", "literals_kernels.cu",
                                  {"kLitPer": "16", "kLitSteps": "8"}),
    "B15 512 threads a CTA": ("B15", "literals_kernels.cu",
                              {"kLitThreads": "512", "kLitSteps": "8"}),
    "B15 relaxed status words": ("B15", "literals_kernels.cu",
                                 {"kLitOrdered": "false"}),
    "B15 bound words packed": ("B15", "literals_kernels.cu",
                               {"kLitBoundStride": "1"}),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"qz_compact_slots_dense": (_P,) * 5 + (_I,) * 4 + (_P,),
              "qz_literal_keys": (_P,) * 6 + (_I, _I, _P)}


def _sources(csrc: str, design=None) -> dict:
    """The sources of csrc, with a design's constant set (None: as they
    are)."""
    out = {}
    for name in SOURCES:
        with open(os.path.join(csrc, name)) as f:
            out[name] = f.read()
    if design is not None:
        _, source, consts = design
        for const, value in consts.items():
            out[source], hits = re.subn(
                rf"constexpr (int|bool) {const} = \w+;",
                rf"constexpr \1 {const} = {value};", out[source])
            if hits != 1:
                raise SystemExit(f"{source} has no {const}")
    return out


def _libraries(builds: dict) -> dict:
    """Build each {label: sources} into its own shared library (one nvcc
    per build, all at once); returns {label: path}."""
    from ..ops import _build
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for label, srcs in sorted(builds.items()):
        h.update(label.encode() + b"".join(s.encode() for s in
                                           srcs.values()))
    root = os.path.join(_build.BUILD_ROOT,
                        f"slots-literals-{h.hexdigest()[:16]}")
    paths, cmds = {}, []
    for i, (label, srcs) in enumerate(builds.items()):
        d = os.path.join(root, str(i))
        paths[label] = os.path.join(d, "libqz_slots_literals.so")
        if os.path.exists(paths[label]):
            continue
        os.makedirs(d, exist_ok=True)
        for name, text in srcs.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     paths[label], os.path.join(d, "dense_kernels.cu"),
                     os.path.join(d, "literals_kernels.cu")])
    _build._run(cmds)
    return paths


def crafted_parse(torch, rng, B: int, N: int, dev):
    """(chosen, mlen) for B15: sparse random matches (lengths to 40),
    chosen matches of 16383, 16384, 16385, 40000 and 65535 bytes,
    matches across every 2048-position edge (B15's steps; every 16th is
    a tile edge), one that ends exactly at N and one that passes it (a
    raw plane, not a parse: matches may overlap)."""
    chosen = rng.random((B, N)) < 0.02
    mlen = rng.integers(4, 41, (B, N)).astype(np.int32)
    for row, length in enumerate((16383, 16384, 16385, 40000, 65535)):
        chosen[row, 100 + row] = True
        mlen[row, 100 + row] = length
    edges = np.arange(2048, N, 2048)
    chosen[5, edges - 3] = True
    mlen[5, edges - 3] = 2100
    chosen[6, N - 50], mlen[6, N - 50] = True, 50
    chosen[7, N - 20], mlen[7, N - 20] = True, 65535
    return (torch.from_numpy(chosen).to(dev),
            torch.from_numpy(mlen).to(dev))


def _b8_inputs(torch, tk, seed: int):
    """{case: (mlen, moff, est, off, cap)}: level 4's claims of the mixed
    bytes with ragged lengths, and the LDM estimates of spans 4 and 16."""
    from .winmin import _mixed
    x = _mixed(torch, seed)
    B, N = x.shape
    rng = np.random.default_rng(seed + 2)
    lengths = rng.integers(0, N + 1, B).astype(np.int32)
    lengths[0] = N
    lengths = torch.from_numpy(lengths).cuda()
    widths = (4, 5, 6, 8)
    pbits = (WINDOW - 1).bit_length()
    sus = [tk._unsorted(tk.hash_keys(x, w, WINDOW, flip=tk._FLIP), pbits, 2,
                        flipped=True) for w in widths]
    ml, mo = tk.finalize_candidates(sus, x, lengths, widths, WINDOW)
    ests = {0: (None, None)}
    for span in (4, 16):
        stride = tk.ldm_stride(span, N)
        minz = tk.hash_keys_winmin(x, 4, WINDOW, stride)[1]
        ests[span] = tk._ldm_est(tk.ldm_unsorted(minz, span), lengths, N,
                                 span, 1 << 19)
    return {f"cap {cap}, LDM span {span}": (ml, mo, *ests[span], cap)
            for cap in (24, 32) for span in (0, 4, 16)}


def _b15_inputs(torch, seed: int):
    """{case: (blocks, lengths, chosen, mlen)}."""
    from .. import GpuCodec
    from ..corpus import make_corpus
    from ..profile_l1 import hybrid_first_stage
    from .winmin import _mixed
    data = make_corpus(BATCH * BLOCK, seed)
    corpus = torch.from_numpy(np.frombuffer(data, np.uint8)
                              .reshape(BATCH, BLOCK).copy()).cuda()
    B, N = corpus.shape
    rng = np.random.default_rng(seed + 5)
    full = torch.full((B,), N, dtype=torch.int32, device=corpus.device)
    ragged = rng.integers(0, N + 1, B).astype(np.int32)
    ragged[0] = N
    ragged = torch.from_numpy(ragged).cuda()
    parses = {}
    for level in (1, 9):
        _, chosen, mlen = hybrid_first_stage(
            GpuCodec(level=level, batch=B, max_seq=16384,
                     device_entropy=True), corpus, full)
        parses[f"L{level} parse"] = (corpus, chosen, mlen)
    parses["crafted long matches"] = (
        _mixed(torch, seed), *crafted_parse(torch, rng, B, N, corpus.device))
    out = {f"{what}, {ln} lengths": (x, lens, ch, ml)
           for what, (x, ch, ml) in parses.items()
           for ln, lens in (("full", full), ("ragged", ragged))}
    ch, ml = parses["L1 parse"][1:]
    out["no chosen position, full lengths"] = (corpus, full,
                                              torch.zeros_like(ch), ml)
    whole = torch.zeros_like(ch)
    whole[:, 0] = True
    ml = torch.zeros_like(ml)
    ml[:, 0] = N
    ml[1::2, 0] = N - 1
    out["one match from 0 to the row's end, full lengths"] = (corpus, full,
                                                              whole, ml)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", help="root of a tree whose csrc/ has the "
                    "same B8 and B15 entry points")
    ap.add_argument("--designs", default=",".join(DESIGNS),
                    help="comma-separated names of DESIGNS to build")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from ..ops import _build
    from ..ops import glue_kernels as tk
    from ..ops import literals_kernel as lk
    from .k2_k3 import stream_ms
    from .winmin import _load
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    designs = [d for d in args.designs.split(",") if d]
    for d in designs:
        if d not in DESIGNS:
            raise SystemExit(f"no design {d!r}; designs: {list(DESIGNS)}")
    builds = {d: _sources(_build.CSRC, DESIGNS[d]) for d in designs}
    if args.parent:
        builds["parent"] = _sources(os.path.join(
            args.parent, "qat_zstd_plugin_tpu_torch", "csrc"))
    libs = {label: _load(path, SIGNATURES)
            for label, path in _libraries(builds).items()}
    stream = torch.cuda.current_stream().cuda_stream

    def entry(lib, name):
        fn = getattr(lib, name)

        def call(*a):
            rc = fn(*[t.data_ptr() if isinstance(t, torch.Tensor) else t
                      for t in a], stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return call

    def emit(kernel, case, design, fn, out=None, want=None):
        """Time fn; out: the tensor it wrote, to hold against want."""
        if want is not None:
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"{kernel} {design} ({case}) differs from "
                                 "csrc")
        print(json.dumps({"kernel": kernel, "case": case, "design": design,
                          "stream_ms": stream_ms(torch, fn)}), flush=True)

    b8 = _b8_inputs(torch, tk, args.seed)
    b15 = _b15_inputs(torch, args.seed)
    want8, want15 = {}, {}
    for case, (ml, mo, est, off, cap) in b8.items():
        want8[case] = tk.compact_slots_dense(ml, mo, WINDOW, est, off, cap)
        if not torch.equal(want8[case], tk.compact_slots_dense_twin(
                ml, mo, WINDOW, est, off, cap)):
            raise SystemExit(f"B8 csrc ({case}) differs from its twin")
    for case, a in b15.items():
        want15[case] = lk.literal_keys(*a)
        if not torch.equal(want15[case], lk.literal_keys_twin(*a)):
            raise SystemExit(f"B15 csrc ({case}) differs from its twin")

    def run_lib(label, lib, kernels=("B8", "B15")):
        b8_entry = entry(lib, "qz_compact_slots_dense")
        b15_entry = entry(lib, "qz_literal_keys")
        if "B8" in kernels:
            for case, (ml, mo, est, off, cap) in b8.items():
                out = torch.empty_like(want8[case])
                B, N = ml.shape
                spb = 0 if est is None else est.shape[1]
                emit("B8", case, label,
                     lambda: b8_entry(ml, mo, est, off, out, B, N // 4, spb,
                                      cap), out, want8[case])
        if "B15" in kernels:
            for case, (x, lens, ch, ml) in b15.items():
                out = torch.empty_like(want15[case])
                B, N = x.shape
                scratch = torch.empty(B * -(-N // 32) + 1,
                                      dtype=torch.int32, device=x.device)
                emit("B15", case, label,
                     lambda: b15_entry(x, lens, ch, ml, scratch, out, B, N),
                     out, want15[case])

    def run_csrc():
        for case, (ml, mo, est, off, cap) in b8.items():
            emit("B8", case, "csrc", lambda: tk.compact_slots_dense(
                ml, mo, WINDOW, est, off, cap))
        for case, a in b15.items():
            emit("B15", case, "csrc", lambda: lk.literal_keys(*a))

    if args.parent:
        run_lib("parent", libs["parent"])
    run_csrc()
    for d in designs:
        run_lib(d, libs[d], (DESIGNS[d][0],))
    run_csrc()
    if args.parent:
        run_lib("parent", libs["parent"])

    for case, (x, lens, ch, ml) in b15.items():
        gp = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        ends = torch.where(ch, gp + ml, 0)
        emit("B15", case, "torch.cummax of the ends",
             lambda: torch.cummax(ends, 1))
        keys = want15[case]
        emit("B16", case, "csrc", lambda: lk.byte_hist(keys))
        idx = torch.where(keys != -1, keys.to(torch.int64) & 0xFF, 256)
        hist = torch.zeros((keys.shape[0], 257), dtype=torch.int32,
                           device=keys.device)
        ones = torch.ones_like(idx, dtype=torch.int32)
        emit("B16", case, "torch scatter_add_ into (B, 257)",
             lambda: hist.scatter_add_(1, idx, ones))
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
