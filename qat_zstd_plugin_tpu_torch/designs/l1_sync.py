"""K1, K3 and K4 of the level-1 path beside their parent and other designs,
on one CUDA device.

    python3 -m qat_zstd_plugin_tpu_torch.designs.l1_sync [--seed S]
        [--parent DIR [--parent-only]] [--designs NAMES]

Run from the repository root on a machine with a CUDA device. It builds
csrc/'s l1_kernels.cu (with common.cuh) once for each design (a constant
of csrc set to another value, DESIGNS below) into
build/torch_kernels/l1-sync-<key>/, and, with --parent, the same sources
of the tree at DIR (e.g. the parent commit unpacked from `git archive`
under build/: K1 that writes the full plane and no flip, K4 that takes
the estimates of the torch _ldm_est), all at once, and times each over
20 back-to-back calls behind a 2 ms spin on the card (the median of 5
runs, as chip_smoke.py's stream_ms), at level 1's batch: B=128 blocks of
128 KiB of the seeded corpus, width 6, LDM span 4 (stride 32), ragged
lengths:

  K1  hash_keys_winmin_sync: the LDM samples (the main path's) and the
      full plane, flip 0 and the sign flip, and stride 0 (no LDM);
  K3  ldm_keys on the samples (stride 1) and on the plane (stride 32);
  K4  compact_slots_sync on level 1's pair rows, LDM span 0 and 4, flip
      0 and the sign flip; the parent's K4 alone on the estimates and
      the parent's torch _ldm_est + K4 (what the new K4 replaces);
  the chain, find_matches_positions(sync=True) of one batch (the
      parent's: its K1-K4 through ctypes with its torch ops between).

Inputs come from the twins on the card. The parent runs first and last,
csrc's kernels (through the wrappers) second and second to last; every
output must equal csrc's, and csrc's its twin's, or the run fails.
--parent-only times the parent alone (before a tree's new kernels are
built). --designs takes a comma-separated subset of DESIGNS ("" for
none). It prints the card's name and power limit, then one JSON object
per timing.
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
BATCH = 128  # level 1's batch
WINDOW = 32768
WIDTH = 6
SPAN = 4  # level 1's LDM span (stride 32 at 128 KiB)
MAX_OFF = 1 << 19
SOURCES = ("common.cuh", "l1_kernels.cu")
# name: (kernel, {constant: value}), csrc's other constants kept
DESIGNS = {
    "K1 tiles of 4 rows": ("K1", {"kK1Rows": "4"}),
    "K1 tiles of 16 rows": ("K1", {"kK1Rows": "16"}),
    "K1 2 warps a CTA": ("K1", {"kK1Warps": "2"}),
    "K1 8 warps a CTA": ("K1", {"kK1Warps": "8"}),
    "K4 1 slot a thread": ("K4", {"kSyncSlots": "1"}),
    "K4 2 slots a thread": ("K4", {"kSyncSlots": "2"}),
    "K4 8 slots a thread": ("K4", {"kSyncSlots": "8"}),
    "K4 plain loads": ("K4", {"kSyncStream": "false"}),
}
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
NEW = {"qz_hash_keys_winmin_sync": (_P,) * 4 + (_I,) * 6 + (_U, _I, _P),
       "qz_compact_slots_sync": (_P,) * 4 + (_I,) * 9 + (_U, _P)}
OLD = {"qz_hash_keys_winmin_sync": (_P,) * 3 + (_I,) * 6 + (_P,),
       "qz_neighbor_unsort_keys": (_P, _P) + (_I,) * 5 + (_U, _P),
       "qz_ldm_keys": (_P, _P) + (_I,) * 5 + (_U, _P),
       "qz_compact_slots_sync": (_P,) * 5 + (_I,) * 5 + (_P,)}


def _sources(csrc: str, design=None) -> dict:
    """The sources of csrc, with a design's constants set (None: as they
    are)."""
    out = {}
    for name in SOURCES:
        with open(os.path.join(csrc, name)) as f:
            out[name] = f.read()
    for const, value in (design[1] if design else {}).items():
        out["l1_kernels.cu"], hits = re.subn(
            rf"constexpr (int|bool) {const} = \w+;",
            rf"constexpr \1 {const} = {value};", out["l1_kernels.cu"])
        if hits != 1:
            raise SystemExit(f"l1_kernels.cu has no {const}")
    return out


def _libraries(builds: dict) -> dict:
    """Build each {label: sources} into its own shared library (one nvcc
    per build, all at once); returns {label: path}."""
    from ..ops import _build
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for label, srcs in sorted(builds.items()):
        h.update(label.encode() + b"".join(s.encode() for s in
                                           srcs.values()))
    root = os.path.join(_build.BUILD_ROOT, f"l1-sync-{h.hexdigest()[:16]}")
    paths, cmds = {}, []
    for i, (label, srcs) in enumerate(builds.items()):
        d = os.path.join(root, str(i))
        paths[label] = os.path.join(d, "libqz_l1_sync.so")
        if os.path.exists(paths[label]):
            continue
        os.makedirs(d, exist_ok=True)
        for name, text in srcs.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     paths[label], os.path.join(d, "l1_kernels.cu")])
    _build._run(cmds)
    return paths


def _inputs(torch, tk, seed: int) -> dict:
    """Level 1's batch and what the chain makes of it, from the twins on
    the card: the blocks, ragged lengths, K1's keys (flip 0) and plane,
    the position-ordered pair rows and LDM rows (unsigned words)."""
    from ..corpus import make_corpus
    data = make_corpus(BATCH * BLOCK, seed)
    x = torch.from_numpy(np.frombuffer(data, np.uint8)
                         .reshape(BATCH, BLOCK).copy()).cuda()
    B, N = x.shape
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(0, N + 1, B).astype(np.int32)
    lengths[0] = N
    stride = tk.ldm_stride(SPAN, N)
    pbits = (WINDOW - 1).bit_length()
    key, plane = tk.hash_keys_winmin_sync_twin(x, WIDTH, WINDOW, stride)
    su = tk._sort_rows(tk.neighbor_unsort_keys_twin(
        tk._sort_rows(key), pbits, 1, WINDOW - 1))
    lk = tk.ldm_keys_twin(plane, SPAN, stride)
    su_l = tk._sort_rows(tk.neighbor_unsort_keys_twin(
        tk._sort_rows(lk), (lk.shape[1] - 1).bit_length(), 1))
    return {"x": x, "lengths": torch.from_numpy(lengths).cuda(),
            "stride": stride, "pbits": pbits, "key": key, "plane": plane,
            "su": su, "su_l": su_l}


def _entry(torch, lib, name):
    fn = getattr(lib, name)
    stream = torch.cuda.current_stream().cuda_stream

    def call(*a):
        rc = fn(*[t.data_ptr() if isinstance(t, torch.Tensor) else t
                  for t in a], stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return call


def _parent_cases(torch, tk, lib, d: dict) -> dict:
    """{(kernel, case): (fn, [(output, want)])} of the parent's entry
    points (flip 0, the full plane, K4 on _ldm_est's estimates)."""
    x, lengths, su, su_l = d["x"], d["lengths"], d["su"], d["su_l"]
    B, N = x.shape
    stride, pbits = d["stride"], d["pbits"]
    sign, flip = tk._SIGN, tk._FLIP
    k1 = _entry(torch, lib, "qz_hash_keys_winmin_sync")
    k2 = _entry(torch, lib, "qz_neighbor_unsort_keys")
    k3 = _entry(torch, lib, "qz_ldm_keys")
    k4 = _entry(torch, lib, "qz_compact_slots_sync")
    keys, plane = torch.empty_like(d["key"]), torch.empty_like(d["plane"])
    lk = torch.empty_like(su_l)
    lpbits = (su_l.shape[1] - 1).bit_length()
    slots = torch.empty((su.shape[0], WINDOW // 4), dtype=torch.int32,
                        device=x.device)
    est, off = tk._ldm_est(su_l, lengths, N, SPAN, MAX_OFF)
    spb = est.shape[1]
    k4_args = (B, N // 4, pbits, WIDTH)
    want0 = tk.compact_slots_sync_twin(su, WINDOW, lengths, WIDTH)
    want4 = tk.compact_slots_sync_twin(su, WINDOW, lengths, WIDTH, su_l,
                                       SPAN, max_off=MAX_OFF)

    def ldm_est_k4():
        e, o = tk._ldm_est(su_l, lengths, N, SPAN, MAX_OFF)
        k4(su, lengths, e, o, slots, *k4_args, spb)

    def chain():  # the parent's find_matches_positions(sync=True)
        k1(x, keys, plane, B, N, WIDTH, pbits, WINDOW - 1, stride)
        sk = tk._sort_signed(keys ^ sign)
        u = torch.empty_like(sk)
        k2(sk, u, sk.shape[0], sk.shape[1], pbits, 1, WINDOW - 1, flip)
        pair = tk._sort_signed(u) ^ sign
        k3(plane, lk, B // SPAN, N, stride, SPAN, lpbits, flip)
        slk = tk._sort_signed(lk)
        lu = torch.empty_like(slk)
        k2(slk, lu, slk.shape[0], slk.shape[1], lpbits, 1,
           slk.shape[1] - 1, flip)
        e, o = tk._ldm_est(tk._sort_signed(lu) ^ sign, lengths, N, SPAN,
                           MAX_OFF)
        k4(pair, lengths, e, o, slots, *k4_args, spb)

    return {
        ("K1", "stride 32, plane, flip 0x0"): (
            lambda: k1(x, keys, plane, B, N, WIDTH, pbits, WINDOW - 1,
                       stride), [(keys, d["key"]), (plane, d["plane"])]),
        ("K1", "stride 0, flip 0x0"): (
            lambda: k1(x, keys, None, B, N, WIDTH, pbits, WINDOW - 1, 0),
            [(keys, d["key"])]),
        ("K3", "span 4, plane at stride 32"): (
            lambda: k3(d["plane"], lk, B // SPAN, N, stride, SPAN, lpbits,
                       flip),
            [(lk, tk.ldm_keys_twin(d["plane"], SPAN, stride, flip))]),
        ("K4", "LDM span 0, flip 0x0"): (
            lambda: k4(su, lengths, None, None, slots, *k4_args, 0),
            [(slots, want0)]),
        ("K4", "LDM span 4: K4 on given estimates"): (
            lambda: k4(su, lengths, est, off, slots, *k4_args, spb),
            [(slots, want4)]),
        ("K4", "LDM span 4: _ldm_est + K4"): (ldm_est_k4, [(slots, want4)]),
        ("chain", "find_matches_positions(sync=True), LDM span 4"): (
            chain, [(slots, want4)]),
    }


def _csrc_cases(torch, tk, d: dict) -> dict:
    """{(kernel, case): (fn, [(output, want)])} through csrc's wrappers;
    the wants are the twins' words."""
    x, lengths, su, su_l = d["x"], d["lengths"], d["su"], d["su_l"]
    B, N = x.shape
    stride, sign, flip = d["stride"], tk._SIGN, tk._FLIP
    samples = d["plane"][:, ::stride].contiguous()
    out = {}
    for f in (flip, 0):
        for s, what in ((True, "samples"), (False, "plane")):
            out[("K1", f"stride {stride}, {what}, flip {f:#x}")] = (
                lambda f=f, s=s: tk.hash_keys_winmin_sync(
                    x, WIDTH, WINDOW, stride, flip=f, samples=s),
                (tk.hash_keys_winmin_sync_twin(x, WIDTH, WINDOW, stride, f,
                                               s)))
        out[("K1", f"stride 0, flip {f:#x}")] = (
            lambda f=f: tk.hash_keys_winmin_sync(x, WIDTH, WINDOW, 0,
                                                 flip=f),
            (tk.hash_keys_winmin_sync_twin(x, WIDTH, WINDOW, 0, f)[0],
             None))
    out[("K3", "span 4, samples at stride 1")] = (
        lambda: tk.ldm_keys(samples, SPAN, 1, flip=flip),
        (tk.ldm_keys_twin(samples, SPAN, 1, flip),))
    out[("K3", "span 4, plane at stride 32")] = (
        lambda: tk.ldm_keys(d["plane"], SPAN, stride, flip=flip),
        (tk.ldm_keys_twin(d["plane"], SPAN, stride, flip),))
    for span in (0, 4):
        want = tk.compact_slots_sync_twin(
            su, WINDOW, lengths, WIDTH, su_l if span else None, span,
            max_off=MAX_OFF)
        for f in (flip, 0):
            a, la = (su ^ sign, su_l ^ sign) if f else (su, su_l)
            out[("K4", f"LDM span {span}, flip {f:#x}")] = (
                lambda a=a, la=la, f=f, span=span: tk.compact_slots_sync(
                    a, WINDOW, lengths, WIDTH, la if span else None, span,
                    max_off=MAX_OFF, flip=f), (want,))
    out[("chain", "find_matches_positions(sync=True), LDM span 4")] = (
        lambda: tk.find_matches_positions(
            x, lengths, (WIDTH,), 1, WINDOW, SPAN, MAX_OFF, dense=True,
            sync=True),
        (out[("K4", "LDM span 4, flip 0x0")][1][0],))
    return out


def _design_cases(torch, tk, lib, kernel: str, d: dict, csrc: dict) -> dict:
    """A design build's K1 (samples, sign flip; plane, flip 0) or K4 (LDM
    spans 0 and 4, sign flip) through ctypes; the wants are csrc's
    words."""
    x, lengths, su, su_l = d["x"], d["lengths"], d["su"], d["su_l"]
    B, N = x.shape
    stride, pbits, flip = d["stride"], d["pbits"], tk._FLIP
    out = {}
    if kernel == "K1":
        k1 = _entry(torch, lib, "qz_hash_keys_winmin_sync")
        for what, s, f in (("samples", 1, flip), ("plane", 0, 0)):
            case = f"stride {stride}, {what}, flip {f:#x}"
            want = csrc[("K1", case)]
            keys, m = (torch.empty_like(t) for t in want)
            out[("K1", case)] = (
                lambda keys=keys, m=m, s=s, f=f: k1(
                    x, keys, m, None, B, N, WIDTH, pbits, WINDOW - 1, stride,
                    f, s), list(zip((keys, m), want)))
        return out
    k4 = _entry(torch, lib, "qz_compact_slots_sync")
    a, la = su ^ tk._SIGN, su_l ^ tk._SIGN
    spb = su_l.shape[1] // (2 * SPAN)
    lpbits = (su_l.shape[1] - 1).bit_length()
    for span in (0, 4):
        case = f"LDM span {span}, flip {flip:#x}"
        want = csrc[("K4", case)][0]
        slots = torch.empty_like(want)
        ldm = (la, SPAN, spb, lpbits, stride) if span else (None, 0, 0, 0, 0)
        out[("K4", case)] = (
            lambda slots=slots, ldm=ldm: k4(
                a, lengths, ldm[0], slots, B, N // 4, pbits, WIDTH, *ldm[1:],
                MAX_OFF, flip), [(slots, want)])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", help="root of a tree whose csrc/ has the "
                    "parent's K1-K4 entry points")
    ap.add_argument("--parent-only", action="store_true",
                    help="time the parent alone")
    ap.add_argument("--designs", default=",".join(DESIGNS),
                    help="comma-separated names of DESIGNS to build")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.parent_only and not args.parent:
        sys.exit("--parent-only needs --parent")
    from ..ops import _build
    from ..ops import glue_kernels as tk
    from .k2_k3 import stream_ms
    from .winmin import _load
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    designs = [] if args.parent_only else \
        [d for d in args.designs.split(",") if d]
    for d in designs:
        if d not in DESIGNS:
            raise SystemExit(f"no design {d!r}; designs: {list(DESIGNS)}")
    builds = {d: _sources(_build.CSRC, DESIGNS[d]) for d in designs}
    if args.parent:
        builds["parent"] = _sources(os.path.join(
            args.parent, "qat_zstd_plugin_tpu_torch", "csrc"))
    paths = _libraries(builds)
    data = _inputs(torch, tk, args.seed)

    def emit(design, cases, check):
        for (kernel, case), (fn, outs) in cases.items():
            if check:
                fn()
                torch.cuda.synchronize()
                for got, want in outs:
                    if not torch.equal(got, want):
                        raise SystemExit(f"{kernel} {design} ({case}) "
                                         "differs")
            print(json.dumps({"kernel": kernel, "case": case,
                              "design": design,
                              "stream_ms": stream_ms(torch, fn)}),
                  flush=True)

    order = []
    if args.parent:
        order.append(("parent", _parent_cases(
            torch, tk, _load(paths["parent"], OLD), data), True))
    csrc = {}
    if not args.parent_only:
        cases = _csrc_cases(torch, tk, data)
        for key, (fn, wants) in cases.items():
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            for g, w in zip(got, wants):
                if (g is None) != (w is None) or (
                        g is not None and not torch.equal(g, w)):
                    raise SystemExit(f"{key} csrc differs from its twin")
            csrc[key] = wants
        order.append(("csrc", {k: (fn, []) for k, (fn, _) in cases.items()},
                      False))
    runs = [(d, _design_cases(torch, tk, _load(paths[d], NEW),
                              DESIGNS[d][0], data, csrc), True)
            for d in designs]
    for design, cases, check in order + runs + order[::-1]:
        emit(design, cases, check)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
