"""K2 and K3 beside their rejected designs, on one CUDA device.

    python3 -m qat_zstd_plugin_tpu_torch.designs.k2_k3 [--seed S]

Run from the repository root on a machine with a CUDA device. It builds
designs/k2_k3.cu with nvcc into build/torch_kernels/designs-<key>/ and
times, over 20 back-to-back calls behind a 2 ms spin on the card (the
median of 5 runs, as chip_smoke.py's stream_ms), on the sign-flipped
inputs of the main path at level 1's shapes (B=128 blocks of 128 KiB of
the seeded corpus; B=64 for the second case of each):

  K2  csrc's kernel (neighbor_unsort_keys, flip: an 8-word window read
      from the row), tiles of 1024, 2048 and 4096 words staged in shared
      memory, and csrc's window with each claim behind a branch, on the
      pair rows at neighbors 1 and the full-resolution rows at
      neighbors 2; beside them a 16-byte copy kernel and torch's clone of
      the same bytes;
  K3  csrc's kernel (ldm_keys, flip: one sample a thread) and 4 and 8
      samples a thread, at span 4 (B=128 and B=64), 8 and 16 (B=64);
      beside them a kernel that copies each sample out once (K3's reads,
      half its writes) and torch's strided copy of the samples.

csrc's kernel runs first (through its wrapper, then through its entry
point on one output tensor) and again last in each case. Every design's
output must equal csrc's kernel's, or the run fails. It prints the card's
name and power limit, then one JSON object per timing.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np

BLOCK = 131072
WINDOW = 32768
SPIN_CYCLES = 4_000_000  # about 2 ms of the card's clock
K2_DESIGNS = {"staged tile 1024": 0, "staged tile 2048": 1,
              "staged tile 4096": 2, "window, claims behind branches": 3}
K3_DESIGNS = {"4 samples a thread": 0, "8 samples a thread": 1}


def _library() -> ctypes.CDLL:
    """designs/k2_k3.cu, built on first use (keyed by source and flags)."""
    from ..ops import _build
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "k2_k3.cu")
    flags = _build.NVCC_FLAGS
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    path = os.path.join(_build.BUILD_ROOT, f"designs-{key[:16]}",
                        "libqz_designs.so")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o",
                        path + ".tmp", src], check=True)
        os.replace(path + ".tmp", path)
    lib = ctypes.CDLL(path)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.qzd_k2.argtypes = [I, P, P, I, I, I, I, I, U, P]
    lib.qzd_k3.argtypes = [I, P, P, I, I, I, I, I, U, P]
    return lib


def stream_ms(torch, fn, calls: int = 20) -> float:
    """Milliseconds a call over `calls` back-to-back calls queued behind a
    2 ms spin, the median of 5 runs by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from ..corpus import make_corpus
    from ..ops import _build
    from ..ops import glue_kernels as tk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = _library()

    def emit(kernel, case, design, fn, equal=None):
        """equal: whether the design's output equals csrc's kernel's (None
        where the two compute different things)."""
        print(json.dumps({"kernel": kernel, "case": case, "design": design,
                          "stream_ms": stream_ms(torch, fn),
                          "equal": equal}), flush=True)
        if equal is False:
            raise SystemExit(f"{kernel} {design} ({case}) differs from csrc")

    def run(entry, *args):
        """entry(*args, stream), tensors as device pointers."""
        rc = entry(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                     for a in args], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{entry.__name__}: CUDA error {rc}")

    csrc = _build.load()

    data = make_corpus(128 * BLOCK, args.seed)
    blocks = torch.from_numpy(np.frombuffer(data, np.uint8)
                              .reshape(128, BLOCK).copy()).cuda()
    key, m = tk.hash_keys_winmin_sync(blocks, 6, WINDOW,
                                      tk.ldm_stride(4, BLOCK))
    flip = tk._FLIP
    pair = tk._sort_rows(key) ^ tk._SIGN
    full = tk._sort_rows(tk.hash_keys(blocks[:64].contiguous(), 4,
                                      WINDOW)) ^ tk._SIGN
    pbits = (WINDOW - 1).bit_length()
    for case, sk, nb, pmask in (("pair rows, neighbors 1", pair, 1,
                                 WINDOW - 1),
                                ("full-resolution rows, neighbors 2", full,
                                 2, WINDOW - 1)):
        port = lambda: tk.neighbor_unsort_keys(sk, pbits, nb, pmask,
                                               flip=flip)
        want = port()
        emit("K2", case, "csrc (window from the row)", port)
        out = torch.empty_like(sk)
        emit("K2", case, "csrc, its entry point on a fixed output",
             lambda: run(csrc.qz_neighbor_unsort_keys, sk, out, sk.shape[0],
                         sk.shape[1], pbits, nb, pmask, flip))
        for name, d in K2_DESIGNS.items():
            f = lambda: run(lib.qzd_k2, d, sk, out, sk.shape[0],
                            sk.shape[1], pbits, nb, pmask, flip)
            f()
            emit("K2", case, name, f, torch.equal(out, want))
        emit("K2", case, "copy kernel",
             lambda: run(lib.qzd_k2, 4, sk, out, sk.shape[0], sk.shape[1],
                         pbits, nb, pmask, flip))
        emit("K2", case, "torch clone", sk.clone)
        emit("K2", case, "csrc (again)", port)

    for case, minz, span in (("span 4, B=128", m, 4),
                             ("span 4, B=64", m[:64].contiguous(), 4),
                             ("span 8, B=64", m[:64].contiguous(), 8),
                             ("span 16, B=64", m[:64].contiguous(), 16)):
        stride = tk.ldm_stride(span, BLOCK)
        port = lambda: tk.ldm_keys(minz, span, stride, flip=flip)
        want = port()
        pb = (want.shape[1] - 1).bit_length()
        emit("K3", case, "csrc (one sample a thread)", port)
        out = torch.empty_like(want)
        emit("K3", case, "csrc, its entry point on a fixed output",
             lambda: run(csrc.qz_ldm_keys, minz, out, want.shape[0], BLOCK,
                         stride, span, pb, flip))
        for name, d in K3_DESIGNS.items():
            f = lambda: run(lib.qzd_k3, d, minz, out, want.shape[0], BLOCK,
                            stride, span, pb, flip)
            f()
            emit("K3", case, name, f, torch.equal(out, want))
        samples = torch.empty(minz.shape[0] * (BLOCK // stride),
                              dtype=torch.int32, device=minz.device)
        emit("K3", case, "gather kernel",
             lambda: run(lib.qzd_k3, 2, minz, samples, want.shape[0], BLOCK,
                         stride, span, pb, flip))
        emit("K3", case, "torch strided copy",
             lambda: minz[:, ::stride].contiguous())
        emit("K3", case, "csrc (again)", port)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
