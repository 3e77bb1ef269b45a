#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
checks each against its plain-torch twin, drives the level-1 main path
end to end and checks the frame with stock libzstd.

    python3 chip_smoke.py [--seed S] [--mb 64]

Run from the repository root on a machine with one CUDA device. Phases
(each raises on failure; nothing is caught):

  1. card and build: the card's name and power limit, the nvcc build of
     qat_zstd_plugin_tpu_torch/csrc/ and the native host runtime;
  2. kernel vs twin: each of the four kernels against its plain-torch twin
     on the card at the main path's shapes (B=128 blocks of 128 KiB),
     exactly equal, with median CUDA-event times of both;
  3. device half: find_matches_positions(sync=True) slot words from the
     kernels on the card against the twins on the CPU, at B=128 (LDM on)
     and B=6 (a batch that is no whole number of LDM spans: LDM off);
  4. main path: qat_zstd_plugin_tpu_torch.compress(level=1, batch=128,
     device="cuda") on a --mb MiB corpus plus a 5000-byte tail, decoded
     bit-exactly; every kernel must have launched, no batch or block may
     have fallen back to the CPU matcher;
  5. port on card vs port on CPU: 1 MiB + tail at batch 8, frames equal.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Exits non-zero without a result
when there is no CUDA device or the port is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BLOCK = 131072
BATCH = 128  # bench.py's L1 headline batch
TAIL = 5000
SOURCE = "qat_zstd_plugin_tpu_torch/csrc/l1_kernels.cu"
# Each CUDA kernel and the Pallas kernel it replaces.
REPLACES = {
    "hash_keys_winmin_sync": "qat_zstd_plugin_tpu/ops/glue_kernels.py:192",
    "neighbor_unsort_keys": "qat_zstd_plugin_tpu/ops/glue_kernels.py:490",
    "ldm_keys": "qat_zstd_plugin_tpu/ops/glue_kernels.py:1127",
    "compact_slots_sync": "qat_zstd_plugin_tpu/ops/glue_kernels.py:1379",
}
def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def exact(torch, got, want, what: str) -> int:
    """Max |got - want| over the u32 words; raises unless 0."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"{what}: kernel differs from twin "
                             f"(max abs err {err})")
    return err


def kernels_vs_twins(torch, tk, blocks_np: np.ndarray, seed: int) -> dict:
    """Phase 2: each kernel against its twin on the card, with times."""
    from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 1)
    B, N = blocks_np.shape
    window, width, span = 32768, 6, 4
    stride = tk.ldm_stride(span, N)
    pbits = (window - 1).bit_length()
    blocks = torch.from_numpy(blocks_np).to(dev)
    rand = torch.from_numpy(rng.integers(0, 256, (B, N), np.uint8)).to(dev)
    ragged = torch.from_numpy(
        rng.integers(0, N + 1, B).astype(np.int32)).to(dev)
    ragged[0] = N
    results = {}

    def record(name, err, kernel_fn, twin_fn):
        results[name] = {"max_abs_err": err, "ms": cuda_ms(kernel_fn),
                         "plain_ms": cuda_ms(twin_fn)}

    # K1 on the corpus and on random bytes.
    err = 0
    for x in (rand, blocks):
        k, m = tk.hash_keys_winmin_sync(x, width, window, stride)
        tw_k, tw_m = tk.hash_keys_winmin_sync_twin(x, width, window, stride)
        err = max(err, exact(torch, k, tw_k, "hash_keys_winmin_sync keys"),
                  exact(torch, m, tw_m, "hash_keys_winmin_sync minz"))
    record("hash_keys_winmin_sync", err,
           lambda: tk.hash_keys_winmin_sync(blocks, width, window, stride),
           lambda: tk.hash_keys_winmin_sync_twin(blocks, width, window,
                                                 stride))

    # K2 on the sorted pair rows and on the sorted LDM rows.
    sk = tk._sort_rows(k)
    lk = tk.ldm_keys(m, span, stride)
    slk = tk._sort_rows(lk)
    lbits = (lk.shape[1] - 1).bit_length()
    err = max(
        exact(torch, tk.neighbor_unsort_keys(sk, pbits, 1, window - 1),
              tk.neighbor_unsort_keys_twin(sk, pbits, 1, window - 1),
              "neighbor_unsort_keys (pair rows)"),
        exact(torch, tk.neighbor_unsort_keys(slk, lbits, 1),
              tk.neighbor_unsort_keys_twin(slk, lbits, 1),
              "neighbor_unsort_keys (LDM rows)"))
    record("neighbor_unsort_keys", err,
           lambda: tk.neighbor_unsort_keys(sk, pbits, 1, window - 1),
           lambda: tk.neighbor_unsort_keys_twin(sk, pbits, 1, window - 1))

    # K3 on the corpus's minimizer plane.
    err = exact(torch, lk, tk.ldm_keys_twin(m, span, stride), "ldm_keys")
    record("ldm_keys", err, lambda: tk.ldm_keys(m, span, stride),
           lambda: tk.ldm_keys_twin(m, span, stride))

    # K4 with ragged lengths, with and without LDM estimates.
    su = tk._sort_rows(tk.neighbor_unsort_keys(sk, pbits, 1, window - 1))
    su_l = tk._sort_rows(tk.neighbor_unsort_keys(slk, lbits, 1))
    est, off = tk._ldm_est(su_l, ragged, N, span, 1 << 19)
    err = max(
        exact(torch, tk.compact_slots_sync(su, window, ragged, width, est,
                                           off),
              tk.compact_slots_sync_twin(su, window, ragged, width, est, off),
              "compact_slots_sync (LDM)"),
        exact(torch, tk.compact_slots_sync(su, window, ragged, width),
              tk.compact_slots_sync_twin(su, window, ragged, width),
              "compact_slots_sync"))
    record("compact_slots_sync", err,
           lambda: tk.compact_slots_sync(su, window, ragged, width, est, off),
           lambda: tk.compact_slots_sync_twin(su, window, ragged, width,
                                              est, off))
    torch.cuda.synchronize()
    return results


def device_half(torch, mp, blocks_np: np.ndarray, lengths_np: np.ndarray,
                ldm: int) -> tuple[int, float]:
    """Phase 3: the composed slot words, kernels on the card vs twins on
    the CPU. Returns the number of claimed slots and the median time of
    the kernels' composition on the card, input already on the card."""
    from qat_zstd_plugin_tpu_torch.profile_l1 import cuda_ms
    kw = dict(window=32768, ldm=ldm, ldm_max_off=1 << 19, width=6)
    dev = torch.device("cuda")
    blocks = torch.from_numpy(blocks_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    got = mp.find_matches_positions(blocks, lengths, **kw).cpu()
    want = mp.find_matches_positions(torch.from_numpy(blocks_np),
                                     torch.from_numpy(lengths_np), **kw)
    exact(torch, got, want, f"find_matches_positions B={len(blocks_np)}")
    ms = cuda_ms(lambda: mp.find_matches_positions(blocks, lengths, **kw))
    return int((got != -1).sum()), ms


def decode(data: bytes, frame: bytes, level: int) -> str:
    """Bit-exact decode through stock libzstd; without it, a 4 MiB prefix
    frame through the in-repo golden decoder. Returns the decoder used."""
    from qat_zstd_plugin_tpu import oracle
    if oracle.available():
        if oracle.decompress(frame, len(data)) != data:
            raise AssertionError("libzstd decode differs from the input")
        return "libzstd"
    import qat_zstd_plugin_tpu_torch as qzt
    from qat_zstd_plugin_tpu.golden import decoder
    prefix = data[:4 << 20]
    small = qzt.compress(prefix, level=level, batch=BATCH, device="cuda")
    if decoder.decompress(small, max_output=len(prefix)) != prefix:
        raise AssertionError("golden decode differs from the input")
    return "golden (4 MiB prefix)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mb", type=int, default=64,
                    help="main-path corpus size in MiB (plus a tail)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "qat_zstd_plugin_tpu_torch")):
        print("chip_smoke: run from the repository root (the port is not "
              "beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import qat_zstd_plugin_tpu_torch as qzt
    from qat_zstd_plugin_tpu import native
    from qat_zstd_plugin_tpu_torch.corpus import make_corpus
    from qat_zstd_plugin_tpu_torch.ops import _build
    from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
    from qat_zstd_plugin_tpu_torch.ops import match_pipeline as mp
    from qat_zstd_plugin_tpu_torch.profile_l1 import card_line

    # 1. Card and build.
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load()
    phase("build", library=os.path.relpath(_build.library_path(), root),
          nvcc_s=_build.build_seconds,
          load_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("native host runtime did not build")
    phase("native", load_s=time.perf_counter() - t0)

    # 2. Kernel vs twin at the main path's shapes.
    corpus = make_corpus((args.mb << 20) + TAIL, args.seed)
    blocks_np = np.frombuffer(corpus[:BATCH * BLOCK], np.uint8) \
        .reshape(BATCH, BLOCK).copy()
    kernels = kernels_vs_twins(torch, tk, blocks_np, args.seed)
    for name, r in kernels.items():
        phase("kernel_vs_twin", kernel=name, **r)

    # 3. Device half: slot words, kernels vs twins.
    full = np.full(BATCH, BLOCK, np.int32)
    n128, ms128 = device_half(torch, mp, blocks_np, full, ldm=4)
    n6, ms6 = device_half(torch, mp, blocks_np[:6].copy(), full[:6].copy(),
                          ldm=4)
    phase("device_half", equal=True, claims_b128_ldm4=n128,
          claims_b6_ldm0=n6, ms_b128=ms128, ms_b6=ms6,
          mbs_b128=BATCH * BLOCK / ms128 / 1e3)

    # 4. Main path on the card.
    qzt.compress(corpus[:BLOCK + TAIL], level=1, batch=BATCH,
                 device="cuda")  # warm-up: CUDA context, allocator, build
    torch.cuda.synchronize()
    codec = qzt.GpuCodec(level=1, batch=BATCH, device="cuda")
    tk.reset_launches()
    t0 = time.perf_counter()
    frame = codec.compress(corpus)
    seconds = time.perf_counter() - t0
    launches = dict(tk.launches)
    used = decode(corpus, frame, 1)
    phase("main_path", input_bytes=len(corpus), frame_bytes=len(frame),
          ratio=len(frame) / len(corpus), seconds=seconds,
          e2e_mbs=len(corpus) / seconds / 1e6, decoder=used,
          device_blocks=codec.device_blocks,
          fallback_batches=codec.fallback_batches,
          fallback_blocks=codec.stats.fallback_blocks, launches=launches)
    if codec.fallback_batches or codec.stats.fallback_blocks:
        raise AssertionError("the main path fell back to the CPU matcher")
    if codec.device_blocks != len(corpus) // BLOCK:
        raise AssertionError(f"device produced {codec.device_blocks} blocks")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # 5. Port on card vs port on CPU.
    small = corpus[:8 * BLOCK + TAIL]
    on_card = qzt.compress(small, level=1, batch=8, device="cuda")
    on_cpu = qzt.compress(small, level=1, batch=8, device="cpu")
    if on_card != on_cpu:
        raise AssertionError("frames differ between device='cuda' and "
                             "device='cpu'")
    phase("card_vs_cpu", equal=True, frame_bytes=len(on_card))

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name], **r}
        for name, r in kernels.items()]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
