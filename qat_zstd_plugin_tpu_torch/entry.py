"""One-call entry points of the port: the flagship device half at a fixed
shape, and a multi-rank dry run.

Counterpart of the JAX package's __graft_entry__.py. There, entry() hands
its caller the function to compile for the TPU and its inputs, and
dryrun_multichip(n) shards the compression step over a mesh of n
devices. Here:

    entry(device="cuda") -> (fn, (blocks, lengths))
        fn is level 1's device half (glue_kernels.find_matches_positions:
        widths (6,), window 32768, LDM spans of 4 blocks, dense slot
        claims, syncmer pair anchors: K1-K4) and (blocks, lengths) are 8
        blocks of 128 KiB of `_corpus` bytes on `device`;
    dryrun_multichip(n, device="cuda") -> report dict
        n spawned processes join a gloo group (tcp://127.0.0.1, a free
        port), each driving `device`: the sharded positions step at 4
        blocks a rank, a weak-scaling table (one rank against n, 4 blocks
        a rank), and compress_mesh frames at levels 1 and 9, each equal
        on every rank to GpuCodec(level, batch=B)'s frame byte for byte
        (B: the full blocks padded to a multiple of lcm(n, LDM span)) and
        decoding to the input through stock libzstd, or the port's own
        decoder where libzstd is absent.

`_corpus` is a copy of __graft_entry__._corpus (the same bytes for the
same arguments). On one card the n ranks share it: the scaling table
then measures the orchestration, not scaling.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import socket
import time
import traceback
from queue import Empty

import numpy as np
import torch

BLOCK = 131072  # the production block size
LDM_SPAN = 4  # level 1's LDM span, in blocks
RANK_BLOCKS = 4  # blocks a rank in the positions step: one LDM span
STEP_REPS = 3
FRAME_LEVELS = (1, 9)
TIMEOUT_S = 900


def _corpus(nbytes: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"the ", b"data ", b"zstd tpu ", b"frame ", b"entropy ",
             b"block ", b"offset ", b"mesh "]
    parts = []
    while sum(map(len, parts)) < nbytes:
        parts.append(b"".join(
            words[int(k)] for k in rng.integers(0, len(words), 2000)))
        parts.append(rng.integers(0, 32, 4000, np.uint8).tobytes())
    return b"".join(parts)[:nbytes]


def _positions(blocks, lengths):
    """Level 1's device half on (B, N) uint8 blocks and (B,) int32
    lengths: the (B*4, 8192) int32 slot words."""
    from .ops import glue_kernels
    return glue_kernels.find_matches_positions(
        blocks, lengths, widths=(6,), window=32768, ldm=LDM_SPAN,
        dense=True, sync=True)


def entry(device: str | torch.device = "cuda", batch: int = 8):
    """(fn, (blocks, lengths)): level 1's device half and `batch` blocks
    of 128 KiB of _corpus bytes (batch * 128 KiB of them) on `device`.
    "cuda" raises without a card; "cpu" gives the kernels' twins."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(dev)!r}: torch sees no CUDA device")
    data = _corpus(batch * BLOCK)
    blocks = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(
        batch, BLOCK).copy()).to(dev)
    lengths = torch.full((batch,), BLOCK, dtype=torch.int32, device=dev)
    return _positions, (blocks, lengths)


def mesh_batch(nfull: int, world: int, ldm: int) -> int:
    """compress_mesh's row count B, whose GpuCodec(batch=B) frame equals
    its frame: the full blocks padded to a multiple of lcm(world, LDM
    span) (the JAX package's parallel/pipeline.py:69-77)."""
    unit = math.lcm(world, ldm or 1)
    return max(unit, -(-nfull // unit) * unit)


def _frame_data(world: int) -> bytes:
    """The dry run's frame input: max(2, world) blocks of _corpus(seed=1)
    and 8192 random bytes (the reference's)."""
    rng = np.random.default_rng(0)
    return (_corpus(max(2, world) * BLOCK, seed=1)
            + rng.integers(0, 256, 8192, np.uint8).tobytes())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dryrun_rank(rank: int, world: int, init_method: str, device: str,
                 queue) -> None:
    """One rank of dryrun_multichip, in a spawned process. Puts ("done",
    rank, report) or ("error", rank, traceback) on `queue`."""
    import torch.distributed as dist
    try:
        from . import oracle
        from .parallel import distributed, mesh, pipeline
        from .runtime.gpu_codec import GpuCodec
        from .runtime.levels import TPU_LEVEL_TABLE
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
        distributed.init(init_method, world_size=world, rank=rank,
                         backend="gloo")
        m = mesh.make_mesh()
        report = {"rank": rank}

        # The positions step at production shapes, 4 blocks a rank.
        B = RANK_BLOCKS * world
        data = _corpus(B * BLOCK)
        blocks = np.frombuffer(data, np.uint8).reshape(B, BLOCK).copy()
        lengths = np.full(B, BLOCK, np.int32)
        step = mesh.sharded_positions_step(m, widths=(6,), window=32768,
                                           ldm=LDM_SPAN, device=dev)
        rows = slice(rank * RANK_BLOCKS, (rank + 1) * RANK_BLOCKS)
        out = step(blocks[rows], lengths[rows])
        want_shape = (RANK_BLOCKS * (BLOCK // 32768), 32768 // 4)
        if tuple(out.shape) != want_shape:
            raise AssertionError(f"slot words {tuple(out.shape)}, not "
                                 f"{want_shape}")
        claims = torch.tensor([int((out != -1).sum())])
        dist.all_reduce(claims)
        report["claims"] = int(claims)
        if report["claims"] <= 0:
            raise AssertionError("the positions step found no claims")

        # Weak scaling: ranks [0, k) each step their 4 blocks.
        def timed(k: int) -> float:
            dist.barrier()
            if rank < k:
                _sync(dev)
                step(blocks[rows], lengths[rows])  # warm
                _sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            if rank < k:
                for _ in range(STEP_REPS):
                    step(blocks[rows], lengths[rows])
                _sync(dev)
            dist.barrier()
            return (time.perf_counter() - t0) / STEP_REPS

        report["step_s"] = {1: timed(1), world: timed(world)}

        # compress_mesh frames, each equal to the one-process frame.
        fdata = _frame_data(world)
        report["frames"] = {}
        for level in FRAME_LEVELS:
            f = pipeline.compress_mesh(fdata, m, level=level, device=dev)
            nfull = len(fdata) // BLOCK
            batch = mesh_batch(nfull, world, TPU_LEVEL_TABLE[level].ldm)
            want = GpuCodec(level=level, batch=batch,
                            device=dev).compress(fdata)
            if f != want:
                raise AssertionError(f"level {level}: the mesh frame "
                                     f"differs from GpuCodec(batch={batch})'s")
            if oracle.available():
                decoded, by = oracle.decompress(f, len(fdata)), "libzstd"
            else:
                from . import decoder
                decoded, by = decoder.decompress(f), "decoder.py"
            if decoded != fdata:
                raise AssertionError(f"level {level}: the frame does not "
                                     f"decode to the input ({by})")
            report["frames"][level] = {"input_bytes": len(fdata),
                                       "frame_bytes": len(f),
                                       "batch": batch, "decoded_by": by}
        dist.barrier()
        queue.put(("done", rank, report))
    except Exception:
        queue.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # Reported: leave without the interpreter's teardown, where torch's
    # gloo threads can abort a finished process.
    queue.close()
    queue.join_thread()
    os._exit(0)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     timeout: float = TIMEOUT_S) -> dict:
    """Run the dry run in a world of `n_devices` gloo ranks (spawned
    processes), each driving `device`; print the reference's lines and
    return rank 0's report: claims (all ranks), step_s {1: s, n: s} a
    step, frames {level: sizes, batch, decoder}. Raises with the rank's
    traceback if a rank fails, or after `timeout` seconds."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(dev)!r}: torch sees no CUDA device")
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_dryrun_rank,
                         args=(r, n_devices, init_method, str(dev), queue))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    reports = {}
    try:
        deadline = time.monotonic() + timeout
        while len(reports) < n_devices:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"dryrun_multichip({n_devices}): no "
                                   f"result in {timeout} s")
            try:
                kind, rank, body = queue.get(timeout=min(left, 5.0))
            except Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"dryrun_multichip({n_devices}): a "
                                       f"rank exited with {dead[0]}")
                continue
            if kind == "error":
                raise RuntimeError(f"dryrun_multichip({n_devices}) rank "
                                   f"{rank} failed:\n{body}")
            reports[rank] = body
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    r0 = reports[0]
    if any(r["frames"] != r0["frames"] for r in reports.values()):
        raise AssertionError("ranks disagree on the frames")
    B = RANK_BLOCKS * n_devices
    print(f"dryrun_multichip({n_devices}, {dev}): positions step OK at "
          f"production shapes ({B} x {BLOCK >> 10} KiB) - {r0['claims']} "
          "claims")
    print(f"scaling (weak, {RANK_BLOCKS} blocks a rank):")
    for k, s in r0["step_s"].items():
        print(f"  n={k}: {s * 1e3:8.1f} ms/step   throughput "
              f"{RANK_BLOCKS * k * BLOCK / s / 1e6:7.1f} MB/s")
    for level, fr in r0["frames"].items():
        print(f"dryrun_multichip({n_devices}) L{level}: {fr['input_bytes']} "
              f"-> {fr['frame_bytes']} bytes, equal to GpuCodec(batch="
              f"{fr['batch']})'s, decoded by {fr['decoded_by']}")
    return r0
