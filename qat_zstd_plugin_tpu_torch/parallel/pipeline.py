"""End-to-end mesh compression: each rank's blocks through the device half
and the host entropy, ordered gather, one frame on every rank.

Port of qat_zstd_plugin_tpu.parallel.pipeline (`compress_mesh`), the
multi-card production shape (SURVEY §7.6): blocks are split over the
ranks of the "blocks" mesh (the reference's independent-instance model,
src/qatseqprod.c:601-630), each rank finishes the entropy of its own
blocks, and the ordered variable-size gather (parallel/distributed.py)
gives every rank every block's bytes in frame order.

The frame equals the reference's compress_mesh frame byte for byte at
every world size. The reference runs the device half under jit with
sharded inputs, not shard_map, so its result is the one-device result on
one batch: the full blocks, zero rows padding them to a multiple of
lcm(mesh size, LDM span). A row's output depends on its own LDM span and
the one before it (K3's rows are [previous span | this span]), so here
whole spans go to ranks, and a rank whose first span is not span 0 runs
the device half with the previous span's rows in front as context and
drops their outputs. The input is replicated on every rank, so that
context needs no collective. The batch's rows past the last span that
holds a full block are whole spans of zeros whose outputs the reference
drops and no other span reads; they are not run.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..format import BLOCK_SIZE_MAX, assemble_frame
from ..runtime.gpu_codec import GpuCodec
from . import distributed
from .mesh import make_mesh

BLOCK = BLOCK_SIZE_MAX
# Input rows of one device call, its context span excluded: a call's host
# unpack overlaps the host half of the one before. On an H100 8 MiB was
# the fastest of 64, 32, 16 and 8 at levels 1 and 9 and within 11% of
# 16 MiB at level 4 (designs/mesh_calls.py).
CALL_BYTES = 8 << 20


def compress_mesh(data: bytes | np.ndarray, mesh=None, level: int = 1,
                  checksum: bool = True, max_seq: int = 16384,
                  block_size: int = BLOCK,
                  device: str | torch.device = "cuda") -> bytes:
    """Compress `data` to one zstd frame with its blocks split over the
    ranks of `mesh` (make_mesh() when None).

    Every rank must call this with the same data (the input is
    replicated, like a data-parallel step's batch); each rank runs the
    device half and the host entropy of its own spans of blocks, and the
    gather gives every rank the same frame. Host entropy only, as in the
    reference; "cuda" raises without a card, "cpu" runs the twins."""
    return _compress_mesh(data, mesh, level, checksum, max_seq, block_size,
                          device, None)


def _compress_mesh(data, mesh, level: int, checksum: bool, max_seq: int,
                   block_size: int, device, call_spans: int | None
                   ) -> bytes:
    """compress_mesh with `call_spans` LDM spans a device call (None: as
    many as CALL_BYTES of rows hold, at least one)."""
    if mesh is None:
        mesh = make_mesh()
    codec = GpuCodec(level=level, block_size=block_size, max_seq=max_seq,
                     device=device, device_entropy=False)
    buf = np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data, np.uint8)
    n = len(buf)
    bs = block_size
    nblocks = max(1, -(-n // bs))
    nfull = n // bs  # the device takes full blocks only
    span = codec.params.ldm or 1
    nspans = -(-nfull // span)
    world, rank = mesh.size(), mesh.get_local_rank()
    mine = range(rank * nspans // world, (rank + 1) * nspans // world)
    if call_spans is None:
        call_spans = max(1, CALL_BYTES // (span * bs))
    # The reference's window for the mesh path (pipeline.py:79).
    run = codec.device_half(min(codec.params.window, bs))

    def launch(first: int, stop: int):
        """Device half of spans [first, stop) behind one context span."""
        lo = first * span - (span if first and codec.params.ldm else 0)
        hi = stop * span
        blocks = np.zeros((hi - lo, bs), np.uint8)
        real = min(hi, nfull) - lo
        blocks[:real] = buf[lo * bs:(lo + real) * bs].reshape(real, bs)
        lengths = np.zeros(hi - lo, np.int32)
        lengths[:real] = bs
        out = run(torch.from_numpy(blocks).to(codec.device),
                  torch.from_numpy(lengths).to(codec.device))
        return lo, first * span, lengths, out

    bodies: dict[int, bytes | None] = {}
    with ThreadPoolExecutor() as pool:
        futures = {}

        def collect(handle) -> None:
            lo, keep, lengths, out = handle
            seqs = codec.host_sequences(out, lengths)
            for i in range(keep, min(lo + len(lengths), nfull)):
                futures[i] = pool.submit(codec.finish_block_host, buf, i,
                                         seqs[i - lo])

        pending = None
        for first in range(mine.start, mine.stop, call_spans):
            handle = launch(first, min(first + call_spans, mine.stop))
            if pending is not None:
                collect(pending)  # while the card runs the next call
            pending = handle
        if pending is not None:
            collect(pending)
        for i, f in futures.items():
            bodies[i] = f.result()

    # Ordered gather of the compressed bodies (size -1 = raw fallback).
    local = sorted(bodies)
    padded = np.zeros((len(local), bs), np.uint8)
    sizes = np.full(len(local), -1, np.int32)
    for k, i in enumerate(local):
        b = bodies[i]
        if b is not None and len(b) <= bs:
            padded[k, :len(b)] = np.frombuffer(b, np.uint8)
            sizes[k] = len(b)
    all_p, all_s, all_i = distributed.gather_rows(
        mesh, padded, sizes, np.asarray(local, np.int32))
    body_list: list[bytes | None] = [None] * nblocks
    for k in range(len(all_i)):
        if all_s[k] >= 0:
            body_list[int(all_i[k])] = all_p[k, :all_s[k]].tobytes()
    # The tail block and the raw-fallback ones finish here, identically on
    # every rank: the input is replicated and the host matcher
    # deterministic, so the frames agree.
    for i in range(nblocks):
        if body_list[i] is None:
            body_list[i] = codec.finish_block_host(buf, i, None)
    return assemble_frame(buf, body_list, bs, checksum,
                          window_log=codec.host.window_log)
