"""Block parallelism over a 1-D "blocks" mesh of ranks: the scale-out axis
of the codec.

Port of qat_zstd_plugin_tpu.parallel.mesh (`AXIS`, `make_mesh`,
`sharded_pipeline`, `sharded_positions_step`, `compression_step`). The
reference's only parallelism is data
parallelism over independent 128 KiB blocks: app threads round-robin
over up to 64 QAT DC instances (src/qatseqprod.c:601-630, README.md:
138-178). Here each rank is one process on one card; blocks are split
over the ranks of a torch.distributed DeviceMesh, and compressed sizes
ride an ordered all-gather (parallel/distributed.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops import glue_kernels, match_pipeline

AXIS = "blocks"


class LocalMesh:
    """A world of one without torch.distributed: the part of a
    DeviceMesh's interface the port reads (size, local rank, group)."""

    def size(self, mesh_dim: int | None = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim: int | None = None) -> int:
        return 0

    def get_group(self, mesh_dim: int | None = None):
        return None


def make_mesh():
    """1-D "blocks" DeviceMesh over the default process group, or a
    LocalMesh when torch.distributed is not initialised. A WORLD_SIZE
    above one with no process group raises: each process would otherwise
    compress the whole input alone."""
    if dist.is_available() and dist.is_initialized():
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        from torch.distributed.device_mesh import DeviceMesh
        return DeviceMesh(device_type, torch.arange(dist.get_world_size()),
                          mesh_dim_names=(AXIS,))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(f"WORLD_SIZE={world} but torch.distributed is "
                           "not initialised: call parallel.distributed."
                           "init() first")
    return LocalMesh()


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(dev)!r}: torch sees no CUDA device")
    return dev


def sharded_pipeline(mesh, neighbors: int = 4, max_seq: int = 16384,
                     lazy: bool = False, window: int = 1 << 30,
                     device: str | torch.device = "cuda"):
    """The content pipeline (match_pipeline.find_matches_staged at stride
    1: candidates, the parse B10, compact) on this rank's shard of the
    "blocks" axis. Returns fn(local_blocks, local_lengths) -> compact's
    dict on `device`, the rows of this rank's shard of the reference's
    sharded output: each rank runs the same program on its own rows with
    no collective (the reference's share-nothing instances). `mesh` is
    the mesh whose shard the caller passes; the function reads nothing of
    it."""
    dev = _device(device)

    def fn(local_blocks, local_lengths) -> dict:
        return match_pipeline.find_matches_staged(
            torch.as_tensor(local_blocks).to(dev),
            torch.as_tensor(local_lengths).to(dev), neighbors=neighbors,
            max_seq=max_seq, lazy=lazy, window=window)

    return fn


def compression_step(mesh, neighbors: int = 4, max_seq: int = 16384,
                     device: str | torch.device = "cuda"):
    """sharded_pipeline, then every block's nseq and last_literals in
    block order on every rank (reference: mesh.compression_step, the
    multi-chip dryrun's step). Returns step(local_blocks, local_lengths)
    -> (this rank's dict, stats), stats holding nseq_all and
    last_literals_all ((total blocks,) int32, rank 0's rows first) and
    total_sequences (an int32 scalar), all on `device`. Ranks may hold
    different row counts: the gather is parallel.distributed.gather_rows,
    the ordered ragged all-gather; a LocalMesh needs no collective."""
    from .distributed import gather_rows  # it imports this module
    pipeline = sharded_pipeline(mesh, neighbors, max_seq, device=device)

    def step(local_blocks, local_lengths):
        out = pipeline(local_blocks, local_lengths)
        pairs = torch.stack([out["nseq"], out["last_literals"]], 1)
        rows = pairs.to(torch.int32).cpu().numpy()
        n = len(rows)
        got, _, _ = gather_rows(mesh, rows.view(np.uint8),
                                np.zeros(n, np.int32),
                                np.arange(n, dtype=np.int32))
        both = torch.from_numpy(np.ascontiguousarray(got).view(np.int32)
                                .reshape(-1, 2)).to(pairs.device)
        stats = {"nseq_all": both[:, 0].contiguous(),
                 "last_literals_all": both[:, 1].contiguous(),
                 "total_sequences": both[:, 0].sum(dtype=torch.int32)}
        return out, stats

    return step


def sharded_positions_step(mesh, widths: tuple = (6,), window: int = 32768,
                           ldm: int = 4, sync: bool = True,
                           device: str | torch.device = "cuda"):
    """The fast-level pipeline (hash matcher + minimizer LDM + dense slot
    contract, glue_kernels.find_matches_positions) on this rank's shard.

    Returns fn(local_blocks, local_lengths) -> slot words on `device`,
    the rows of this rank's shard of the reference's shard_map output:
    each rank runs the same program on its own rows with no collective,
    and LDM span context slides within a shard only (the first span of
    every shard sees empty context, like the first span of a batch).
    `mesh` is the mesh whose shard the caller passes; the function reads
    nothing of it."""
    dev = _device(device)

    def fn(local_blocks, local_lengths) -> torch.Tensor:
        return glue_kernels.find_matches_positions(
            torch.as_tensor(local_blocks).to(dev),
            torch.as_tensor(local_lengths).to(dev), widths=widths,
            window=window, ldm=ldm, dense=True, sync=sync)

    return fn
