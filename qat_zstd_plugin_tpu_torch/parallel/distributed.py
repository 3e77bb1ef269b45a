"""Scale-out over torch.distributed: process-group init and the ordered
gather of compressed blocks.

Port of qat_zstd_plugin_tpu.parallel.distributed (`init`, `pad_blocks`,
`gather_compressed`, `gather_rows`). The reference is single-host (its
"interconnect" is PCIe DMA rings, SURVEY §5); the port runs one process
per card:

* `init()` joins the default process group (NCCL across cards, gloo on
  the CPU or for ranks that share one card);
* blocks are split over the ranks of a 1-D "blocks" mesh
  (parallel/mesh.py, parallel/pipeline.py);
* `gather_rows()` is the ordered, ragged collect: every rank holds its
  own rows (there is no global array as in JAX), so the row counts are
  all-gathered first, each rank pads its rows to the largest count with
  id -1, the rows are all-gathered, and the -1 rows dropped. Every rank
  returns every rank's rows, in rank order.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh


def init(init_method: str | None = None, world_size: int | None = None,
         rank: int | None = None, backend: str | None = None) -> None:
    """Join the default process group; nothing for a world of one or less.

    world_size and rank default to WORLD_SIZE and RANK (torchrun sets
    both), init_method to torch's "env://" (MASTER_ADDR, MASTER_PORT),
    backend to "nccl" when CUDA is present and "gloo" otherwise. Under
    NCCL each rank takes the card LOCAL_RANK (else rank modulo the cards
    it sees) as its current device."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def pad_blocks(bodies: list[bytes], bound: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Size-prefix representation: (n, bound) uint8 padded + (n,) sizes."""
    n = len(bodies)
    out = np.zeros((n, bound), np.uint8)
    sizes = np.zeros((n,), np.int32)
    for i, b in enumerate(bodies):
        if len(b) > bound:
            raise ValueError(f"body of {len(b)} bytes over bound {bound}")
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
        sizes[i] = len(b)
    return out, sizes


def gather_compressed(mesh, padded: np.ndarray, sizes: np.ndarray
                      ) -> list[bytes]:
    """Ordered all-gather of each rank's compressed blocks: the exact bytes
    of every rank's rows, rank 0's first, each rank's in its order
    (identical on every rank)."""
    gp, gs, _ = gather_rows(mesh, padded, sizes,
                            np.arange(len(sizes), dtype=np.int32))
    return [gp[i, :gs[i]].tobytes() for i in range(len(gs))]


def gather_rows(mesh, padded: np.ndarray, sizes: np.ndarray,
                ids: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All-gather each rank's (padded, sizes, ids) rows; every rank
    returns the union, rank 0's rows first. The counts may differ (a rank
    may hold none). Without a process group (a world of one, `mesh` from
    make_mesh with torch.distributed not initialised) the rows come back
    as given. Under NCCL the rows travel on the rank's current card,
    under gloo on the CPU."""
    group = (mesh if mesh is not None else make_mesh()).get_group()
    if group is None:
        return padded, sizes, ids
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    world = dist.get_world_size(group)
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(ids)], device=dev),
                    group=group)
    m = max(int(c.item()) for c in counts)
    bound = padded.shape[1]
    rows = np.zeros((m, bound), np.uint8)
    rows[:len(ids)] = padded
    meta = np.full((m, 2), -1, np.int32)  # (size, id); id -1 is padding
    meta[:len(ids), 0] = sizes
    meta[:len(ids), 1] = ids
    out = []
    for local in (rows, meta):
        t = torch.from_numpy(local).to(dev)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        out.append(torch.cat(parts).cpu().numpy())
    gp, gmeta = out
    keep = gmeta[:, 1] >= 0
    return gp[keep], gmeta[keep, 0], gmeta[keep, 1]
