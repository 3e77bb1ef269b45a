"""Match-finding entry point of the port and the host unpack of its output.

Port of the segment-slots part of qat_zstd_plugin_tpu.ops.match_pipeline
(`find_matches_positions`, `unpack_segments`). The reference module
imports jax at the top, so the numpy unpack is repeated here rather than
imported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import glue_kernels


def find_matches_positions(blocks: torch.Tensor, lengths: torch.Tensor,
                           widths: tuple = (6,), neighbors: int = 1,
                           window: int = 32768, ldm: int = 0,
                           ldm_max_off: int = 1 << 19, dense: bool = True,
                           sync: bool = False) -> torch.Tensor:
    """Hash-matcher pipeline of levels 1-4, segment-slots contract (see
    glue_kernels.find_matches_positions). LDM spans tile the batch, so a
    batch that is not a whole number of spans runs without LDM."""
    if ldm and blocks.shape[0] % ldm:
        ldm = 0  # spans need whole block groups; partial batches skip LDM
    return glue_kernels.find_matches_positions(
        blocks, lengths, widths=tuple(widths), neighbors=neighbors,
        window=window, ldm=ldm, ldm_max_off=ldm_max_off, dense=dense,
        sync=sync)


def unpack_segments(slot_keys: np.ndarray, nblocks: int, window: int
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Host-side unpack of the segment-slots contract.

    slot_keys: (nblocks*nseg, w/4) u32; slot i of a row holds that 4-byte
    slot's claim as (subslot_k << 30 | byte_offset), the claim position
    being 4*i + k, or the empty sentinel 0xFFFFFFFF. Slot index is
    position order and segments tile the block, so a row-major
    mask-select yields claims in block-position order. Returns per block
    (positions, offsets)."""
    sk = np.asarray(slot_keys)
    R, ws = sk.shape
    nseg = R // nblocks
    w = ws * 4
    rows, cols = np.nonzero(sk != np.uint32(0xFFFFFFFF))
    vals = sk[rows, cols]
    pos = (cols.astype(np.int64) * 4 + (vals >> 30)
           + (rows.astype(np.int64) % nseg) * w)
    off = (vals & 0x3FFFFFFF).astype(np.int64)
    counts = np.bincount(rows // nseg, minlength=nblocks)
    splits = np.cumsum(counts)[:-1]
    return list(zip(np.split(pos, splits), np.split(off, splits)))
