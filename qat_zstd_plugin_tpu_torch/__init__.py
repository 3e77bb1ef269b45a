"""qat_zstd_plugin_tpu_torch — the PyTorch/CUDA port of qat_zstd_plugin_tpu.

The codec's twelve levels with their device half as hand-written CUDA
kernels for Hopper (csrc/) and PyTorch ops between them: level 1's
syncmer slot pipeline, the full-resolution dense hash pipeline of levels
2-4, and the exact-LCP content matcher with the greedy/lazy parse of
levels 5-12; with device entropy, the byte-verified hash matcher at
levels 1-4 and the FSE sequence sections on the device at every level,
and in full mode the Huffman literals sections too. The host half (claim
extension, gap fill, entropy coding; only the literals section in hybrid
mode; only the section wrapping in full mode) is the package's own build
of the native runtime (native/), and frame assembly is format.py. Every
Pallas kernel of the JAX package has a CUDA counterpart here, the three
that no level reaches included: compact_slots (the parsed hash branch,
ops.glue_kernels.find_matches_positions(dense=False)), compact_operands
(ops.glue_kernels.compact_fast_glue) and bitonic_sort
(ops.sort_kernel). The package imports neither jax nor
qat_zstd_plugin_tpu.

    compress(data, level=1..12, device="cuda", device_entropy=False)
        -> zstd frame (bytes), equal byte for byte to qat_zstd_plugin_tpu's
        TpuCodec frame at the same level, batch size and device_entropy
        (False, "hybrid" or True/"full"), except where the reference's
        own faults corrupt its frame (ROADMAP.md §C)
    decompress(frame)                       -> bytes (stock libzstd)
"""

from __future__ import annotations

import numpy as np
import torch

from .format import BLOCK_SIZE_MAX
from .oracle import decompress
from .runtime.device import Status, start_device, status, stop_device
from .runtime.gpu_codec import GpuCodec

__version__ = "0.5.0"

__all__ = ["BLOCK_SIZE_MAX", "GpuCodec", "Status", "compress", "decompress",
           "start_device", "status", "stop_device", "version"]


def version() -> str:
    return __version__


def compress(data: bytes | np.ndarray, level: int = 1,
             block_size: int = BLOCK_SIZE_MAX, checksum: bool = True,
             batch: int = 8, device: str | torch.device = "cuda",
             device_entropy: str | bool = False) -> bytes:
    """Compress to a complete zstd frame on `device`. "cuda" runs the CUDA
    kernels and raises when there is no CUDA device; "cpu" runs their
    plain-torch twins. There is no silent fallback between the two.
    device_entropy="hybrid" encodes the sequence sections on the device,
    True (or 1, or "full") the Huffman literals sections as well (see
    GpuCodec)."""
    codec = GpuCodec(level=level, batch=batch, block_size=block_size,
                     device=device, device_entropy=device_entropy)
    return codec.compress(data, checksum=checksum)
