"""Host-side closing of a device-packed backward bitstream (numpy).

Copy of qat_zstd_plugin_tpu.ops.bitpack.backward_stream_bytes. The
sort-based device packer of that module is not ported: ops/bitconcat.py
replaced it on the device-entropy paths.
"""

from __future__ import annotations

import numpy as np


def backward_stream_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """One block's packed little-endian u32 words -> the closed backward
    stream bytes (the sentinel '1' bit, then zero padding to a byte); the
    words hold every item up to, not including, the sentinel."""
    nbytes_full = (total_bits + 7) // 8
    raw = np.ascontiguousarray(words).view(np.uint8)[:nbytes_full + 1]
    out = bytearray(raw[:nbytes_full])
    used = total_bits & 7
    if used == 0:
        out.append(1)
    else:
        out[-1] |= 1 << used
    return bytes(out)
