"""Streaming compression: one frame fed chunk by chunk.

Copy of qat_zstd_plugin_tpu.runtime.stream (`_stream_frame_header` and
`StreamCompressor`) on GpuCodec. A stream is one zstd frame whose full
128 KiB blocks go through the device half as they fill; each chunk's
blocks see only that chunk's full blocks as cross-block context, and the
short tail block is matched on the host at finish(). The header omits
the content size (unknown up front) and declares the level's window; the
content checksum is the native runtime's incremental XXH64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..format import (BLOCK_RAW, BLOCK_SIZE_MAX, MAGIC, MIN_WINDOW_LOG,
                      block_header, emit_block)
from .gpu_codec import GpuCodec


def _stream_frame_header(window_log: int, checksum: bool) -> bytes:
    out = bytearray(MAGIC.to_bytes(4, "little"))
    out.append((1 << 2) if checksum else 0)  # no FCS, no dictionary
    out.append((window_log - 10) << 3)
    return bytes(out)


class StreamCompressor:
    """Chunk-fed compressor emitting one frame; full blocks ride the
    device half in batches of `batch` as they fill."""

    def __init__(self, level: int = 1, block_size: int = BLOCK_SIZE_MAX,
                 checksum: bool = True, batch: int = 8,
                 device: str | torch.device = "cuda"):
        self.codec = GpuCodec(level=level, batch=batch,
                              block_size=block_size, device=device)
        self.block_size = block_size
        self.checksum = checksum
        self._buf = bytearray()
        self._started = False
        self._finished = False
        self._hash = native.Xxh64Stream() if checksum else None
        self.blocks_emitted = 0  # the resumable block cursor

    def _header(self) -> bytes:
        # The window must cover the largest offset a block can take:
        # compress_bodies gives blocks cross-block context up to the
        # level's window, not just the block size (an under-declared
        # window decodes wrong bytes under streaming decoders).
        wlog = max(MIN_WINDOW_LOG, self.codec.host.window_log)
        return _stream_frame_header(wlog, self.checksum)

    def _emit_blocks(self, data: np.ndarray, last: bool) -> bytes:
        """Compress the full blocks of `data` (and its tail if last) and
        return their block bytes."""
        n = len(data)
        bs = self.block_size
        if n == 0:  # only at finish(): one raw empty block ends the frame
            self.blocks_emitted += 1
            return block_header(True, BLOCK_RAW, 0)
        nblocks = -(-n // bs)
        bodies = self.codec.compress_bodies(
            data, frame_start=self.blocks_emitted == 0)
        out = bytearray()
        for i in range(nblocks):
            out += emit_block(data[i * bs:min((i + 1) * bs, n)], bodies[i],
                              last=last and i == nblocks - 1)
            self.blocks_emitted += 1
        return bytes(out)

    def compress(self, chunk: bytes) -> bytes:
        """Feed a chunk; returns any frame bytes ready to flush."""
        assert not self._finished, "stream already finished"
        out = bytearray()
        if not self._started:
            out += self._header()
            self._started = True
        self._buf += chunk
        if self._hash is not None:
            self._hash.update(chunk)
        bs = self.block_size
        nfull = len(self._buf) // bs
        if nfull:
            data = np.frombuffer(bytes(self._buf[:nfull * bs]), np.uint8)
            out += self._emit_blocks(data, last=False)
            del self._buf[:nfull * bs]
        return bytes(out)

    def finish(self) -> bytes:
        """Flush the tail block, close the frame (+ checksum)."""
        assert not self._finished
        out = bytearray()
        if not self._started:
            out += self._header()
            self._started = True
        data = np.frombuffer(bytes(self._buf), np.uint8)
        out += self._emit_blocks(data, last=True)
        self._buf.clear()
        if self._hash is not None:
            out += (self._hash.digest() & 0xFFFFFFFF).to_bytes(4, "little")
        self._finished = True
        return bytes(out)
