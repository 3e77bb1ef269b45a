"""SoftwareCodec: the host-only codec, the tools' software baseline.

Port of qat_zstd_plugin_tpu.runtime.tpu_codec's `TpuCodec(level,
use_device=False)` path (the pure-software branch of its
`compress_bodies`): one native call matches and entropy-codes every
block with the runtime's own thread pool (native.compress_blocks_mt), and format.assemble_frame makes
the frame. Its frames equal TpuCodec(use_device=False)'s byte for byte.

It is the reference benchmark's software A/B baseline (test/benchmark.c
-m 0) and the CLI's --cpu. Only tools/ uses it: compress(), GpuCodec and
QZ_FORCE_BACKEND never reach it, so it is never a fallback for the card.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..format import assemble_frame
from ..utils import config
from .gpu_codec import check_block_size
from .levels import TPU_LEVEL_TABLE, level_params
from .stats import BlockStats, Timer


class SoftwareCodec:
    """Block compressor on the host CPU alone."""

    def __init__(self, level: int = 1, block_size: int | None = None):
        if level not in TPU_LEVEL_TABLE:
            raise ValueError(f"unsupported level {level}: supported range "
                             "1..12")
        cfg = config.get()  # process defaults (QZ_* env); arguments win
        self.level = level
        self.params = TPU_LEVEL_TABLE[level]
        self.host = level_params(level)
        self.block_size = cfg.block_size if block_size is None \
            else block_size
        check_block_size(level, self.block_size, None,
                         "QZ_BLOCK_SIZE" if block_size is None
                         else "block_size")
        self.checksum_default = cfg.checksum
        native.load()  # raises if the host runtime cannot be built
        self.stats = BlockStats()

    def compress(self, data: bytes | np.ndarray,
                 checksum: bool | None = None) -> bytes:
        """One frame: every block matched and entropy-coded in one native
        call, each block's time recorded as the call's mean
        (tpu_codec.py:604-618)."""
        if checksum is None:
            checksum = self.checksum_default
        buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(
            data, np.ndarray) else np.ascontiguousarray(data, np.uint8)
        n = len(buf)
        bs = self.block_size
        gp = self.host
        with Timer() as tm:
            bodies = native.compress_blocks_mt(
                buf, bs, gp.chain_depth, gp.lazy,
                self.params.custom_tables and gp.custom_tables,
                self.params.huffman, window_log=gp.window_log, mml=gp.mml)
        per = tm.elapsed / max(1, len(bodies))
        for i, body in enumerate(bodies):
            self.stats.record(min(n - i * bs, bs),
                              len(body) if body else None, per)
        return assemble_frame(buf, bodies, bs, checksum,
                              window_log=gp.window_log)
