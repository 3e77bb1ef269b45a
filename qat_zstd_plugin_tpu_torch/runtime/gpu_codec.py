"""GpuCodec: the reference codec's host orchestration around the port's
device pipeline.

`GpuCodec` is `TpuCodec` with the device half swapped: full blocks go in
batches through ops.match_pipeline.find_matches_positions on an explicit
torch device (the CUDA kernels on "cuda", their plain-torch twins on
"cpu"), and everything after the slot words (claims, native extension,
gap fill, entropy, frame) is the reference's own code, so the frames are
byte-identical to TpuCodec's at the same level and batch size.

Unlike TpuCodec it hides no device failure: it requires the native host
runtime (TpuCodec silently swaps to the content matcher without it), and
its own compress_bodies loop raises an error from the device pipeline
where the reference's re-matches the batch on the CPU.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from qat_zstd_plugin_tpu import native
from qat_zstd_plugin_tpu.golden import codec as golden_codec
from qat_zstd_plugin_tpu.runtime.tpu_codec import (TpuCodec,
                                                   device_positions_to_claims)
from qat_zstd_plugin_tpu.utils.profiling import Timer

from ..ops import match_pipeline


class GpuCodec(TpuCodec):
    """Batched block compressor on one torch device."""

    def __init__(self, level: int = 1, batch: int | None = None,
                 block_size: int | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(level=level, batch=batch, block_size=block_size,
                         use_device=True, device_entropy=False)
        if self.params.matcher != "hash":
            raise NotImplementedError(
                f"level {level}: only the hash-matcher levels 1-4 are "
                "ported")
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={str(self.device)!r}: torch sees no "
                               "CUDA device")
        if not native.available():
            raise RuntimeError("the native host runtime is required: it "
                               "verifies the device's hash claims")
        self.device_blocks = 0  # full blocks matched by the device pipeline

    def _resolve_parser(self) -> str:
        # Dense claims: no parser runs on the device. (The inherited
        # version asks JAX for its backend.)
        return "none"

    def _pipeline(self):
        if self._fn is None:
            p = self.params
            wlog = golden_codec.level_params(self.level).window_log

            def run(blocks, lengths):
                return match_pipeline.find_matches_positions(
                    blocks, lengths, widths=p.widths, neighbors=p.neighbors,
                    window=p.window, ldm=p.ldm, ldm_max_off=1 << wlog,
                    dense=p.dense, sync=p.sync)

            self._fn = run
        return self._fn

    def submit_batch(self, blocks_np: np.ndarray, lengths_np: np.ndarray):
        """Copy one batch (b <= self.batch, zero-padded to self.batch as in
        the reference: LDM spans tile the batch) to the device and enqueue
        the pipeline on the current stream. Returns a handle."""
        b = blocks_np.shape[0]
        if b < self.batch:
            pad = np.zeros((self.batch - b,) + blocks_np.shape[1:], np.uint8)
            blocks_np = np.concatenate([blocks_np, pad])
            lengths_np = np.concatenate(
                [lengths_np, np.zeros(self.batch - b, np.int32)])
        blocks = torch.from_numpy(blocks_np).to(self.device)
        lengths = torch.from_numpy(lengths_np).to(self.device)
        return b, lengths_np, self._pipeline()(blocks, lengths)

    def collect_batch(self, handle):
        """Wait for a submitted batch; returns (claims, None) per block."""
        b, lengths, slots = handle
        words = slots.cpu().numpy().view(np.uint32)
        per_block = match_pipeline.unpack_segments(words, self.batch,
                                                   self.params.window)
        self.device_blocks += b
        return [(device_positions_to_claims(p, o, lengths[i]), None)
                for i, (p, o) in enumerate(per_block[:b])]

    def compress_bodies(self, buf: np.ndarray, validate: bool = False,
                        frame_start: bool = True) -> list[bytes | None]:
        """Per-block Compressed_Block bodies (None => raw block).

        TpuCodec.compress_bodies without its CPU re-match: the full blocks
        go to the device in batches, QUEUE_DEPTH batches in flight while
        earlier ones are collected and finished on a host thread pool, and
        a device error is raised where it happens. The short tail block is
        matched on the host, as in the reference: that is the format's
        contract, not a fallback."""
        buf = np.ascontiguousarray(buf, np.uint8)
        n = len(buf)
        bs = self.block_size
        nblocks = max(1, -(-n // bs))
        nfull = n // bs
        QUEUE_DEPTH = 3

        def finish_block(i: int, seqs, dev_section=None) -> bytes | None:
            with Timer() as tm:
                body = self.finish_block_host(buf, i, seqs, dev_section,
                                              frame_start=frame_start,
                                              validate=validate)
            self.stats.record(min(n - i * bs, bs),
                              len(body) if body else None, tm.elapsed)
            return body

        futures: dict[int, object] = {}
        inflight: list[tuple[range, object]] = []
        with ThreadPoolExecutor() as pool:

            def collect_one() -> None:
                ids, handle = inflight.pop(0)
                for i, (sq, sec) in zip(ids, self.collect_batch(handle)):
                    futures[i] = pool.submit(finish_block, i, sq, sec)

            for s in range(0, nfull, self.batch):
                ids = range(s, min(s + self.batch, nfull))
                blocks_np = buf[s * bs:ids.stop * bs] \
                    .reshape(len(ids), bs).copy()
                lengths_np = np.full(len(ids), bs, np.int32)
                inflight.append((ids, self.submit_batch(blocks_np,
                                                        lengths_np)))
                if len(inflight) >= QUEUE_DEPTH:
                    collect_one()
            for i in range(nfull, nblocks):  # the short tail block
                futures[i] = pool.submit(finish_block, i, None)
            while inflight:
                collect_one()
            return [futures[i].result() for i in range(nblocks)]
