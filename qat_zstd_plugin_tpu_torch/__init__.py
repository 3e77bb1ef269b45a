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
    decompress(frame_bytes, expected_size=None)   -> bytes (stock libzstd,
        else the port's own decoder, decoder.py)

and the reference's deployment shape, a sequence producer that stock
libzstd (>= 1.5.4) calls once a block, with the device half at batch 1:

    create_seqprod_state(level, device="cuda") -> SeqProdState
        (device="host": the software producer, the host matcher alone)
    sequence_producer(state, block, window_size=None)
        -> [(offset, lit_length, match_length), ..., (0, last_literals, 0)]
        or SEQUENCE_PRODUCER_ERROR
    free_seqprod_state(state)
    compress_via_libzstd(data, level, device)         (ZSTD_compress2)
    compress_stream_via_libzstd(data, level, device,
                                chunk_size, flush_every)
                                                (ZSTD_compressStream2)
    StreamCompressor(level, device=...)   chunk-fed frames of the port's own

Copies of qat_zstd_plugin_tpu's functions of the same names (use_device=
becomes device=). One designed difference: an exception raised by the
device half or the host half inside libzstd's callback still returns the
producer error, but it is also recorded on the state, and the two
compress_*_via_libzstd functions raise it once libzstd returns instead
of handing back a frame that libzstd's own matcher made.

Also block-parallel scale-out over torch.distributed ranks, one process a
card (parallel/), and the reference's QZ_* process defaults
(utils/config.py, read by GpuCodec for the arguments left at None):

    parallel.distributed.init(init_method, world_size, rank, backend)
    parallel.pipeline.compress_mesh(data, mesh=None, level=1,
                                    device="cuda")
        -> the same frame on every rank, equal byte for byte to
        qat_zstd_plugin_tpu's compress_mesh frame at every world size

and the rest of the JAX package's surface: entry.py (entry(),
dryrun_multichip(n)), ops.match_pipeline's find_matches_packed(matcher=...)
and find_matches_staged, parallel.mesh's sharded_pipeline and
compression_step, and ops.bitpack.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native, oracle
from .format import BLOCK_SIZE_MAX, BlockSequences
from .runtime import levels
from .runtime.device import Status, start_device, status, stop_device
from .runtime.gpu_codec import GpuCodec, check_block_size
from .runtime.stream import StreamCompressor
from .utils import logging

__version__ = "0.5.0"

__all__ = ["BLOCK_SIZE_MAX", "GpuCodec", "SEQUENCE_PRODUCER_ERROR",
           "SeqProdState", "Status", "StreamCompressor", "compress",
           "compress_stream_via_libzstd", "compress_via_libzstd",
           "create_seqprod_state", "decompress", "free_seqprod_state",
           "sequence_producer", "start_device", "status", "stop_device",
           "version"]

# The producer's refusal, ZSTD_SEQUENCE_PRODUCER_ERROR at the ABI.
SEQUENCE_PRODUCER_ERROR = object()
DEVICE_MIN_BLOCK = 64  # shorter blocks are matched on the host


def version() -> str:
    return __version__


def compress(data: bytes | np.ndarray, level: int = 1,
             block_size: int = BLOCK_SIZE_MAX, checksum: bool = True,
             batch: int = 8, device: str | torch.device = "cuda",
             device_entropy: str | bool | None = None) -> bytes:
    """Compress to a complete zstd frame on `device`. "cuda" runs the CUDA
    kernels and raises when there is no CUDA device; "cpu" runs their
    plain-torch twins. There is no silent fallback between the two.
    device_entropy="hybrid" encodes the sequence sections on the device,
    True (or 1, or "full") the Huffman literals sections as well, None
    takes QZ_DEVICE_ENTROPY (see GpuCodec). As in the reference's
    compress(), only QZ_MAX_SEQ, QZ_DEVICE_ENTROPY and QZ_SECOND_PARSE
    reach this function from the environment."""
    codec = GpuCodec(level=level, batch=batch, block_size=block_size,
                     device=device, device_entropy=device_entropy)
    return codec.compress(data, checksum=checksum)


def decompress(frame_bytes: bytes, expected_size: int | None = None
               ) -> bytes:
    """Decode a zstd frame (the reference's decompress(), keyword names
    included). Stock libzstd when it is there; else the port's own
    pure-Python/NumPy decoder (decoder.py), with expected_size as its
    output cap, so the package decodes without libzstd too."""
    if oracle.available():
        return oracle.decompress(frame_bytes, expected_size)
    from . import decoder
    return decoder.decompress(frame_bytes, max_output=expected_size)


HOST = "host"  # SeqProdState's device for the software producer


class SeqProdState:
    """Per-stream producer state: a GpuCodec at batch 1 with host entropy
    (the producer returns sequences; libzstd codes them), and the counts
    of the blocks it took: `device_blocks` went through the device half,
    `host_blocks` were matched on the host (under 64 bytes, or their
    device output overflowed, `overflow_blocks`), `errors` raised, the
    latest in `last_error`.

    device="host" is the software producer (the reference's
    use_device=False): no GpuCodec is built and every block is matched on
    the host by native.find_sequences at the level's parameters. It is
    only ever an explicit choice: "cuda" without a card raises."""

    def __init__(self, level: int = 1, block_size: int = BLOCK_SIZE_MAX,
                 device: str | torch.device = "cuda"):
        self.level = level
        self.host = levels.level_params(level)
        self.codec = None
        if device == HOST:
            # No device route: the size is held to the format's bound only.
            check_block_size(level, block_size, None)
        else:
            # Host entropy whatever QZ_DEVICE_ENTROPY says: the producer
            # hands libzstd sequences, and device entropy's carry no
            # offsets.
            self.codec = GpuCodec(level=level, batch=1,
                                  block_size=block_size, device=device,
                                  device_entropy=False)
        self.freed = False
        self.device_blocks = 0
        self.host_blocks = 0
        self.overflow_blocks = 0
        self.errors = 0
        self.last_error: Exception | None = None


def create_seqprod_state(level: int = 1, **kw) -> SeqProdState:
    return SeqProdState(level=level, **kw)


def free_seqprod_state(state: SeqProdState) -> None:
    state.freed = True
    state.codec = None


def sequence_producer(state: SeqProdState, block: bytes | np.ndarray,
                      window_size: int | None = None):
    """Block-level producer: a list of (offset, lit_length, match_length)
    triples and a final literals-only entry (0, last_literals, 0), the
    ZSTD_Sequence contract; SEQUENCE_PRODUCER_ERROR for a freed state, a
    block over BLOCK_SIZE_MAX, a window under min(block, 32 KiB), or an
    exception (recorded on the state). A block of 64 bytes or more goes,
    zero-padded, through the device half at its length, and the native
    extension recovers the full match lengths; a shorter one, or one whose
    device output overflowed, takes the host matcher at the level's
    parameters, as every block of a device="host" state does."""
    if state is None or state.freed:
        return SEQUENCE_PRODUCER_ERROR
    buf = block if isinstance(block, np.ndarray) \
        else np.frombuffer(block, np.uint8)
    n = len(buf)
    if n > BLOCK_SIZE_MAX:
        return SEQUENCE_PRODUCER_ERROR
    if window_size is not None and window_size < min(n, 32 * 1024):
        return SEQUENCE_PRODUCER_ERROR
    try:
        seqs = None
        if state.codec is not None and n >= DEVICE_MIN_BLOCK:
            pad = np.zeros((1, state.codec.block_size), np.uint8)
            pad[0, :n] = buf
            got = state.codec.produce_sequences(pad,
                                                np.array([n], np.int32))[0]
            state.device_blocks += 1
            if got is None:
                state.overflow_blocks += 1
            elif got.nseq:
                seqs = BlockSequences(*native.extend_sequences(
                    buf, got.lit_lengths, got.offsets, got.match_lengths,
                    got.last_literals))
            else:
                seqs = got
        if seqs is None:
            gp = state.host
            seqs = BlockSequences(*native.find_sequences(
                buf, gp.chain_depth, gp.lazy, mml=gp.mml))
            state.host_blocks += 1
    except Exception as e:  # libzstd's C caller cannot take an exception
        state.errors += 1
        state.last_error = e
        logging.error("sequence producer failed (%s: %s) on a %d-byte "
                      "block", type(e).__name__, e, n)
        return SEQUENCE_PRODUCER_ERROR
    out = list(zip(seqs.offsets.tolist(), seqs.lit_lengths.tolist(),
                   seqs.match_lengths.tolist()))
    out.append((0, int(seqs.last_literals), 0))
    return out


def _via_libzstd(compress_with, data: bytes, level: int, device,
                 **kw) -> bytes:
    """`compress_with` (an oracle function) with sequence_producer on a new
    state registered; raises the producer's last exception, if any, once
    libzstd returns."""
    st = create_seqprod_state(level=level, device=device)
    try:
        def produce(block, lvl, wsize):
            out = sequence_producer(st, block, window_size=wsize)
            return None if out is SEQUENCE_PRODUCER_ERROR else out
        frame = compress_with(data, produce, level=level, fallback=True,
                              **kw)
    finally:
        free_seqprod_state(st)
    if st.errors:
        raise st.last_error
    return frame


def compress_via_libzstd(data: bytes, level: int = 1,
                         device: str | torch.device = "cuda",
                         search_repcodes: bool = False) -> bytes:
    """The reference's deployment shape: stock libzstd's ZSTD_compress2
    calls sequence_producer once a block (fallback enabled) and codes its
    sequences. Equal byte for byte to qat_zstd_plugin_tpu's
    compress_via_libzstd(use_device=True) at the same level, and with
    device="host" (the software producer) to its use_device=False."""
    return _via_libzstd(oracle.compress_with_producer, data, level, device,
                        search_repcodes=search_repcodes)


def compress_stream_via_libzstd(data: bytes, level: int = 1,
                                device: str | torch.device = "cuda",
                                chunk_size: int = 64 * 1024,
                                flush_every: int = 0,
                                search_repcodes: bool = False) -> bytes:
    """The same through libzstd's streaming compressor
    (ZSTD_compressStream2, the zstd command line's API): `data` in
    `chunk_size` pieces, a flush every `flush_every` of them (0: none),
    so that blocks are cut short by flushes and the input's end;
    device="host" as in compress_via_libzstd."""
    return _via_libzstd(oracle.compress_stream_with_producer, data, level,
                        device, chunk_size=chunk_size,
                        flush_every=flush_every,
                        search_repcodes=search_repcodes)
