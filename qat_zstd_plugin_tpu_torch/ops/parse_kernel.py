"""B10: the greedy/lazy LZ parse of the content levels 5-12 in PyTorch.

Port of qat_zstd_plugin_tpu.ops.parse_kernel.parse_greedy_pallas (the
Pallas kernel `_make_kernel`) and of its XLA twin
match_pipeline.parse_greedy_scan. The CUDA kernel is in
csrc/content_kernels.cu; `parse_greedy` launches it for a CUDA tensor
(counted in glue_kernels.launches["parse_greedy"], one a call) and runs
`parse_greedy_twin` for a CPU tensor.

The parse is the recurrence of parse_greedy_scan: a cursor per row
starts at 0; at position t the row is active when cursor == t, and then
takes t when mlen[t] >= MIN_MATCH and, with lazy, not mlen[t+1] > mlen[t]
(mlen[N] := 0); the cursor moves to t + mlen[t] on a take and to t + 1
otherwise. Whether t is taken, and where the cursor goes next, depend on
t alone, so the positions a row visits are the chain 0 -> next(0) -> ...

The kernel cuts each row into chunks of PARSE_CHUNK positions, a CTA
each: it maps its chunk from every entry to the chunk's exit by a
backward recurrence over pieces and warps, takes the row's cursor at its
chunk's start from the CTA before it (decoupled look-back over status
words in `scratch`, which the entry point zeroes), publishes its exit,
and walks its pieces forward from their entries. The wrapper allocates
the scratch: a ticket counter and a status word a chunk, each
PARSE_STATUS_STRIDE words apart.

With psegs > 1 (the reference's parse-segmented mode, `trunc` in
_make_kernel) each row of N positions is psegs independent rows of
N / psegs, and each candidate is cut at its segment's end before the
take test: col = min(mlen[t], Np - t) with t the position in the segment;
the lazy test compares the raw next length (0 at the segment's end) with
that cut one.
"""

from __future__ import annotations

import torch

from .glue_kernels import MIN_MATCH, _check, _launch, _use_twin

PARSE_CHUNK = 4096        # csrc kParseThreads * kParsePiece: a CTA's chunk
PARSE_STATUS_STRIDE = 8   # csrc kParseStatusStride: words a status word


def _segments(mlen: torch.Tensor, psegs: int):
    """(B, N) -> (B * psegs, N / psegs): the rows the parse runs on. Raises
    unless psegs >= 1 divides N (the reference asserts it)."""
    B, N = mlen.shape
    if psegs < 1 or N % psegs:
        raise ValueError(f"parse_greedy: psegs {psegs} does not divide the "
                         f"block length {N}")
    return mlen.reshape(B * psegs, N // psegs)


def parse_greedy_twin(mlen: torch.Tensor, lazy: bool = False,
                      psegs: int = 1) -> torch.Tensor:
    """Plain-torch B10 (see parse_greedy). It marks the visited chain by
    pointer doubling instead of walking it: after step k the marked
    positions are the first 2^k the cursor visits and `jump` moves 2^k
    visits ahead, so log2(N) + 1 whole-row gathers and scatters replace
    N dependent steps (seconds, not minutes, at 64 x 131072 on a CPU)."""
    shape = mlen.shape
    raw = _segments(mlen, psegs).to(torch.int64)
    B, N = raw.shape
    t = torch.arange(N, device=raw.device)
    m = torch.minimum(raw, N - t) if psegs > 1 else raw
    mnext = torch.cat([raw[:, 1:], torch.zeros((B, 1), dtype=torch.int64,
                                               device=m.device)], dim=1)
    take = m >= MIN_MATCH
    if lazy:
        take &= ~(mnext > m)
    # Column N is the sink: every cursor past the row's end.
    jump = torch.cat([torch.where(take, t + m, t + 1).clamp(max=N),
                      torch.full((B, 1), N, dtype=torch.int64,
                                 device=m.device)], dim=1)
    on = torch.zeros((B, N + 1), dtype=torch.bool, device=m.device)
    on[:, 0] = True
    span = 1
    while span <= N:
        on.scatter_(1, torch.where(on, jump, N), True)
        jump = jump.gather(1, jump)
        span *= 2
    return (on[:, :N] & take).reshape(shape)


def parse_greedy(mlen: torch.Tensor, lazy: bool = False,
                 psegs: int = 1) -> torch.Tensor:
    """B10. (B, N) int32 candidate lengths -> (B, N) bool chosen match
    starts of the greedy parse (one-step lazy when `lazy`), in psegs
    independent segments a row, each candidate cut at its segment's end
    when psegs > 1. Port of the Pallas kernel parse_greedy_pallas; every
    level takes psegs=1, a level table with psegs > 1 the cut."""
    _check(mlen, "parse_greedy", torch.int32, 2)
    rows = _segments(mlen, psegs)
    if _use_twin(mlen, "parse_greedy"):
        return parse_greedy_twin(mlen, lazy, psegs)
    R, n = rows.shape
    chosen = torch.empty(mlen.shape, dtype=torch.bool, device=mlen.device)
    scratch = torch.empty((R * -(-n // PARSE_CHUNK) + 1) * PARSE_STATUS_STRIDE,
                          dtype=torch.int32, device=mlen.device)
    _launch("parse_greedy", mlen, chosen, scratch, scratch.numel(), R, n,
            int(lazy), int(psegs > 1))
    return chosen
