"""B10: the greedy/lazy LZ parse of the content levels 5-12 in PyTorch.

Port of qat_zstd_plugin_tpu.ops.parse_kernel.parse_greedy_pallas (the
Pallas kernel `_make_kernel`) and of its XLA twin
match_pipeline.parse_greedy_scan. The CUDA kernel is in
csrc/content_kernels.cu; `parse_greedy` launches it for a CUDA tensor
(counted in glue_kernels.launches["parse_greedy"]) and runs
`parse_greedy_twin` for a CPU tensor.

The parse is the recurrence of parse_greedy_scan: a cursor per row
starts at 0; at position t the row is active when cursor == t, and then
takes t when mlen[t] >= MIN_MATCH and, with lazy, not mlen[t+1] > mlen[t]
(mlen[N] := 0); the cursor moves to t + mlen[t] on a take and to t + 1
otherwise. Whether t is taken, and where the cursor goes next, depend on
t alone, so the positions a row visits are the chain 0 -> next(0) -> ...
"""

from __future__ import annotations

import torch

from .glue_kernels import MIN_MATCH, _check, _launch, _use_twin


def parse_greedy_twin(mlen: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """Plain-torch B10 (see parse_greedy). It marks the visited chain by
    pointer doubling instead of walking it: after step k the marked
    positions are the first 2^k the cursor visits and `jump` moves 2^k
    visits ahead, so log2(N) + 1 whole-row gathers and scatters replace
    N dependent steps (seconds, not minutes, at 64 x 131072 on a CPU)."""
    B, N = mlen.shape
    m = mlen.to(torch.int64)
    mnext = torch.cat([m[:, 1:], torch.zeros((B, 1), dtype=torch.int64,
                                             device=m.device)], dim=1)
    take = m >= MIN_MATCH
    if lazy:
        take &= ~(mnext > m)
    t = torch.arange(N, device=m.device)
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
    return on[:, :N] & take


def parse_greedy(mlen: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """B10. (B, N) int32 candidate lengths -> (B, N) bool chosen match
    starts of the greedy parse (one-step lazy when `lazy`). Port of the
    Pallas kernel parse_greedy_pallas at psegs=1, the only value a level
    uses."""
    _check(mlen, "parse_greedy", torch.int32, 2)
    if _use_twin(mlen, "parse_greedy"):
        return parse_greedy_twin(mlen, lazy)
    B, N = mlen.shape
    chosen = torch.empty((B, N), dtype=torch.bool, device=mlen.device)
    _launch("parse_greedy", mlen, chosen, B, N, int(lazy))
    return chosen
