"""Peaks of the cards the benchmark runs on, and the bytes of the work the
device half's contract needs.

The device half reads each real input byte once and writes each byte of
its output contract once: what `GpuCodec.submit_batch` returns for a
batch, the tensors the host then unpacks. Rows that only pad a batch up
to its size are not work. The bytes come from the shapes of that
output, whatever kernels made it, so a later design of the kernels is
held to the same work.
"""

from __future__ import annotations

# Published peaks (NVIDIA H100 data sheet, SXM part, at its 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def tensor_bytes(obj) -> int:
    """Bytes of every tensor in a nest of tuples, lists and dicts."""
    if obj is None:
        return 0
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v) for v in obj)
    if hasattr(obj, "element_size") and hasattr(obj, "numel"):
        return obj.element_size() * obj.numel()
    return 0


def device_half_bytes(rows: int, batch: int, row_bytes: int,
                      result) -> int:
    """Contract bytes of one batch: `rows` real rows of `row_bytes` input
    read once, and their share of the output tensors (padded to `batch`
    rows) written once."""
    return rows * row_bytes + tensor_bytes(result) * rows // batch


def roofline_pct(work_bytes: int, busy_s: float, kind: str) -> float | None:
    """The least time the card could take for work_bytes at its memory
    bandwidth, as a share of busy_s; None for a card without peaks here
    or without busy time."""
    peak = PEAKS.get(kind)
    if peak is None or busy_s <= 0 or work_bytes <= 0:
        return None
    return 100.0 * work_bytes / peak["hbm_bytes_per_s"] / busy_s
