"""Process-level device state on torch.cuda (reference:
qat_zstd_plugin_tpu.runtime.device, whose `Status` and
`RETRY_INTERVAL_BLOCKS` are copied here).

The same tri-state contract: OK when a CUDA device is present, STARTED
(degraded) when torch runs but sees none, FAIL before a start or after a
stop. The codec does not consult it to pick a path: a caller that asks
for device="cuda" gets the CUDA kernels or an error.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field

import torch


class Status(enum.Enum):
    """Tri-state init result (QZSTD_Status_e of the reference plugin)."""
    OK = 0        # accelerator up and usable
    STARTED = 1   # runtime up but no accelerator (degraded)
    FAIL = 2      # not started


# Restart cadence after repeated offload failures (the reference plugin's
# NUM_BLOCK_OF_RETRY_INTERVAL).
RETRY_INTERVAL_BLOCKS = 1000

__all__ = ["RETRY_INTERVAL_BLOCKS", "Status", "devices",
           "note_offload_failure", "start_device", "status", "stop_device"]


@dataclass
class _ProcessState:
    status: Status = Status.FAIL
    devices: list = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)
    fail_offload_count: int = 0


_state = _ProcessState()


def start_device() -> Status:
    """Discover CUDA devices (idempotent)."""
    with _state.lock:
        if _state.status == Status.OK:
            return Status.OK
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _state.devices = [torch.device("cuda", i) for i in range(n)]
        _state.status = Status.OK if n else Status.STARTED
        _state.fail_offload_count = 0
        return _state.status


def stop_device() -> Status:
    with _state.lock:
        _state.status = Status.FAIL
        _state.devices = []
        _state.fail_offload_count = 0
        return Status.OK


def status() -> Status:
    return _state.status


def devices() -> list:
    return list(_state.devices)


def note_offload_failure() -> bool:
    """Count a failed batch offload; True every RETRY_INTERVAL_BLOCKS
    failures (the reference's restart cadence)."""
    with _state.lock:
        _state.fail_offload_count += 1
        return _state.fail_offload_count % RETRY_INTERVAL_BLOCKS == 0
