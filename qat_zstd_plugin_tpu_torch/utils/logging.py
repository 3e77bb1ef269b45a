"""Leveled stderr logging — parity with QZSTD_LOG (src/qatseqprod.c:187-205).

Copy of qat_zstd_plugin_tpu.utils.logging. Levels mirror the reference's
0-3 ladder: 0 release (silent), 1 errors, 2 events, 3 debug. The default
is utils/config.py's `debug_level`, read from QZ_DEBUG_LEVEL (the
reference's compile-time -DDEBUGLEVEL becomes an env var; a value that
is not an integer reads as 0); set_level overrides it. The port logs at
level 1 where GpuCodec raises a failed device batch and where
sequence_producer records an exception.
"""

from __future__ import annotations

import sys
import threading
import time

from . import config

LEVEL_RELEASE = 0
LEVEL_ERROR = 1
LEVEL_EVENT = 2
LEVEL_DEBUG = 3

_lock = threading.Lock()
debug_level: int | None = None  # set_level's; None: config's debug_level


def set_level(level: int | None) -> None:
    global debug_level
    debug_level = level


def log(level: int, fmt: str, *args) -> None:
    if level > (config.get().debug_level if debug_level is None
                else debug_level):
        return
    msg = fmt % args if args else fmt
    tag = {1: "ERROR", 2: "EVENT", 3: "DEBUG"}.get(level, "LOG")
    with _lock:
        print(f"[qz:{tag} {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)


def error(fmt: str, *args) -> None:
    log(LEVEL_ERROR, fmt, *args)


def event(fmt: str, *args) -> None:
    log(LEVEL_EVENT, fmt, *args)


def debug(fmt: str, *args) -> None:
    log(LEVEL_DEBUG, fmt, *args)
