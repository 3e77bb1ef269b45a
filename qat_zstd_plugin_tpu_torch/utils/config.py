"""Process defaults of the port: the QZ_* environment variables.

Copy of qat_zstd_plugin_tpu.utils.config (`Config`, `from_env`, `get`,
`set`): the same fields, defaults, variables and parse rules. A
constructor argument always wins over these defaults.

| reference                            | here                         |
|--------------------------------------|------------------------------|
| env QAT_SECTION_NAME (driver config  | env QZ_* variables below     |
|   section, src/qatseqprod.c:481-496) |                              |
| /etc/4xxx_devx.conf instance counts  | QZ_BATCH (blocks/dispatch)   |
| compile-time -DINTREE driver flavor  | QZ_FORCE_BACKEND             |
| ZSTD_c_* cctx params                 | compress() keyword args      |
| compile-time DEBUGLEVEL              | QZ_DEBUG_LEVEL               |

`force_backend` keeps the variable's string; GpuCodec maps it to a torch
device ("", "cuda" and "tpu" require the card, "cpu" runs the twins).
"""

from __future__ import annotations

import dataclasses
import os

from ..format import BLOCK_SIZE_MAX


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    """Process-level defaults; constructor kwargs still win."""
    batch: int = 8                 # blocks per device dispatch
    block_size: int = BLOCK_SIZE_MAX
    max_seq: int = 16384           # device sequence capacity per block
    force_backend: str = ""        # "", "cuda", "tpu" (the card) or "cpu"
    checksum: bool = True
    debug_level: int = 0
    # Entropy placement: "" / "0" / "off" = host entropy; "hybrid" =
    # device FSE sequence sections + host literals; "1" / "full" =
    # complete device bodies.
    device_entropy: str = ""
    # Deep levels (L5+): the best-of-two (device parse finished on the
    # host AND a full host re-parse, the smaller body kept) in place of
    # the default single hinted parse.
    second_parse: bool = False

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            batch=_env_int("QZ_BATCH", 8),
            block_size=_env_int("QZ_BLOCK_SIZE", BLOCK_SIZE_MAX),
            max_seq=_env_int("QZ_MAX_SEQ", 16384),
            force_backend=os.environ.get("QZ_FORCE_BACKEND", ""),
            checksum=_env_int("QZ_CHECKSUM", 1) != 0,
            debug_level=_env_int("QZ_DEBUG_LEVEL", 0),
            device_entropy=os.environ.get("QZ_DEVICE_ENTROPY", "").lower(),
            second_parse=_env_int("QZ_SECOND_PARSE", 0) != 0,
        )


_config: Config | None = None


def get() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def set(cfg: Config | None) -> None:  # noqa: A001 - tiny flag registry
    """Install process defaults; None resets to lazy re-read of the env."""
    global _config
    _config = cfg
