"""The level tables of the port.

Copies of qat_zstd_plugin_tpu.runtime.tpu_codec's `TpuLevelParams` and
`TPU_LEVEL_TABLE` (the device half's knobs per level) and of
qat_zstd_plugin_tpu.golden.codec's `LevelParams`, `LEVEL_TABLE` and
`level_params` (the host half's: chain depth, lazy parse, window, minimum
match). The frames equal the JAX package's only while every field of
both tables does; a test holds them field by field.
"""

from __future__ import annotations

import dataclasses

MIN_LEVEL = 1
MAX_LEVEL = 12


@dataclasses.dataclass(frozen=True)
class TpuLevelParams:
    """Device-half knobs of one level."""
    neighbors: int               # sort neighbours searched per position
    lazy: bool = False           # one-step lazy parse (content levels)
    stride: int = 1              # anchor spacing of the content matcher
    window: int = 1 << 30        # match window (segmented sorts)
    custom_tables: bool = True
    huffman: bool = True
    # "hash": single-word-sort claims, host-verified; "content":
    # exact-LCP sorts carrying content words.
    matcher: str = "content"
    widths: tuple = (4, 8)       # hash gram widths
    psegs: int = 1               # parse segments per block
    ldm: int = 0                 # long-distance span in blocks (0 = off)
    dense: bool = False          # claim every hash candidate, no parse
    sync: bool = False           # syncmer pair anchors (level 1)


TPU_LEVEL_TABLE = {
    1: TpuLevelParams(1, window=32768, matcher="hash", widths=(6,),
                      ldm=4, dense=True, sync=True),
    2: TpuLevelParams(1, window=32768, matcher="hash", widths=(6,),
                      ldm=4, dense=True),
    3: TpuLevelParams(1, window=32768, matcher="hash", widths=(5, 8),
                      ldm=8, dense=True),
    4: TpuLevelParams(2, window=32768, matcher="hash",
                      widths=(4, 5, 6, 8), ldm=16, dense=True),
    5: TpuLevelParams(4, lazy=True, window=131072, ldm=4),
    6: TpuLevelParams(6, lazy=True, window=131072, ldm=4),
    7: TpuLevelParams(6, lazy=True, ldm=4),
    8: TpuLevelParams(8, lazy=True, ldm=4),
    9: TpuLevelParams(8, lazy=True, ldm=4),
    10: TpuLevelParams(10, lazy=True, ldm=4),
    11: TpuLevelParams(12, lazy=True, ldm=4),
    12: TpuLevelParams(16, lazy=True, ldm=4),
}


@dataclasses.dataclass(frozen=True)
class LevelParams:
    """Host-half knobs of one level."""
    chain_depth: int
    lazy: bool
    custom_tables: bool = True
    huffman: bool = True
    window_log: int = 19   # cross-block match window
    mml: int = 6           # minimum match length of the host matchers


LEVEL_TABLE: dict[int, LevelParams] = {
    1: LevelParams(2, False, window_log=19, mml=6),
    2: LevelParams(4, False, window_log=20, mml=6),
    3: LevelParams(8, False, window_log=21, mml=6),
    4: LevelParams(16, False, window_log=21, mml=6),
    5: LevelParams(8, True, window_log=21, mml=4),
    6: LevelParams(16, True, window_log=21, mml=4),
    7: LevelParams(32, True, window_log=22, mml=4),
    8: LevelParams(48, True, window_log=22, mml=4),
    9: LevelParams(64, True, window_log=22, mml=4),
    10: LevelParams(96, True, window_log=22, mml=4),
    11: LevelParams(128, True, window_log=22, mml=4),
    12: LevelParams(256, True, window_log=22, mml=4),
}


def level_params(level: int) -> LevelParams:
    if not MIN_LEVEL <= level <= MAX_LEVEL:
        raise ValueError(f"unsupported level {level}: supported range "
                         f"{MIN_LEVEL}..{MAX_LEVEL}")
    return LEVEL_TABLE[level]
