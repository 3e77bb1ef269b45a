"""Shared helpers of the harness's tests: the benchmark's cells cut to a
size the CPU twins run in seconds (the card's cells are the same code
at the sizes of portbench/configs and portbench/traffic)."""

import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Sizes a CPU run can hold: 4-row batches, a few 128 KiB blocks a frame
# (objects of 2-4 full blocks, so that every batch has two rows or more).
SMALL = {
    "l1.bulk": ({"batch": 4}, {"object_bytes": 600_000, "objects": 2}),
    "l9hyb.objects": ({"batch": 4}, {"pool_bytes": 3_000_000,
                                     "size_min": 270_000,
                                     "size_max": 560_000, "workers": 2}),
}


def small_cell(name: str):
    from portbench.run import load_cell
    cell = load_cell(name)
    cfg, traffic = SMALL[name]
    return dataclasses.replace(cell, config={**cell.config, **cfg},
                               traffic={**cell.traffic, **traffic})


@pytest.fixture(autouse=True)
def _torch_threads():
    import torch
    torch.set_num_threads(2)
