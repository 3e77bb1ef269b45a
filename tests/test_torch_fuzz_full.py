"""Seeded fuzz of the port's full device entropy against the JAX package,
on the CPU, at the hash levels 1 and 4: test_torch_fuzz_hybrid.py's
inputs and checks with device_entropy=True (a frame may differ from the
reference's only where libzstd refuses the reference's; level 9 is in
test_torch_fuzz_hybrid.py)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_fuzz_hybrid import fuzz_device_entropy  # noqa: E402

torch.set_num_threads(2)  # six test workers share a few cores


@pytest.mark.parametrize("level", [1, 4])
def test_fuzz_full(level):
    fuzz_device_entropy(True, level)
