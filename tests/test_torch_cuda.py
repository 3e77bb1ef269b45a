"""The CUDA kernels against their plain-torch twins, on a CUDA device.

Marked `cuda`: on a machine without a CUDA device every test here skips
(a kernel has no CPU mode). Run on the card with
`python -m pytest tests/test_torch_cuda.py -q`; chip_smoke.py repeats
these checks at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu_torch import compress
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp

pytestmark = pytest.mark.cuda

N = 131072
WINDOW = 32768


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _blocks(B=8, seed=0):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 8, (B, N), np.uint8)
    out[1] = rng.integers(0, 256, N, np.uint8)
    out[2] = 0x41
    out[B - 1, N // 2:] = out[0, :N // 2]
    return out


def test_hash_keys_winmin_sync(cuda):
    x = torch.from_numpy(_blocks()).to(cuda)
    for stride in (0, 32):
        k, m = tk.hash_keys_winmin_sync(x, 6, WINDOW, stride)
        tw_k, tw_m = tk.hash_keys_winmin_sync_twin(x, 6, WINDOW, stride)
        assert torch.equal(k, tw_k)
        assert (m is None and tw_m is None) or torch.equal(m, tw_m)


def test_neighbor_unsort_and_ldm_keys(cuda):
    k, m = tk.hash_keys_winmin_sync(torch.from_numpy(_blocks()).to(cuda), 6,
                                    WINDOW, 32)
    sk = tk._sort_rows(k)
    assert torch.equal(tk.neighbor_unsort_keys(sk, 15, 1, WINDOW - 1),
                       tk.neighbor_unsort_keys_twin(sk, 15, 1, WINDOW - 1))
    lk = tk.ldm_keys(m, 4, 32)
    assert torch.equal(lk, tk.ldm_keys_twin(m, 4, 32))
    slk = tk._sort_rows(lk)
    assert torch.equal(tk.neighbor_unsort_keys(slk, 15, 2),
                       tk.neighbor_unsort_keys_twin(slk, 15, 2))


def test_slot_words_card_vs_cpu(cuda):
    blocks = _blocks()
    lengths = np.array([N, N - 1, N // 2, 100, 0, N, N, 7], np.int32)
    kw = dict(window=WINDOW, ldm=4)
    tk.reset_launches()
    got = tmp.find_matches_positions(torch.from_numpy(blocks).to(cuda),
                                     torch.from_numpy(lengths).to(cuda),
                                     **kw).cpu()
    assert all(n > 0 for n in tk.launches.values())
    want = tmp.find_matches_positions(torch.from_numpy(blocks),
                                      torch.from_numpy(lengths), **kw)
    assert torch.equal(got, want)


def test_frames_card_vs_cpu(cuda):
    data = _blocks(B=4, seed=1).tobytes() + b"tail" * 1000
    assert compress(data, batch=4, device="cuda") == \
        compress(data, batch=4, device="cpu")
