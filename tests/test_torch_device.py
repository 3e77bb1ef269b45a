"""Device state and the no-silent-fallback rule of the port."""

import pytest
import torch

import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu.runtime import device as jax_device
from qat_zstd_plugin_tpu_torch.ops import fse_kernel as fk
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.ops import literals_kernel as lk
from qat_zstd_plugin_tpu_torch.ops import parse_kernel as pk
from qat_zstd_plugin_tpu_torch.ops import sort_kernel as sk
from qat_zstd_plugin_tpu_torch.runtime import device

torch.set_num_threads(2)  # six test workers share a few cores

# The module that holds each kernel's wrapper and twin, and the twin's name.
TWIN = {name: (tk, f"{name}_twin") for name in tk.launches}
TWIN["parse_greedy"] = (pk, "parse_greedy_twin")
TWIN["fse_state"] = (fk, "run_state_kernel_twin")
TWIN["literal_keys"] = (lk, "literal_keys_twin")
TWIN["byte_hist"] = (lk, "byte_hist_twin")
TWIN["bitonic_sort"] = (sk, "bitonic_sort_twin")


def _state_args(dev, dtype=torch.int32, S1=65, B=4):
    """run_state_kernel's arguments: codes, tables, inits, nseq."""
    def z(*shape, t=torch.int32):
        return torch.zeros(shape, dtype=t, device=dev)
    codes = [z(S1, B, t=dtype) for _ in range(3)]
    tables = [(z(k, B), z(k, B), z(k, B)) for k in (64, 32, 64)]
    return codes, tables, [z(B) for _ in range(3)], z(B)


def test_start_device_status():
    device.stop_device()
    assert device.status() == device.Status.FAIL
    want = device.Status.OK if torch.cuda.is_available() \
        else device.Status.STARTED
    assert qzt.start_device() == want
    assert device.status() == want
    assert len(device.devices()) == torch.cuda.device_count()
    assert qzt.stop_device() == device.Status.OK
    assert device.status() == device.Status.FAIL


def test_status_is_shared_with_the_reference():
    """The port keeps its own copy of the reference's Status and restart
    cadence; both equal the reference's, member for member."""
    assert device.Status is not jax_device.Status
    assert [(s.name, s.value) for s in device.Status] == \
        [(s.name, s.value) for s in jax_device.Status]
    assert device.RETRY_INTERVAL_BLOCKS == jax_device.RETRY_INTERVAL_BLOCKS


def test_note_offload_failure_cadence():
    device.stop_device()
    hits = [device.note_offload_failure()
            for _ in range(2 * device.RETRY_INTERVAL_BLOCKS)]
    assert [i + 1 for i, h in enumerate(hits) if h] == [
        device.RETRY_INTERVAL_BLOCKS, 2 * device.RETRY_INTERVAL_BLOCKS]
    device.stop_device()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        qzt.compress(b"x" * 300_000, level=1, device="cuda")


def test_unsupported_device_raises():
    with pytest.raises(ValueError):
        qzt.GpuCodec(level=1, device="meta")


def _meta_calls():
    u8 = torch.zeros((4, 32768), dtype=torch.uint8, device="meta")
    i32 = torch.zeros((16, 16384), dtype=torch.int32, device="meta")
    minz = torch.zeros((4, 32768), dtype=torch.int32, device="meta")
    lengths = torch.zeros((4,), dtype=torch.int32, device="meta")
    keys = torch.zeros((4, 32768), dtype=torch.int32, device="meta")
    return {
        "hash_keys_winmin_sync":
            lambda: tk.hash_keys_winmin_sync(u8, 6, 32768, 32),
        "neighbor_unsort_keys":
            lambda: tk.neighbor_unsort_keys(i32, 15, 1, 32767),
        "ldm_keys": lambda: tk.ldm_keys(minz, 4, 32),
        "compact_slots_sync":
            lambda: tk.compact_slots_sync(i32[:4, :16384].contiguous(),
                                          32768, lengths, 6,
                                          i32[:1, :8192].contiguous(),
                                          4, flip=tk._FLIP),
        "hash_keys": lambda: tk.hash_keys(u8, 6, 32768),
        "hash_keys_winmin": lambda: tk.hash_keys_winmin(u8, 6, 32768, 32),
        "finalize_candidates": lambda: tk.finalize_candidates(
            [keys, keys], u8, lengths, (5, 8), 32768),
        "compact_slots_dense": lambda: tk.compact_slots_dense(
            minz, minz, 32768),
        "ldm_winmin": lambda: tk.ldm_winmin(u8, 32),
        "parse_greedy": lambda: pk.parse_greedy(minz, True),
        "gram_pos_planes": lambda: tk.gram_pos_planes(u8, 32768),
        "neighbor_verify_keys": lambda: tk.neighbor_verify_keys(
            keys, keys, 15, 2),
        "finalize_verified": lambda: tk.finalize_verified(keys, u8, lengths),
        "fse_state": lambda: fk.run_state_kernel(*_state_args("meta")),
        "literal_keys": lambda: lk.literal_keys(
            u8, lengths, u8.to(torch.bool), keys),
        "byte_hist": lambda: lk.byte_hist(keys),
        "compact_slots": lambda: tk.compact_slots(
            u8.to(torch.bool), minz, 32768),
        "compact_operands": lambda: tk.compact_operands(
            minz, minz, minz, 32768),
        "bitonic_sort": lambda: sk.bitonic_sort(keys, keys, keys),
    }


@pytest.mark.parametrize("name", sorted(tk.launches))
def test_wrapper_raises_off_cpu_and_cuda(name, monkeypatch):
    """A tensor the kernel cannot launch on raises; the twin is not run."""
    def no_twin(*a, **k):
        raise AssertionError("twin called for a non-CPU tensor")

    monkeypatch.setattr(*TWIN[name], no_twin)
    before = dict(tk.launches)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        _meta_calls()[name]()
    assert tk.launches == before


@pytest.mark.parametrize("name", sorted(tk.launches))
def test_wrapper_rejects_wrong_dtype(name):
    call = {
        "hash_keys_winmin_sync": lambda: tk.hash_keys_winmin_sync(
            torch.zeros((2, 64), dtype=torch.int32), 6, 64, 32),
        "neighbor_unsort_keys": lambda: tk.neighbor_unsort_keys(
            torch.zeros((2, 64), dtype=torch.int64), 6),
        "ldm_keys": lambda: tk.ldm_keys(
            torch.zeros((4, 64), dtype=torch.uint8), 4, 32),
        "compact_slots_sync": lambda: tk.compact_slots_sync(
            torch.zeros((2, 64), dtype=torch.int32), 128,
            torch.zeros((2,), dtype=torch.int64)),
        "hash_keys": lambda: tk.hash_keys(
            torch.zeros((2, 64), dtype=torch.int32), 6, 64),
        "hash_keys_winmin": lambda: tk.hash_keys_winmin(
            torch.zeros((2, 64), dtype=torch.int8), 6, 64, 32),
        "finalize_candidates": lambda: tk.finalize_candidates(
            [torch.zeros((2, 64), dtype=torch.int64)],
            torch.zeros((2, 64), dtype=torch.uint8),
            torch.zeros((2,), dtype=torch.int32), (6,), 64),
        "compact_slots_dense": lambda: tk.compact_slots_dense(
            torch.zeros((2, 64), dtype=torch.int32),
            torch.zeros((2, 64), dtype=torch.uint8), 64),
        "ldm_winmin": lambda: tk.ldm_winmin(
            torch.zeros((2, 64), dtype=torch.int32), 32),
        "parse_greedy": lambda: pk.parse_greedy(
            torch.zeros((2, 64), dtype=torch.int64)),
        "gram_pos_planes": lambda: tk.gram_pos_planes(
            torch.zeros((2, 64), dtype=torch.int32), 64),
        "neighbor_verify_keys": lambda: tk.neighbor_verify_keys(
            torch.zeros((2, 64), dtype=torch.int64),
            torch.zeros((2, 64), dtype=torch.int32), 6),
        "finalize_verified": lambda: tk.finalize_verified(
            torch.zeros((2, 64), dtype=torch.int64),
            torch.zeros((2, 64), dtype=torch.uint8),
            torch.zeros((2,), dtype=torch.int32)),
        "fse_state": lambda: fk.run_state_kernel(
            *_state_args("cpu", torch.int64)),
        "literal_keys": lambda: lk.literal_keys(
            torch.zeros((2, 64), dtype=torch.uint8),
            torch.zeros((2,), dtype=torch.int32),
            torch.zeros((2, 64), dtype=torch.uint8),
            torch.zeros((2, 64), dtype=torch.int32)),
        "byte_hist": lambda: lk.byte_hist(
            torch.zeros((2, 64), dtype=torch.uint32)),
        "compact_slots": lambda: tk.compact_slots(
            torch.zeros((2, 64), dtype=torch.uint8),
            torch.zeros((2, 64), dtype=torch.int32), 64),
        "compact_operands": lambda: tk.compact_operands(
            torch.zeros((2, 64), dtype=torch.int32),
            torch.zeros((2, 64), dtype=torch.int64),
            torch.zeros((2, 64), dtype=torch.int32), 64),
        "bitonic_sort": lambda: sk.bitonic_sort(
            torch.zeros((2, 1024), dtype=torch.int32),
            torch.zeros((2, 1024), dtype=torch.int32),
            torch.zeros((2, 1024), dtype=torch.int16)),
    }[name]
    with pytest.raises(ValueError):
        call()


def test_cpu_run_counts_no_launch():
    tk.reset_launches()
    blocks = torch.zeros((4, 32768), dtype=torch.uint8)
    lengths = torch.full((4,), 32768, dtype=torch.int32)
    tk.find_matches_positions(blocks, lengths, ldm=4, dense=True, sync=True)
    tk.find_matches_positions(blocks, lengths, widths=(5, 8), ldm=4,
                              dense=True)
    tk.find_matches_positions(blocks, lengths, widths=(5, 8), dense=True)
    slots = tk.find_matches_positions(blocks, lengths, widths=(5, 8), ldm=4,
                                      dense=False, lazy=True)
    chosen = lengths[:, None] > torch.arange(1024)
    ops = torch.zeros((4, 1024), dtype=torch.int32)
    tk.compact_fast_glue(chosen, ops, ops, lengths, 256, 512)
    sk.bitonic_sort(ops, ops, ops)
    assert slots.shape == (4, 8192)
    qzt.compress(bytes(range(256)) * 1100, level=5, batch=4, device="cpu")
    qzt.compress(bytes(range(256)) * 1100, level=1, batch=4, device="cpu",
                 device_entropy="hybrid")
    qzt.compress(bytes(range(256)) * 1100, level=5, batch=4, device="cpu",
                 device_entropy=True)
    assert all(n == 0 for n in tk.launches.values())
