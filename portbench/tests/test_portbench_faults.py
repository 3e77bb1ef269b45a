"""The comparison must fail: the control (the program's own path without
the checksum the configuration states) and each fault a cell can have,
planted underneath a whole run on the CPU, make `correct` false; the
sound program makes it true."""

import pytest

from conftest import small_cell

FAULTS = ["checksum_off", "alter", "row", "stale", "half"]


# At the CPU's sizes no request of the small objects cell reaches the
# last row of a batch, so the row fault is read on l1.bulk alone.
CASES = [(n, k) for n in ("l1.bulk", "l9hyb.objects")
         for k in ["none"] + FAULTS if (n, k) != ("l9hyb.objects", "row")]


@pytest.mark.parametrize("name,kind", CASES)
def test_fault_is_caught(name, kind):
    from portbench.control import read
    from portbench.run import make_codec
    cell = small_cell(name)
    if name == "l1.bulk":  # a multi-block frame per call
        cell.traffic["object_bytes"] = 1_100_000
    codec, compress = make_codec(cell.config, "cpu")
    got = read(cell, codec, compress, kind, 2 ** 31 + 99, 1.5)
    assert got["correct"] is (kind == "none"), got
    if kind == "row":  # the sample decodes a block of every row
        assert got["numbers"]["bad_decodes"] >= 1, got
    assert "finish_block_host" not in codec.__dict__
    assert "compress_bodies" not in codec.__dict__


@pytest.mark.parametrize("kind", FAULTS)
def test_fault_fails_the_run(kind, monkeypatch):
    """The same plant under run() itself (the timed path's own call), in
    the objects cell (the row fault: in l1.bulk, as above)."""
    from portbench import control, run as run_mod
    made = run_mod.make_codec

    def broken(cfg, device):
        codec, compress = made(cfg, device)
        return codec, control.plant(kind, codec, compress, cfg["checksum"])
    monkeypatch.setattr(run_mod, "make_codec", broken)
    cell = small_cell("l1.bulk" if kind == "row" else "l9hyb.objects")
    if kind == "row":
        cell.traffic["object_bytes"] = 1_100_000
    out, notes = run_mod.run(cell, 77, 1.5, False, device="cpu")
    assert out["correct"] is False and notes


def test_a_failed_call_is_missing():
    """A call that raised or never returned is counted, and fails the
    run."""
    import numpy as np

    from portbench import check
    from portbench.loops import Call
    calls = [Call(np.zeros(10, np.uint8), 0.0, error="RuntimeError: x"),
             Call(np.zeros(10, np.uint8), 0.0)]
    numbers, notes = check.judge(calls, {"block_size": 131072,
                                         "checksum": True}, {}, 1)
    assert numbers["missing"] == 2 and not check.correct(numbers)
    assert notes[0].endswith("RuntimeError: x")
