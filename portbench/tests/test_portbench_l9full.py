"""The cells l9full.bulk and l9hyb.bulk, added as data: whole runs of the
harness at sizes the CPU twins run, and a fault in the device's literals
sections, which only full device entropy writes, caught by the
comparison that decides `correct`."""

import dataclasses

import pytest

SEED = 2 ** 31 + 2626
# 4-row batches; two objects of eight 128 KiB blocks and a tail.
SMALL = ({"batch": 4}, {"object_bytes": 1_100_000, "objects": 2})


def small(name: str):
    from portbench.run import load_cell
    cell = load_cell(name)
    cfg, traffic = SMALL
    return dataclasses.replace(cell, config={**cell.config, **cfg},
                               traffic={**cell.traffic, **traffic})


def test_the_two_configurations_differ_in_entropy_alone():
    full, hyb = small("l9full.bulk"), small("l9hyb.bulk")
    assert full.config["device_entropy"] is True
    assert hyb.config["device_entropy"] == "hybrid"
    for key in ("level", "batch", "block_size", "checksum", "guarantees",
                "reduced"):
        assert full.config[key] == hyb.config[key], key
    assert full.traffic == hyb.traffic


@pytest.mark.parametrize("name", ["l9full.bulk", "l9hyb.bulk"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(name, trace):
    from portbench.run import run
    cell = small(name)
    out, notes = run(cell, SEED, 2.0, bool(trace), device="cpu")
    assert out["correct"] is True and notes == []
    assert out["attempted"] >= 1 and out["failed"] == 0
    wanted = {m["name"] for m in cell.metrics(
        "per_layer" if trace else "end_to_end")}
    # Device-trace metrics need the card; every other one is read here.
    cpu = {n for n in wanted if not n.startswith("device_")}
    assert cpu <= set(out["metrics"]) <= wanted
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())


def test_a_fault_in_the_device_literals_is_caught(monkeypatch):
    """One byte flipped in the middle of every device literals section
    that collect_batch returns: the blocks the check decodes differ."""
    from portbench import run as run_mod
    made = run_mod.make_codec
    flipped = []

    def broken(cfg, device):
        codec, compress = made(cfg, device)
        collect = codec.collect_batch

        def flip(handle):
            out = []
            for seqs, sec in collect(handle):
                if sec is not None and sec[0] is not None:
                    lit = bytearray(sec[0])
                    lit[len(lit) // 2] ^= 0x5A
                    sec = (bytes(lit), sec[1])
                    flipped.append(len(lit))
                out.append((seqs, sec))
            return out
        codec.collect_batch = flip
        return codec, compress
    monkeypatch.setattr(run_mod, "make_codec", broken)
    out, notes = run_mod.run(small("l9full.bulk"), SEED, 2.0, False,
                             device="cpu")
    assert flipped
    assert out["correct"] is False and notes
    assert out["checks"]["bad_decodes"]["value"] >= 1
    assert out["checks"]["missing"]["value"] == 0
