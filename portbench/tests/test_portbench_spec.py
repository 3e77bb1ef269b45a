"""BENCHMARK.json against the benchmark's contract, and the harness
finding each cell's files and each metric's reader by name."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(section, keys):
    for e in SPEC[section]:
        assert set(e) == keys
        assert NAME.match(e["name"])
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    assert len({e["name"] for e in SPEC[section]}) == len(SPEC[section])


def test_cells_name_their_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(ROOT, configs[w["config"]]["file"]))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC[section]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if section == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e and "\n" not in m["layer"]
            # Every cell a per-layer metric lists reports what it moves.
            assert set(m["workloads"]) <= set(
                e2e[m["moves"]].get("workloads", cells))
    if section == "end_to_end":
        assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]


def test_every_cell_reports_enough():
    from portbench.run import load_cell
    for w in SPEC["workloads"]:
        cell = load_cell(w["name"])
        names = [m["name"] for m in cell.metrics("end_to_end")]
        assert "setup_s" in names and len(names) >= 2
        assert cell.metrics("per_layer")


@pytest.mark.parametrize("name", [m["name"] for m in
                                  SPEC["end_to_end"] + SPEC["per_layer"]])
def test_each_metric_has_a_reader(name):
    from portbench.run import reader
    assert callable(reader(name))


def test_a_cell_added_as_data(tmp_path):
    """l9hyb.bulk needs one workloads entry and no code: both
    configurations and both traffic mixes exist."""
    from portbench.run import load_cell
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "l9hyb.bulk", "config": "l9hyb",
                              "traffic": "bulk", "chips": 1, "why": "x"})
    for m in spec["per_layer"]:
        if m["name"] == "compress_mbs.bulk":
            m["workloads"].append("l9hyb.bulk")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    os.symlink(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    cell = load_cell("l9hyb.bulk", root=str(tmp_path))
    assert cell.config["level"] == 9 and "object_bytes" in cell.traffic
    assert [m["name"] for m in cell.metrics("end_to_end")] == [
        "ratio_pct", "setup_s"]
    assert [m["name"] for m in cell.metrics("per_layer")] == [
        "compress_mbs.bulk"]


def test_unknown_cell_is_refused():
    from portbench.run import load_cell
    with pytest.raises(SystemExit):
        load_cell("no.such.cell")
