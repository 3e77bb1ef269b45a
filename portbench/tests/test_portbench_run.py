"""Whole runs of the harness on the CPU (the program's twins at small
sizes): the result line's keys, the traced run's metrics, the refusal
without a card, and no JAX module in the process."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, small_cell

SEED = 2 ** 31 + 4242


@pytest.mark.parametrize("name", ["l1.bulk", "l9hyb.objects"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(name, trace):
    from portbench.run import run
    cell = small_cell(name)
    out, notes = run(cell, SEED, 2.0, bool(trace), device="cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and notes == []
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    wanted = {m["name"] for m in cell.metrics(
        "per_layer" if trace else "end_to_end")}
    # Device-trace metrics need the card; every other one is read here.
    cpu = {n for n in wanted if not n.startswith("device_")}
    assert cpu <= set(out["metrics"]) <= wanted
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())


def test_no_card_no_result():
    """Without a CUDA device the command exits with 2 and prints no
    result."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "l1.bulk", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2 and p.stdout == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/ the
    command fails and prints no result (the program is not there)."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "from portbench.run import main; sys.exit(main(['--workload', "
            "'l1.bulk', '--seed', '1', '--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout == ""
    assert "qat_zstd_plugin_tpu_torch" in p.stderr


def test_a_run_loads_no_jax():
    """A whole run's process holds no module named jax, jaxlib, flax or
    qat_zstd_plugin_tpu, compared by whole top-level names."""
    code = ("import sys, json, torch; torch.set_num_threads(2); "
            "sys.path.insert(0, 'portbench/tests'); "
            "from conftest import small_cell; "
            "from portbench.run import run, forbidden_loaded; "
            "run(small_cell('l9hyb.objects'), 5, 1.0, True, device='cpu'); "
            "print(json.dumps([forbidden_loaded(), "
            "'qat_zstd_plugin_tpu_torch' in sys.modules]))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [[], True]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench.run import forbidden_loaded
    monkeypatch.setitem(sys.modules, "qat_zstd_plugin_tpu_torchlike",
                        sys)
    assert forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "qat_zstd_plugin_tpu.format", sys)
    assert forbidden_loaded() == ["jax", "qat_zstd_plugin_tpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["l1.bulk", "l9hyb.objects"])
def test_cell_on_the_card(name):
    """A short run of each cell as committed, on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        name, "--seed", str(SEED), "--seconds", "5",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
