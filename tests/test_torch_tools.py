"""The port's tools against the JAX package's, on the CPU.

tools/benchmark.py and tools/cli.py, the software codec they drive
(runtime/soft_codec.py), utils/logging.py, utils/profiling.py and
utils/corpora.py: frames, ratios and bytes equal to the JAX package's
for the same inputs; --device cuda (the default) raises without a card.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu.tools import benchmark as jax_benchmark
from qat_zstd_plugin_tpu.tools import cli as jax_cli
from qat_zstd_plugin_tpu.utils import corpora as jax_corpora

import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import oracle
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec
from qat_zstd_plugin_tpu_torch.runtime.soft_codec import SoftwareCodec
from qat_zstd_plugin_tpu_torch.tools import benchmark, cli
from qat_zstd_plugin_tpu_torch.utils import config, corpora, profiling
from qat_zstd_plugin_tpu_torch.utils import logging as qzlog

torch.set_num_threads(2)  # six test workers share a few cores

BLOCK = 131072


@pytest.fixture(scope="module")
def soft_data():
    return make_corpus(5 * BLOCK + 777, seed=5)


@pytest.fixture(scope="module")
def tool_input(tmp_path_factory):
    """Two blocks and a short one: the benchmark's and the CLI's input."""
    data = make_corpus(2 * BLOCK + 777, seed=3)
    path = tmp_path_factory.mktemp("tools") / "in.bin"
    path.write_bytes(data)
    return str(path), data


@pytest.fixture
def no_card(monkeypatch):
    """What the default --device cuda sees on a machine without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _run(tool, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.run(argv)
    return rc, out.getvalue()


def _json(tool, argv) -> dict:
    rc, out = _run(tool, argv)
    assert rc == 0, out
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


# --- SoftwareCodec --------------------------------------------------------

def _stats_equal(a: dict, b: dict) -> None:
    for key in ("blocks", "raw_blocks", "fallback_blocks", "ratio"):
        assert a[key] == b[key], key


@pytest.mark.parametrize("level", [1, 4, 5, 9, 12])
def test_software_codec_equals_tpu_codec(level, soft_data):
    codec = SoftwareCodec(level)
    want_codec = TpuCodec(level, use_device=False)
    frame = codec.compress(soft_data)
    assert frame == want_codec.compress(soft_data)
    assert oracle.decompress(frame, len(soft_data)) == soft_data
    _stats_equal(codec.stats.summary(), want_codec.stats.summary())


def test_software_codec_block_size_no_checksum(soft_data):
    codec = SoftwareCodec(4, block_size=16384)
    want_codec = TpuCodec(4, block_size=16384, use_device=False)
    frame = codec.compress(soft_data, checksum=False)
    assert frame == want_codec.compress(soft_data, checksum=False)
    assert oracle.decompress(frame, len(soft_data)) == soft_data
    assert codec.stats.blocks == -(-len(soft_data) // 16384)
    _stats_equal(codec.stats.summary(), want_codec.stats.summary())


# --- benchmark ------------------------------------------------------------

@pytest.mark.parametrize("chunk_kb", [128, 256])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_benchmark_ratio_equals_jax_tool(mode, chunk_kb, tool_input):
    path, _ = tool_input
    argv = [path, "-l", "1", "-m", str(mode), "-c", str(chunk_kb), "--json"]
    got = _json(benchmark, argv + ["--device", "cpu"])
    want = _json(jax_benchmark, argv)
    assert got["ok"] and want["ok"]
    assert got["ratio"] == want["ratio"]
    assert set(got) == set(want)
    assert got["threads"] == 1 and got["latency_us"]["P50"] > 0
    if mode in (0, 1):
        _stats_equal(got["block_stats"], want["block_stats"])


def test_benchmark_mode3_is_the_device_producer(tool_input):
    """Mode 3 drives stock libzstd with the port's producer on the device
    half: its ratio is the JAX compress_via_libzstd(use_device=True)
    frames' summed length over the input."""
    path, data = tool_input
    got = _json(benchmark, [path, "-m", "3", "-c", "128", "--json",
                            "--device", "cpu"])
    chunks = [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]
    want = sum(len(qz.compress_via_libzstd(c, level=1, use_device=True))
               for c in chunks)
    assert got["ok"] and got["ratio"] == want / len(data)


def test_histogram_percentiles_equal_jax():
    rng = np.random.default_rng(9)
    ours, theirs = benchmark.Histogram(), jax_benchmark.Histogram()
    for us in rng.lognormal(6.0, 1.5, 2000):
        ours.add(float(us))
        theirs.add(float(us))
    assert np.array_equal(ours.buckets, theirs.buckets)
    assert ours.summary() == theirs.summary()
    for p in (1, 25, 50, 75, 99, 100):
        assert ours.percentile(p) == theirs.percentile(p)


def test_benchmark_thread_failure_does_not_deadlock(tmp_path, monkeypatch):
    p = tmp_path / "d.bin"
    p.write_bytes(b"data" * 5000)
    monkeypatch.setattr(benchmark.oracle, "compress",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    rc, _ = _run(benchmark, [str(p), "-t", "3", "-m", "2"])
    assert rc == 1  # clean FAIL, not a hang


def test_benchmark_threads_each_pass(tool_input):
    """Three GpuCodecs from three host threads: every thread's frames
    decode (the decompress-verify) and the ratio is one thread's."""
    path, _ = tool_input
    rc, out = _run(benchmark, [path, "-t", "3", "-m", "1", "--batch", "4",
                               "--device", "cpu", "--json"])
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if ln.startswith("thread ")]
    assert len(lines) == 3 and all(ln.endswith("PASS") for ln in lines)
    one = _json(benchmark, [path, "-m", "1", "--batch", "4", "--device",
                            "cpu", "--json"])
    got = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("{")][-1])
    assert got["ok"] and got["threads"] == 3
    assert got["ratio"] == one["ratio"]


class _FakeChild:
    def __init__(self, cmd, stdout=None, env=None):
        self.cmd, self.env = cmd, env
        self.returncode = 0

    def communicate(self):
        return json.dumps({"ok": True, "aggregate_mbs": 1.5}).encode(), None


def test_benchmark_processes_run_the_port(tool_input, monkeypatch):
    path, _ = tool_input
    children = []

    def popen(cmd, **kw):
        children.append(_FakeChild(cmd, **kw))
        return children[-1]

    monkeypatch.setattr(benchmark.subprocess, "Popen", popen)
    rc, out = _run(benchmark, [path, "-P", "2", "-m", "1", "-l", "4",
                               "--device", "cpu", "--batch", "16"])
    assert rc == 0
    assert len(children) == 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for child in children:
        cmd = child.cmd
        assert cmd[1:3] == ["-m", "qat_zstd_plugin_tpu_torch.tools.benchmark"]
        assert cmd[3] == path and cmd[-1] == "--json"
        flags = dict(zip(cmd[4:-1:2], cmd[5:-1:2]))
        assert flags == {"-t": "1", "-l": "4", "-c": "128", "-m": "1",
                         "-E": "0", "-L": "1", "--batch": "16",
                         "--device": "cpu"}
        assert child.env["PYTHONPATH"].split(os.pathsep)[0] == root
    assert "process 0: 1.5 MB/s PASS" in out
    assert "aggregate compress: 3.0 MB/s over 2 processes" in out


@pytest.mark.parametrize("mode", [1, 3])
def test_benchmark_cuda_raises_without_card(mode, tool_input, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.run([tool_input[0], "-m", str(mode)])


# --- CLI ------------------------------------------------------------------

def test_cli_compress_equals_tpu_codec(tool_input, tmp_path):
    path, data = tool_input
    out = str(tmp_path / "o.zst")
    assert _run(cli, ["compress", path, "-o", out, "--device", "cpu"])[0] \
        == 0
    with open(out, "rb") as f:
        frame = f.read()
    assert frame == TpuCodec(level=1, use_device=True).compress(data)
    assert oracle.decompress(frame, len(data)) == data


def test_cli_cpu_equals_jax_cli(tool_input, tmp_path):
    path, _ = tool_input
    ours, theirs = str(tmp_path / "ours.zst"), str(tmp_path / "jax.zst")
    assert _run(cli, ["compress", path, "-l", "5", "--cpu", "-o", ours])[0] \
        == 0
    assert _run(jax_cli, ["compress", path, "-l", "5", "--cpu", "-o",
                          theirs])[0] == 0
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_cli_hybrid_equals_tpu_codec(tool_input, tmp_path):
    path, data = tool_input
    out = str(tmp_path / "h.zst")
    assert _run(cli, ["compress", path, "-o", out, "--device", "cpu",
                      "--device-entropy", "hybrid"])[0] == 0
    with open(out, "rb") as f:
        frame = f.read()
    assert frame == TpuCodec(level=1, use_device=True,
                             device_entropy="hybrid").compress(data)


def test_cli_decompress_and_roundtrip(tool_input, tmp_path):
    path, data = tool_input
    zst = str(tmp_path / "in.bin.zst")
    assert _run(cli, ["compress", path, "--cpu", "-o", zst])[0] == 0
    assert _run(cli, ["decompress", zst])[0] == 0
    with open(str(tmp_path / "in.bin"), "rb") as f:
        assert f.read() == data
    rc, out = _run(cli, ["roundtrip", path, "-l", "9", "--device", "cpu"])
    assert rc == 0
    assert f"source size: {len(data)}" in out
    assert "round-trip: PASS" in out


def test_cli_missing_input(tmp_path, capsys):
    assert cli.run(["compress", str(tmp_path / "absent")]) == 2
    assert "no such file" in capsys.readouterr().err


def test_cli_cuda_raises_without_card(tool_input, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["compress", tool_input[0]])


def test_decompress_takes_the_reference_keywords(tool_input):
    _, data = tool_input
    frame = SoftwareCodec(1).compress(data)
    assert qzt.decompress(frame_bytes=frame, expected_size=len(data)) \
        == data
    assert qzt.decompress(frame) == qz.decompress(frame)


# --- logging --------------------------------------------------------------

def test_logging_levels(capsys):
    qzlog.set_level(qzlog.LEVEL_EVENT)
    qzlog.error("boom %d", 7)
    qzlog.event("up")
    qzlog.debug("hidden")
    err = capsys.readouterr().err
    assert "boom 7" in err and "up" in err and "hidden" not in err
    qzlog.set_level(0)


def test_logging_level_defaults_to_config(monkeypatch, capsys):
    """QZ_DEBUG_LEVEL has one parser, utils/config.py; set_level wins."""
    monkeypatch.setattr(qzlog, "debug_level", None)
    monkeypatch.setenv("QZ_DEBUG_LEVEL", "2")
    config.set(None)
    try:
        qzlog.event("from the env")
        monkeypatch.setenv("QZ_DEBUG_LEVEL", "not-a-number")
        config.set(None)
        qzlog.error("silenced")
        qzlog.set_level(qzlog.LEVEL_ERROR)
        qzlog.error("overridden")
    finally:
        config.set(None)
    err = capsys.readouterr().err
    assert "from the env" in err and "silenced" not in err
    assert "overridden" in err


def test_malformed_debug_level_does_not_break_import():
    env = dict(os.environ, QZ_DEBUG_LEVEL="verbose")
    subprocess.run([sys.executable, "-c", "import qat_zstd_plugin_tpu_torch "
                    "as q; q.utils.logging.error('x')"], env=env, check=True,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


@pytest.mark.parametrize("stage", ["submit_batch", "collect_batch"])
def test_failed_device_batch_is_logged_and_raised(stage, monkeypatch,
                                                  capsys):
    def fail(*a, **k):
        raise RuntimeError("card lost")

    codec = GpuCodec(level=1, batch=2, device="cpu")
    monkeypatch.setattr(codec, stage, fail)
    monkeypatch.setattr(qzlog, "debug_level", qzlog.LEVEL_ERROR)
    with pytest.raises(RuntimeError, match="card lost"):
        codec.compress(make_corpus(2 * BLOCK, seed=1))
    err = capsys.readouterr().err
    assert "device batch failed (RuntimeError)" in err
    assert codec.device_blocks == 0 and codec.stats.blocks == 0


def test_producer_exception_is_logged(monkeypatch, capsys):
    state = qzt.create_seqprod_state(1, device="cpu")

    def fail(*a, **k):
        raise RuntimeError("card lost")

    monkeypatch.setattr(state.codec, "produce_sequences", fail)
    monkeypatch.setattr(qzlog, "debug_level", qzlog.LEVEL_ERROR)
    assert qzt.sequence_producer(state, b"x" * 4096) \
        is qzt.SEQUENCE_PRODUCER_ERROR
    assert state.errors == 1
    assert "sequence producer failed (RuntimeError" in capsys.readouterr().err


# --- profiling ------------------------------------------------------------

def test_trace_cpu_names_aten_ops(tmp_path):
    data = make_corpus(BLOCK + 777, seed=2)
    with profiling.trace(str(tmp_path), device="cpu") as path:
        frame = qzt.compress(data, level=1, batch=1, device="cpu")
    assert oracle.decompress(frame, len(data)) == data
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert "aten::sort" in names


def test_trace_cuda_raises_without_card(tmp_path, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path), device="cuda"):
            pass
    assert profiling.BlockStats is qzt.runtime.stats.BlockStats
    assert profiling.Timer is qzt.runtime.stats.Timer


# --- corpora --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 21])
@pytest.mark.parametrize("nbytes", [50000, 300001, 1 << 20])
@pytest.mark.parametrize("kind", ["text", "binary", "redundant"])
def test_corpora_equal_jax(kind, nbytes, seed):
    got = corpora.CORPORA[kind](nbytes, seed=seed)
    assert len(got) == nbytes
    assert got == jax_corpora.CORPORA[kind](nbytes, seed=seed)


def test_corpus_mixed_is_the_ports_corpus():
    assert corpora.corpus_mixed(70001, seed=4) == make_corpus(70001, 4)
