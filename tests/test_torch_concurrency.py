"""In-process concurrent use of the port, on the CPU twins: the
counterparts of tests/test_concurrency.py's five cases (the reference's
benchmark drives its shared instance pool from many threads behind phase
barriers, test/benchmark.c:439-441, 514-520), and a first kernel build
by two processes at once.

* distinct GpuCodecs compressing at once;
* ONE shared GpuCodec hammered from every thread: its frames equal the
  one-thread frames, and BlockStats and the codec's block counters
  (device_blocks, overflow_blocks; each under its lock) balance exactly;
* a concurrent first use of a new codec shape;
* runtime/device.py's start and stop under threads;
* compress_via_libzstd (device="cpu") from 4 threads.

Every frame is decoded bit-exactly through stock libzstd.
"""

import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import oracle
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.ops import _build
from qat_zstd_plugin_tpu_torch.runtime import device
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec

torch.set_num_threads(2)  # six test workers share a few cores

NTHREADS = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fast_switching():
    """Switch threads every microsecond, so that unguarded read-modify-
    writes would interleave."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _mkdata(seed: int, n: int = 300_000) -> bytes:
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, 128, np.uint8).tobytes()
    return (make_corpus(100_000, seed) + rec * 800
            + rng.integers(0, 64, n, np.uint8).tobytes())[:n]


def _run_threads(fn, nthreads=NTHREADS):
    """Barrier-start nthreads running fn(tid); re-raise the first error."""
    barrier = threading.Barrier(nthreads)
    errors: list[BaseException] = []

    def wrap(tid):
        try:
            barrier.wait(timeout=60)
            fn(tid)
        except BaseException as e:  # noqa: BLE001 - reported to the test
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(t,))
               for t in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "thread deadlocked"
    if errors:
        raise errors[0]


def test_distinct_codecs_concurrent():
    datas = [_mkdata(s) for s in range(NTHREADS)]
    levels = [1 + (t % 3) for t in range(NTHREADS)]
    frames: list[bytes | None] = [None] * NTHREADS

    def work(tid):
        codec = GpuCodec(level=levels[tid], batch=2, device="cpu")
        frames[tid] = codec.compress(datas[tid])

    _run_threads(work)
    for lv, d, f in zip(levels, datas, frames):
        assert f == GpuCodec(level=lv, batch=2, device="cpu").compress(d)
        assert oracle.decompress(f, len(d)) == d


@pytest.mark.parametrize("level", [1, 5])
def test_shared_codec_concurrent(level):
    """One codec, all threads: frames equal the one-thread frames, and
    the counters balance to the work submitted."""
    codec = GpuCodec(level=level, batch=2, device="cpu")
    datas = [_mkdata(100 + s) for s in range(NTHREADS)]
    want = [codec.compress(d) for d in datas]
    one = (codec.stats.input_bytes, codec.stats.blocks,
           codec.device_blocks, codec.overflow_blocks)
    ROUNDS = 3
    frames = [[None] * ROUNDS for _ in range(NTHREADS)]

    def work(tid):
        for r in range(ROUNDS):
            frames[tid][r] = codec.compress(datas[tid])

    _run_threads(work)
    for d, fs, w in zip(datas, frames, want):
        assert fs == [w] * ROUNDS
        assert oracle.decompress(w, len(d)) == d
    got = (codec.stats.input_bytes, codec.stats.blocks,
           codec.device_blocks, codec.overflow_blocks)
    assert got == tuple((ROUNDS + 1) * n for n in one), \
        "the counters lost concurrent updates"
    assert one[0] == sum(map(len, datas))
    assert one[2] == sum(len(d) // 131072 for d in datas)


def test_concurrent_first_use():
    """Every thread builds a codec of a shape no other test uses and
    compresses at once: the lazily made pipeline and the native runtime
    must come out right."""
    datas = [_mkdata(200 + s, 150_000) for s in range(NTHREADS)]
    frames: list[bytes | None] = [None] * NTHREADS
    kw = dict(level=1, batch=2, block_size=65536, max_seq=8192,
              device="cpu")

    def work(tid):
        frames[tid] = GpuCodec(**kw).compress(datas[tid])

    _run_threads(work)
    for d, f in zip(datas, frames):
        assert f == GpuCodec(**kw).compress(d)
        assert oracle.decompress(f, len(d)) == d


def test_device_lifecycle_concurrent():
    """start/stop hammering: the tri-state never wedges and a start after
    a stop still works."""
    stop_barrier = threading.Barrier(NTHREADS)

    def work(tid):
        for _ in range(5):
            device.start_device()
        stop_barrier.wait(timeout=60)
        if tid == 0:
            device.stop_device()
        device.start_device()

    _run_threads(work)
    assert device.start_device() in (device.Status.OK,
                                     device.Status.STARTED)
    data = _mkdata(999)
    f = GpuCodec(level=1, batch=2, device="cpu").compress(data)
    assert oracle.decompress(f, len(data)) == data


def test_producer_via_libzstd_concurrent():
    """The deployment shape from 4 threads: each its own state, the
    native runtime and the ctypes callback shared."""
    datas = [_mkdata(300 + s, 200_000) for s in range(4)]
    frames: list[bytes | None] = [None] * 4

    def work(tid):
        frames[tid] = qzt.compress_via_libzstd(datas[tid], level=1,
                                               device="cpu")

    _run_threads(work, nthreads=4)
    for d, f in zip(datas, frames):
        assert f == qzt.compress_via_libzstd(d, level=1, device="cpu")
        assert oracle.decompress(f, len(d)) == d


STUB_NVCC = """\
#!{python}
import os, sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(1.5)  # a window for the other process
with open(args[args.index("-o") + 1], "w") as f:
    f.write("stub")
"""

BUILD_SCRIPT = """\
import sys
sys.path.insert(0, {repo!r})
from qat_zstd_plugin_tpu_torch.ops import _build
_build.BUILD_ROOT = {root!r}
print(_build.build(), _build.build_seconds is not None)
"""


def test_first_build_by_two_processes(tmp_path):
    """Two processes build csrc/ into an empty build root at once: a stub
    nvcc counts one compile of each source and one link, and both get
    the same library path."""
    bindir, root = tmp_path / "bin", tmp_path / "build"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    stub = bindir / "nvcc"
    stub.write_text(STUB_NVCC.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}"
               f"{os.environ.get('PATH', '')}")
    code = textwrap.dedent(BUILD_SCRIPT.format(repo=REPO, root=str(root)))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0][0] == outs[1][0]
    assert sorted(o[1] for o in outs) == ["False", "True"]
    lines = log.read_text().split()
    assert lines.count("compile") == len(_build._sources())
    assert lines.count("link") == 1
    assert os.path.exists(outs[0][0])
