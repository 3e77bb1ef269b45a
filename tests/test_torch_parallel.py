"""The port's scale-out (parallel/) against the JAX package's, on the CPU.

compress_mesh's frame must equal the JAX package's compress_mesh frame
over a mesh of the same size, byte for byte, on every rank: in a world of
one with no process group, and under 2- and 3-rank gloo groups in
subprocesses (a file:// store), at levels 1, 4 and 9 on the input of
tests/test_multiprocess.py (21 full 16 KiB blocks and a tail). The JAX
frames come from a mesh of conftest's virtual CPU devices (Pallas in
interpret mode). This is the CPU twin of the slow-marked
test_multiprocess.py, small enough to run with the suite.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qat_zstd_plugin_tpu.parallel import distributed as jdist
from qat_zstd_plugin_tpu.parallel import mesh as jmesh
from qat_zstd_plugin_tpu.parallel import pipeline as jpipe
from qat_zstd_plugin_tpu_torch import oracle
from qat_zstd_plugin_tpu_torch.parallel import distributed, mesh, pipeline

torch.set_num_threads(2)  # six test workers share a few cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = (1, 4, 9)
WORLDS = (1, 2, 3)
KW = dict(block_size=16384, max_seq=4096)


def _data() -> bytes:
    """tests/test_multiprocess.py's input: 60000 words and 9000 random
    bytes."""
    rng = np.random.default_rng(0)
    words = [b"dist ", b"mesh ", b"frame ", b"gather ", b"entropy "]
    data = b"".join(words[int(k)] for k in rng.integers(0, 5, 60000))
    return data + rng.integers(0, 256, 9000, np.uint8).tobytes()


DATA = _data()
_JAX_FRAMES: dict = {}
_RANK_RUNS: dict = {}


def jax_frame(level: int, world: int) -> bytes:
    """The JAX package's compress_mesh frame over `world` devices."""
    key = (level, world)
    if key not in _JAX_FRAMES:
        m = jmesh.make_mesh(jax.devices()[:world])
        _JAX_FRAMES[key] = jpipe.compress_mesh(DATA, m, level=level, **KW)
    return _JAX_FRAMES[key]


_WORKER = r"""
import os, sys
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
from qat_zstd_plugin_tpu_torch.parallel import distributed, mesh, pipeline
distributed.init("file://" + store, world_size=world, rank=rank,
                 backend="gloo")
m = mesh.make_mesh()
assert m.size() == world and m.get_local_rank() == rank
data = open(out + ".src", "rb").read()
for level in %(levels)r:
    f = pipeline.compress_mesh(data, m, level=level, device="cpu",
                               block_size=16384, max_seq=4096)
    open(out + ".L%%d.%%d" %% (level, rank), "wb").write(f)
    # The same frame with this rank's spans cut into one-span calls.
    cut = pipeline._compress_mesh(data, m, level, True, 4096, 16384, "cpu",
                                  1)
    assert cut == f, ("cut", level)
# No full block (every rank holds no rows) and a single one: the frames of
# a world of one.
for small in (b"", b"abc" * 30, data[:16384 + 5]):
    f = pipeline.compress_mesh(small, m, level=1, device="cpu",
                               block_size=16384)
    assert f == pipeline.compress_mesh(small, mesh.LocalMesh(), level=1,
                                       device="cpu", block_size=16384)
# The ragged gather: ranks 0, 1 and 2 hold 3, 0 and 2 rows.
nrows = [3, 0, 2][rank]
rng = np.random.default_rng(rank)
bodies = [rng.integers(0, 256, int(rng.integers(1, 60)), np.uint8).tobytes()
          for _ in range(nrows)]
padded, sizes = distributed.pad_blocks(bodies, 64)
ids = np.arange(nrows, dtype=np.int32) + 10 * rank
gp, gs, gi = distributed.gather_rows(m, padded, sizes, ids)
want = [(r, k) for r in range(world) for k in range(%(rows)r[r])]
assert gi.tolist() == [10 * r + k for r, k in want], gi
allb = []
for r in range(world):
    g = np.random.default_rng(r)
    allb += [g.integers(0, 256, int(g.integers(1, 60)), np.uint8).tobytes()
             for _ in range(%(rows)r[r])]
assert [gp[i, :gs[i]].tobytes() for i in range(len(gs))] == allb
assert distributed.gather_compressed(m, padded, sizes) == allb
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib",
                                                     "qat_zstd_plugin_tpu")]
assert not bad, bad
torch.distributed.destroy_process_group()
print("rank", rank, "ok", flush=True)
# Every check has passed: leave without the interpreter's teardown, where
# torch's gloo threads can abort a finished process (seen once under load).
sys.stderr.flush()
os._exit(0)
"""


def rank_frames(world: int, tmp_path_factory) -> dict:
    """{level: [each rank's frame]} from `world` gloo ranks, run once."""
    if world in _RANK_RUNS:
        return _RANK_RUNS[world]
    d = tmp_path_factory.mktemp(f"world{world}")
    out = str(d / "frame")
    with open(out + ".src", "wb") as fh:
        fh.write(DATA)
    src = _WORKER % {"repo": REPO, "levels": LEVELS, "rows": [3, 0, 2]}
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(world), str(d / "store"),
         out], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so.decode()[-500:], se.decode()[-3000:])
    got = {}
    for level in LEVELS:
        got[level] = []
        for r in range(world):
            with open(f"{out}.L{level}.{r}", "rb") as fh:
                got[level].append(fh.read())
    _RANK_RUNS[world] = got
    return got


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("level", LEVELS)
def test_compress_mesh_equals_reference(level, world, tmp_path_factory):
    """Every rank's frame equals the JAX frame over a mesh of `world`
    devices and decodes through stock libzstd; the world of one runs with
    no process group."""
    want = jax_frame(level, world)
    if world == 1:
        frames = [pipeline.compress_mesh(DATA, level=level, device="cpu",
                                         **KW)]
    else:
        frames = rank_frames(world, tmp_path_factory)[level]
    assert len(frames) == world
    for f in frames:
        assert f == want
    assert oracle.decompress(frames[0], len(DATA)) == DATA


@pytest.mark.parametrize("level", LEVELS)
def test_frame_does_not_depend_on_device_calls(level):
    """The device half cut into calls of one span and of two spans (each
    with its own context span) gives the same frame."""
    want = pipeline.compress_mesh(DATA, level=level, device="cpu", **KW)
    for spans in (1, 2):
        got = pipeline._compress_mesh(DATA, None, level, True,
                                      KW["max_seq"], KW["block_size"],
                                      "cpu", spans)
        assert got == want, spans


def test_gather_compressed_ordered_world_of_one():
    """Twin of tests/test_aux.py::test_distributed_gather_ordered."""
    rng = np.random.default_rng(0)
    bodies = [rng.integers(0, 256, int(rng.integers(1, 200)),
                           np.uint8).tobytes() for _ in range(16)]
    padded, sizes = distributed.pad_blocks(bodies, 256)
    jp, js = jdist.pad_blocks(bodies, 256)
    np.testing.assert_array_equal(padded, jp)
    np.testing.assert_array_equal(sizes, js)
    m = mesh.make_mesh()
    assert isinstance(m, mesh.LocalMesh) and m.size() == 1
    assert distributed.gather_compressed(m, padded, sizes) == bodies
    assert jdist.gather_compressed(jmesh.make_mesh(jax.devices()[:8]),
                                   jp, js) == bodies
    with pytest.raises(ValueError):
        distributed.pad_blocks([b"x" * 257], 256)


def test_gather_rows_ragged_two_ranks(tmp_path_factory):
    """gather_rows under a 2-rank gloo group, rank 1 holding no rows: the
    workers of the world-of-two run check every row in order."""
    assert set(rank_frames(2, tmp_path_factory)) == set(LEVELS)


def test_world_above_one_without_group_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="not initialised"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="not initialised"):
        pipeline.compress_mesh(b"x" * 100, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    distributed.init()  # a world of one: nothing to join
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_positions_step_equals_reference(world):
    """Shard r of the port's sharded_positions_step equals rows r of the
    JAX sharded_positions_step over `world` devices: two LDM spans a
    shard, the context sliding within a shard only. Every span repeats
    the same four random rows, so only LDM finds matches, and only in a
    span with a span before it in its shard."""
    rows, n, window = 8, 8192, 8192
    rng = np.random.default_rng(world)
    base = rng.integers(0, 256, (4, n), np.uint8)
    blocks = base[np.arange(rows * world) % 4]
    blocks[rows * world // 2] = rng.integers(0, 256, n, np.uint8)
    lengths = np.full(len(blocks), n, np.int32)
    lengths[1] = n - 777
    jm = jmesh.make_mesh(jax.devices()[:world])
    want = np.asarray(jmesh.sharded_positions_step(jm, window=window)(
        jnp.asarray(blocks), jnp.asarray(lengths))).view(np.uint32)
    fn = mesh.sharded_positions_step(mesh.make_mesh(), window=window,
                                     device="cpu")
    per = want.shape[0] // world
    for r in range(world):
        got = fn(blocks[r * rows:(r + 1) * rows],
                 lengths[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want[r * per:(r + 1) * per])
    # Shards are not the whole batch: the context does not cross them.
    whole = fn(blocks, lengths).numpy().view(np.uint32)
    assert not np.array_equal(whole, want)


def test_compress_mesh_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.compress_mesh(DATA, level=1, **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.sharded_positions_step(mesh.make_mesh())
