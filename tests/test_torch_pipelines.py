"""The port's remaining pipelines against the JAX package, on the CPU:
the reference's find_matches_batch and find_matches_staged against the
port's one find_matches_staged (candidates -> B10 -> compact; the
reference's `parser` has no counterpart, its values give the same
result), parallel.mesh.sharded_pipeline and compression_step (in a world
of one and on two gloo ranks), the sort-free bitpack, and entry.py's
entry() and dryrun_multichip().

Inputs come from a seed with numpy; the same arrays go to the JAX
function (its XLA form, or Pallas in interpret mode) and to the port's,
which on CPU tensors runs the kernels' plain-torch twins. Every output is
integers, so the tolerance is 0.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from qat_zstd_plugin_tpu.format.bitstream import BackwardBitWriter
from qat_zstd_plugin_tpu.ops import bitpack as jbitpack
from qat_zstd_plugin_tpu.ops import match_pipeline as jmp
from qat_zstd_plugin_tpu.parallel import mesh as jmesh
from qat_zstd_plugin_tpu_torch import entry
from qat_zstd_plugin_tpu_torch.ops import bitpack
from qat_zstd_plugin_tpu_torch.ops import match_pipeline as tmp
from qat_zstd_plugin_tpu_torch.parallel import mesh

torch.set_num_threads(2)  # six test workers share a few cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def equal_dicts(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      k)


def parallel_blocks():
    """tests/test_parallel.py::test_sharded_matches_unsharded's input."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 8, (16, 2048), np.uint8).astype(np.uint8)
    return blocks, np.full(16, 2048, np.int32)


def text_blocks(B: int, N: int, seed: int):
    """Words and random runs, ragged lengths: lazy and greedy parses
    differ."""
    rng = np.random.default_rng(seed)
    words = [b"the ", b"block ", b"offset ", b"entropy ", b"parse "]
    data = b"".join(words[int(k)] for k in rng.integers(0, 5, B * N // 4))
    blocks = np.frombuffer(data[:B * N], np.uint8).reshape(B, N).copy()
    blocks[0, :N // 3] = rng.integers(0, 256, N // 3, np.uint8)
    lengths = np.full(B, N, np.int32)
    lengths[-1] = N - 1000
    return blocks, lengths


BATCH_CASES = {  # input, neighbors, max_seq, lazy, parser
    "parallel_shape": ("parallel", 2, 512, False, "scan"),
    "parallel_shape_pallas": ("parallel", 2, 512, False, "pallas"),
    "text_lazy": ("text", 4, 4096, True, "scan"),
    "text_overflow": ("text", 4, 300, False, "scan"),
}


def batch_input(kind: str):
    return parallel_blocks() if kind == "parallel" else text_blocks(
        6, 8192, 3)


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_find_matches_batch(case):
    kind, neighbors, max_seq, lazy, parser = BATCH_CASES[case]
    blocks, lengths = batch_input(kind)
    want = jmp.find_matches_batch(jnp.asarray(blocks), jnp.asarray(lengths),
                                  neighbors=neighbors, max_seq=max_seq,
                                  parser=parser, lazy=lazy)
    got = tmp.find_matches_staged(t(blocks), t(lengths), neighbors=neighbors,
                                  max_seq=max_seq, lazy=lazy)
    equal_dicts(got, want)
    if "overflow" in case:
        assert np.asarray(want["overflow"]).any()


@pytest.mark.parametrize("lazy", [False, True])
def test_find_matches_staged(lazy):
    blocks, lengths = text_blocks(4, 16384, 4)
    want = jmp.find_matches_staged(jnp.asarray(blocks), jnp.asarray(lengths),
                                   neighbors=6, max_seq=8192, lazy=lazy)
    got = tmp.find_matches_staged(t(blocks), t(lengths), neighbors=6,
                                  max_seq=8192, lazy=lazy)
    equal_dicts(got, want)


SEGMENTED = {  # stride, window, lazy
    "stride2": (2, 1 << 30, False),
    "window4096": (1, 4096, True),
    "stride4_window8192": (4, 8192, False),
}


@pytest.mark.parametrize("case", sorted(SEGMENTED))
def test_candidates_and_staged_strided_segmented(case):
    """candidates at stride > 1 (anchors at multiples of stride) and window
    < N (segment sorts), and find_matches_staged through them, whose
    compact then takes its segmented branch."""
    stride, window, lazy = SEGMENTED[case]
    blocks, lengths = text_blocks(4, 16384, 5)
    blocks[2, 5000:9000] = blocks[2, 1000:5000]  # repeats across segments
    want = jmp.candidates(jnp.asarray(blocks), jnp.asarray(lengths), 6,
                          stride, window)
    got = tmp.candidates(t(blocks), t(lengths), 6, stride, window)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    kw = dict(neighbors=6, max_seq=4096, lazy=lazy, stride=stride,
              window=window)
    equal_dicts(tmp.find_matches_staged(t(blocks), t(lengths), **kw),
                jmp.find_matches_staged(jnp.asarray(blocks),
                                        jnp.asarray(lengths), **kw))


def test_fused_content_ldm_on_segments():
    """The reference's find_matches_fused(matcher="content") against the
    port's find_matches_packed, with LDM and window < N: the reference
    caps the parsed lengths at 16383 for its (ml << 18 | off) segment
    payload."""
    blocks, lengths = text_blocks(4, 16384, 6)
    blocks[3] = blocks[0]  # a long-distance repeat, longer than 16383
    kw = dict(neighbors=4, max_seq=4096, window=8192, ldm=4, lazy=True)
    want = np.asarray(jmp.find_matches_fused(
        jnp.asarray(blocks), jnp.asarray(lengths), **kw))
    got = tmp.find_matches_packed(t(blocks), t(lengths), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def jax_reference(kind: str = "parallel"):
    """The JAX sharded_pipeline and compression_step over the 8 virtual
    devices, on parallel_blocks: (out, stats) as numpy."""
    blocks, lengths = parallel_blocks()
    m = jmesh.make_mesh(jax.devices()[:8])
    out, stats = jmesh.compression_step(m, neighbors=2, max_seq=512)(
        jnp.asarray(blocks), jnp.asarray(lengths))
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: np.asarray(v) for k, v in stats.items()})


def test_sharded_pipeline_world_of_one():
    blocks, lengths = parallel_blocks()
    want_out, want_stats = jax_reference()
    m = mesh.make_mesh()
    assert isinstance(m, mesh.LocalMesh)
    got = mesh.sharded_pipeline(m, neighbors=2, max_seq=512,
                                device="cpu")(blocks, lengths)
    equal_dicts(got, want_out)
    out, stats = mesh.compression_step(m, neighbors=2, max_seq=512,
                                       device="cpu")(blocks, lengths)
    equal_dicts(out, want_out)
    equal_dicts(stats, want_stats)
    assert stats["total_sequences"].dtype == torch.int32


_WORKER = r"""
import os, sys
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
from qat_zstd_plugin_tpu_torch.parallel import distributed, mesh
distributed.init("file://" + store, world_size=world, rank=rank,
                 backend="gloo")
m = mesh.make_mesh()
rng = np.random.default_rng(0)
blocks = rng.integers(0, 8, (16, 2048), np.uint8).astype(np.uint8)
lengths = np.full(16, 2048, np.int32)
# Ranks hold 10 and 6 rows: the gather is ragged and ordered.
rows = slice(0, 10) if rank == 0 else slice(10, 16)
got = mesh.sharded_pipeline(m, neighbors=2, max_seq=512, device="cpu")(
    blocks[rows], lengths[rows])
o, stats = mesh.compression_step(m, neighbors=2, max_seq=512, device="cpu")(
    blocks[rows], lengths[rows])
for k in got:
    assert torch.equal(got[k], o[k]), k
np.savez(out + ".%%d.npz" %% rank,
         **{"out_" + k: v.numpy() for k, v in got.items()},
         **{"stats_" + k: v.numpy() for k, v in stats.items()})
torch.distributed.destroy_process_group()
print("rank", rank, "ok", flush=True)
sys.stderr.flush()
os._exit(0)
"""


def test_sharded_pipeline_two_gloo_ranks(tmp_path):
    """test_sharded_matches_unsharded's shape on two gloo ranks holding 10
    and 6 of the 16 rows: each rank's rows equal the JAX sharded output's
    rows, and every rank's stats equal compression_step's."""
    want_out, want_stats = jax_reference()
    src = _WORKER % {"repo": REPO}
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    out = str(tmp_path / "r")
    procs = [subprocess.Popen(
        [sys.executable, "-c", src, str(r), "2", str(tmp_path / "store"),
         out], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so.decode()[-500:], se.decode()[-3000:])
    for rank, rows in ((0, slice(0, 10)), (1, slice(10, 16))):
        got = np.load(f"{out}.{rank}.npz")
        for k, v in want_out.items():
            np.testing.assert_array_equal(got["out_" + k], v[rows], k)
        for k, v in want_stats.items():
            np.testing.assert_array_equal(got["stats_" + k], v, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitpack_equals_reference(seed):
    """tests/test_tpu_entropy.py's case: every output equals the JAX
    bitpack's, and the closed streams the golden BackwardBitWriter's."""
    rng = np.random.default_rng(seed)
    B, S, W = 3, 400, 500
    lo = np.zeros((B, S), np.uint32)
    hi = np.zeros((B, S), np.uint32)
    nb = np.zeros((B, S), np.int32)
    refs = []
    for b in range(B):
        w = BackwardBitWriter()
        for s in range(S):
            n = int(rng.integers(0, 65))
            if rng.integers(0, 5) == 0:
                n = 0
            v = int(rng.integers(0, 2 ** min(n, 63))) if n else 0
            nb[b, s] = n
            lo[b, s] = v & 0xFFFFFFFF
            hi[b, s] = (v >> 32) & 0xFFFFFFFF
            if n:
                w.add(v, n)
        refs.append(w.close())
    args = (lo.view(np.int32), hi.view(np.int32), nb)
    want = jbitpack.bitpack(*(jnp.asarray(a) for a in args), W)
    got = bitpack.bitpack(*(t(a) for a in args), W)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    assert not got[2].any()
    for b in range(B):
        stream = bitpack.backward_stream_bytes(got[0][b].numpy(),
                                               int(got[1][b]))
        assert stream == refs[b], b


@pytest.mark.parametrize("case", ["overflow_flag", "overflow_random",
                                  "unmasked_values"])
def test_bitpack_overflow_and_unmasked(case):
    """Rows past max_words (the words their first items hold are kept)
    and values with bits above nbits: equal to the reference word for
    word."""
    rng = np.random.default_rng(len(case))
    if case == "overflow_flag":  # test_bitpack_overflow_flag's input
        lo = np.ones((1, 100), np.int32)
        hi = np.zeros((1, 100), np.int32)
        nb = np.full((1, 100), 60, np.int32)
        W = 10
    else:
        B, S = 4, 300
        lo = rng.integers(-2 ** 31, 2 ** 31, (B, S)).astype(np.int32)
        hi = rng.integers(-2 ** 31, 2 ** 31, (B, S)).astype(np.int32)
        nb = rng.integers(0, 65, (B, S)).astype(np.int32)
        nb[1] = 64
        W = 300 if case == "overflow_random" else 700
    want = jbitpack.bitpack(jnp.asarray(lo), jnp.asarray(hi),
                            jnp.asarray(nb), W)
    got = bitpack.bitpack(t(lo), t(hi), t(nb), W)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    if case.startswith("overflow"):
        assert got[2].any()


def test_entry_equals_graft_entry():
    """entry("cpu")'s fn on its inputs equals the JAX entry()'s fn (Pallas
    in interpret mode) on the same bytes: level 1's slot words of 8
    blocks of 128 KiB."""
    jfn, (jblocks, jlengths) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jblocks, jlengths))
    fn, (blocks, lengths) = entry.entry("cpu")
    np.testing.assert_array_equal(blocks.numpy(), jblocks)
    np.testing.assert_array_equal(lengths.numpy(), jlengths)
    got = fn(blocks, lengths)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert (want != 0xFFFFFFFF).sum() > 0


def test_entry_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_two_ranks(capsys):
    """Two gloo ranks on the CPU: the positions step, the scaling table,
    and L1 and L9 frames equal to GpuCodec(batch=4)'s that decode."""
    report = entry.dryrun_multichip(2, device="cpu", timeout=300)
    assert report["claims"] > 0
    assert sorted(report["step_s"]) == [1, 2]
    assert all(s > 0 for s in report["step_s"].values())
    assert sorted(report["frames"]) == [1, 9]
    for fr in report["frames"].values():
        assert fr["batch"] == 4
        assert fr["frame_bytes"] < fr["input_bytes"]
    text = capsys.readouterr().out
    assert "positions step OK" in text and "n=2:" in text
