"""The block sizes the port refuses, and the ones it takes, against the
JAX package, on the CPU.

A zstd block holds at most 128 KiB (RFC 8878, Block_Maximum_Size), so
GpuCodec and SoftwareCodec refuse a block size outside 1..131072 at
construction, whether it is an argument or QZ_BLOCK_SIZE; every entry
point builds one of the two. The reference takes any size and writes a
frame libzstd rejects. GpuCodec also refuses a size its level's device
route cannot tile (runtime/gpu_codec.check_block_size): the hash levels
1-4 need whole segments of min(32768, block) bytes, a multiple of 4, and
a power of two where the byte-verified matcher runs (hybrid and full
device entropy), full device entropy a multiple of 4 at every level. The
content levels 5-12 take any other size, and their frames equal the
reference's.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qat_zstd_plugin_tpu.ops import glue_kernels as gk
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu.utils import config as jconfig

import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import oracle
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.ops import glue_kernels as tk
from qat_zstd_plugin_tpu_torch.parallel import pipeline
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import (GpuCodec,
                                                          check_block_size)
from qat_zstd_plugin_tpu_torch.runtime.soft_codec import SoftwareCodec
from qat_zstd_plugin_tpu_torch.tools import benchmark, cli
from qat_zstd_plugin_tpu_torch.utils import config

torch.set_num_threads(2)  # six test workers share a few cores

OUTSIDE = (131073, 196608, 262144, 0, -1)
UNTILED = (100000, 40000, 49152)  # not whole 32 KiB segments
CODECS = {"GpuCodec": lambda bs: GpuCodec(level=1, block_size=bs,
                                          device="cpu"),
          "SoftwareCodec": lambda bs: SoftwareCodec(1, block_size=bs)}


@pytest.fixture
def qz_block_size(monkeypatch):
    """Set QZ_BLOCK_SIZE for both packages' configs; reset afterwards."""
    def set_size(value: str):
        monkeypatch.setenv("QZ_BLOCK_SIZE", value)
        config.set(None)
        jconfig.set(None)
    try:
        yield set_size
    finally:
        monkeypatch.delenv("QZ_BLOCK_SIZE", raising=False)
        config.set(None)
        jconfig.set(None)


@pytest.mark.parametrize("size", OUTSIDE)
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_codecs_refuse_sizes_outside_the_format(codec, size):
    with pytest.raises(ValueError, match=r"outside 1\.\.131072.*RFC 8878"):
        CODECS[codec](size)


@pytest.mark.parametrize("size", UNTILED)
@pytest.mark.parametrize("level,entropy", [(1, False), (2, False),
                                           (3, False), (4, False),
                                           (1, "hybrid")])
def test_hash_levels_refuse_untiled_sizes(level, entropy, size):
    """Refused at construction, naming the segment rule, where the codec
    used to fail at its first batch."""
    with pytest.raises(ValueError, match=rf"block_size={size}: level "
                       rf"{level} .*whole number of segments of "
                       r"min\(window 32768"):
        GpuCodec(level=level, block_size=size, device="cpu",
                 device_entropy=entropy)


@pytest.mark.parametrize("level", [5, 9])
def test_content_levels_take_100000(level):
    """The content route runs at 100000 and equals the reference."""
    data = make_corpus(2 * 100000 + 777, seed=level)
    kw = dict(level=level, batch=2, block_size=100000)
    got = GpuCodec(device="cpu", **kw).compress(data)
    assert got == TpuCodec(**kw).compress(data)
    assert oracle.decompress(got, len(data)) == data


@pytest.mark.parametrize("level,size", [(5, 3), (7, 5), (9, 5), (9, 7)])
def test_content_levels_take_tiny_blocks(level, size):
    """Blocks shorter than a level's neighbour count: the candidates'
    row shifts past the row (glue_kernels._shr) fill the whole row, as
    the reference's do; frames equal and decode."""
    data = make_corpus(5 * size + 2, seed=size)
    kw = dict(level=level, batch=2, block_size=size)
    got = GpuCodec(device="cpu", **kw).compress(data)
    assert got == TpuCodec(**kw).compress(data)
    assert oracle.decompress(got, len(data)) == data


@pytest.mark.parametrize("entropy,size,refused", [
    (False, 100001, False), ("hybrid", 100001, False),
    (True, 100000, False), (True, 100001, True), (True, 100002, True),
    (False, 1, False), (True, 4, False)])
def test_content_level_rule(entropy, size, refused):
    """L5-L12 take every size but full device entropy's four literal
    streams' (a multiple of 4)."""
    for level in (5, 9, 12):
        if refused:
            with pytest.raises(ValueError, match="four literal streams"):
                check_block_size(level, size, entropy)
        else:
            check_block_size(level, size, entropy)


@pytest.mark.parametrize("size,tiles", [(4, True), (8, True), (6, False),
                                        (1000, "host"), (16384, True),
                                        (65536, True), (98304, True),
                                        (131072, True), (4000, "host"),
                                        (6144, "host"), (24576, "host")])
def test_hash_level_rule(size, tiles):
    """Whole segments, a multiple of 4; a power of two with device
    entropy ("host": only with host entropy)."""
    for entropy in (False, "hybrid", True):
        ok = tiles is True or (tiles == "host" and not entropy)
        for level in (1, 2, 3, 4):
            if ok:
                check_block_size(level, size, entropy)
            else:
                with pytest.raises(ValueError, match="segments"):
                    check_block_size(level, size, entropy)


@pytest.mark.parametrize("op", ["hash_keys", "gram_pos_planes",
                                "hash_keys_winmin_sync"])
def test_geometry_shares_the_codec_rule(op):
    """The kernels' geometry raises the rule the codec names, from the
    same predicate (K1 with its own multiple, 2)."""
    x = torch.zeros((1, 40000), dtype=torch.uint8)
    call = {"hash_keys": lambda: tk.hash_keys(x, 6, 32768),
            "gram_pos_planes": lambda: tk.gram_pos_planes(x, 32768),
            "hash_keys_winmin_sync": lambda: tk.hash_keys_winmin_sync(
                x, 6, 32768, 0)}[op]
    rule = tk.segment_rule(40000, 32768,
                           2 if op == "hash_keys_winmin_sync" else 4)
    with pytest.raises(ValueError) as e:
        call()
    assert str(e.value) == rule
    with pytest.raises(ValueError) as e:
        check_block_size(2, 40000, False)
    assert str(e.value).endswith(tk.segment_rule(40000, 32768, 4))


def test_reference_writes_a_frame_libzstd_rejects():
    """The reference's fault, pinned without editing it: a 262144-byte
    block makes a frame stock libzstd refuses."""
    data = make_corpus(300000, seed=1)
    frame = TpuCodec(level=1, batch=1, block_size=262144).compress(data)
    with pytest.raises(oracle.ZstdOracleError):
        oracle.decompress(frame, len(data))


def test_reference_verified_matcher_needs_a_power_of_two():
    """The reference's byte-verified matcher at a 6144-byte segment: its
    positions i & 6143 are not the column, so it claims matches whose
    bytes differ (the port refuses the size for device entropy)."""
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 4, (1, 6144), np.uint8)
    lengths = np.full(1, 6144, np.int32)
    ml, mo = (np.asarray(a)[0] for a in gk.candidates_hash_verified(
        jnp.asarray(blocks), jnp.asarray(lengths), 2, 32768))
    row = blocks[0]
    false = [p for p in np.flatnonzero(ml)
             if mo[p] > p or (row[p:p + 4] != row[p - mo[p]:p - mo[p] + 4])
             .any()]
    assert false, "every claim was true"


def _entry_points(size: int):
    data = make_corpus(3000, seed=2)
    return {
        "compress": lambda: qzt.compress(data, block_size=size,
                                         device="cpu"),
        "StreamCompressor": lambda: qzt.StreamCompressor(
            block_size=size, device="cpu"),
        "SeqProdState": lambda: qzt.create_seqprod_state(
            1, block_size=size, device="cpu"),
        "compress_mesh": lambda: pipeline.compress_mesh(
            data, block_size=size, device="cpu"),
    }


@pytest.mark.parametrize("entry", ["compress", "StreamCompressor",
                                   "SeqProdState", "compress_mesh"])
@pytest.mark.parametrize("size", [262144, 100000])
def test_entry_points_inherit_the_refusal(entry, size):
    with pytest.raises(ValueError, match=f"block_size={size}"):
        _entry_points(size)[entry]()


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_qz_block_size_is_refused(qz_block_size, codec):
    qz_block_size("262144")
    make = {"GpuCodec": lambda: GpuCodec(device="cpu"),
            "SoftwareCodec": lambda: SoftwareCodec()}[codec]
    with pytest.raises(ValueError, match=r"QZ_BLOCK_SIZE=262144 is outside"):
        make()


@pytest.mark.parametrize("argv", [["-m", "1", "--device", "cpu"],
                                  ["-m", "0"]])
def test_benchmark_reports_the_refusal(qz_block_size, tmp_path, argv):
    """The tools build their codecs from QZ_BLOCK_SIZE: the benchmark's
    thread fails with the codec's error and the run returns non-zero."""
    path = tmp_path / "in.bin"
    path.write_bytes(make_corpus(5000, seed=4))
    qz_block_size("262144")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = benchmark.run([str(path), *argv, "-l", "1"])
    assert rc != 0
    assert "QZ_BLOCK_SIZE=262144" in out.getvalue()


@pytest.mark.parametrize("flags", [["--device", "cpu"], ["--cpu"]])
def test_cli_refuses(qz_block_size, tmp_path, flags):
    path = tmp_path / "in.bin"
    path.write_bytes(make_corpus(5000, seed=4))
    qz_block_size("262144")
    with pytest.raises(ValueError, match="QZ_BLOCK_SIZE=262144"):
        cli.run(["roundtrip", str(path), *flags])


def test_qz_block_size_inside_the_rule_is_taken(qz_block_size):
    qz_block_size("16384")
    assert GpuCodec(device="cpu").block_size == 16384
    assert SoftwareCodec().block_size == 16384
