"""The port runs with jax and the JAX package unimportable.

tests/conftest.py imports jax into this process, so each check runs in a
subprocess whose import hook refuses jax, jaxlib and qat_zstd_plugin_tpu
(the exact top-level name: the port, qat_zstd_plugin_tpu_torch, stays
importable).
"""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)  # six test workers share a few cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "qat_zstd_plugin_tpu_torch")

BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'qat_zstd_plugin_tpu'):
            raise ImportError(name + ' is blocked')
        return None
sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, {repo!r})
"""

SCRIPTS = {
    "import": """
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch.ops import (_build, bitconcat, bitpack,
                                          fse_kernel, fse_tables,
                                          glue_kernels, huffman_tables,
                                          literals_kernel, match_pipeline,
                                          parse_kernel, sort_kernel)
from qat_zstd_plugin_tpu_torch.runtime import (device, gpu_codec, levels,
                                               stats, stream)
from qat_zstd_plugin_tpu_torch import (corpus, decoder, entry, format,
                                       fse_format, huffman_format,
                                       lz4s_format, native, oracle,
                                       profile_l1, xxhash)
from qat_zstd_plugin_tpu_torch.parallel import distributed, mesh, pipeline
from qat_zstd_plugin_tpu_torch.runtime import soft_codec
from qat_zstd_plugin_tpu_torch.tools import benchmark, cli, fuzz_decoder
from qat_zstd_plugin_tpu_torch.utils import (config, corpora, logging,
                                             profiling)
assert qzt.GpuCodec is gpu_codec.GpuCodec
assert 'jax' not in sys.modules
assert 'qat_zstd_plugin_tpu' not in sys.modules
print('ok')
""",
    "compress": """
import numpy as np
import qat_zstd_plugin_tpu_torch as qzt
rng = np.random.default_rng(0)
data = (rng.integers(0, 8, 131072 * 4 + 999, np.uint8)).tobytes()
for level, entropy in ((1, False), (5, False), (1, 'hybrid'), (5, True)):
    codec = qzt.GpuCodec(level=level, batch=4, device='cpu',
                         device_entropy=entropy)
    frame = codec.compress(data)
    assert qzt.decompress(frame, len(data)) == data
    assert codec.device_blocks == 4
assert 'jax' not in sys.modules
assert not any(m.split('.')[0] == 'qat_zstd_plugin_tpu' for m in sys.modules)
print('ok')
""",
    "producer": """
import numpy as np
import qat_zstd_plugin_tpu_torch as qzt
rng = np.random.default_rng(0)
data = (rng.integers(0, 8, 131072 * 2 + 999, np.uint8)).tobytes()
for level in (1, 9):
    frame = qzt.compress_via_libzstd(data, level=level, device='cpu')
    assert qzt.decompress(frame, len(data)) == data
frame = qzt.compress_stream_via_libzstd(data, device='cpu', flush_every=1)
assert qzt.decompress(frame, len(data)) == data
sc = qzt.StreamCompressor(level=1, batch=2, device='cpu')
frame = sc.compress(data) + sc.finish()
assert qzt.decompress(frame, len(data)) == data
assert 'jax' not in sys.modules
assert not any(m.split('.')[0] == 'qat_zstd_plugin_tpu' for m in sys.modules)
print('ok')
""",
    "decoder": """
import numpy as np
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import decoder, lz4s_format, native, oracle
rng = np.random.default_rng(0)
data = (rng.integers(0, 8, 131072 + 999, np.uint8)).tobytes()
frame = qzt.compress(data, level=1, batch=2, device='cpu')
assert decoder.decompress(frame) == data
oracle.available = lambda: False
assert qzt.decompress(frame, len(data)) == data
seqs = [lz4s_format.Sequence(3, 2, 5), lz4s_format.Sequence(0, 1, 0)]
stream = lz4s_format.encode(seqs, b'abc')
assert lz4s_format.decode(stream) == seqs
assert [a.tolist() for a in native.dec_lz4s(stream)] == [[2, 1], [3, 0],
                                                         [5, 0]]
assert 'jax' not in sys.modules
assert not any(m.split('.')[0] == 'qat_zstd_plugin_tpu' for m in sys.modules)
print('ok')
""",
    "mesh": """
import numpy as np
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch.parallel import mesh, pipeline
rng = np.random.default_rng(0)
data = (rng.integers(0, 8, 16384 * 5 + 999, np.uint8)).tobytes()
for level in (1, 9):
    frame = pipeline.compress_mesh(data, level=level, block_size=16384,
                                   device='cpu')
    assert qzt.decompress(frame, len(data)) == data
fn = mesh.sharded_positions_step(mesh.make_mesh(), window=16384,
                                 device='cpu')
assert fn(np.zeros((4, 16384), np.uint8), np.zeros(4, np.int32)).shape[0] == 4
assert 'jax' not in sys.modules
assert not any(m.split('.')[0] == 'qat_zstd_plugin_tpu' for m in sys.modules)
print('ok')
""",
    "rest": """
import numpy as np
import torch
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import entry
from qat_zstd_plugin_tpu_torch.ops import bitpack, match_pipeline, parse_kernel
from qat_zstd_plugin_tpu_torch.parallel import mesh
rng = np.random.default_rng(0)
data = (rng.integers(0, 8, 131072 + 999, np.uint8)).tobytes()
frame = qzt.compress_via_libzstd(data, level=1, device='host')
assert qzt.decompress(frame, len(data)) == data
fn, args = entry.entry('cpu', batch=4)
assert (fn(*args) != -1).sum() > 0
x = torch.from_numpy(np.frombuffer(data[:65536], np.uint8).reshape(2, 32768)
                     .copy())
n = torch.full((2,), 32768, dtype=torch.int32)
for matcher, window in (('content', 1 << 30), ('hash', 8192)):
    assert match_pipeline.find_matches_packed(
        x, n, matcher=matcher, window=window, max_seq=1024).shape == (
            2, 1025, 2)
out, stats = mesh.compression_step(mesh.make_mesh(), device='cpu')(x, n)
assert int(stats['total_sequences']) == int(out['nseq'].sum())
m = torch.randint(0, 30, (2, 8192), dtype=torch.int32)
assert parse_kernel.parse_greedy(m, True, 4).shape == (2, 8192)
w, bits, over = bitpack.bitpack(m, m, m % 33, 64)
assert w.shape == (2, 64)
assert 'jax' not in sys.modules
assert not any(m.split('.')[0] == 'qat_zstd_plugin_tpu' for m in sys.modules)
print('ok')
""",
    "tools": """
import os, tempfile
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.tools import benchmark, cli
data = make_corpus(131072 * 2 + 999, 0)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'in.bin')
    with open(path, 'wb') as f:
        f.write(data)
    assert benchmark.run([path, '-m', '2', '--json']) == 0
    assert benchmark.run([path, '-m', '1', '--device', 'cpu', '--batch',
                          '2', '--json']) == 0
    assert cli.run(['roundtrip', path, '--device', 'cpu']) == 0
    assert cli.run(['compress', path, '--cpu']) == 0
    assert cli.run(['decompress', path + '.zst', '-o', path + '.out']) == 0
    with open(path + '.out', 'rb') as f:
        assert f.read() == data
assert 'jax' not in sys.modules
assert not any(m.split('.')[0] == 'qat_zstd_plugin_tpu' for m in sys.modules)
print('ok')
""",
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_runs_with_jax_blocked(name):
    code = BLOCK_JAX.format(repo=REPO) + SCRIPTS[name]
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _port_sources():
    """Every .py of the port, and chip_smoke.py."""
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_import_in_the_port():
    """No import of jax, and none of the JAX package (only of the port,
    qat_zstd_plugin_tpu_torch), in any .py of the port or chip_smoke.py."""
    pattern = re.compile(r"^\s*(?:from|import)\s+(jax|qat_zstd_plugin_tpu)"
                         r"(?![\w])", re.M)
    for path in _port_sources():
        with open(path) as fh:
            src = fh.read()
        assert "import jax" not in src, path
        assert "from jax" not in src, path
        assert not pattern.findall(src), path
