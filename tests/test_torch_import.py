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
from qat_zstd_plugin_tpu_torch import (corpus, format, fse_format,
                                       huffman_format, native, oracle,
                                       profile_l1)
from qat_zstd_plugin_tpu_torch.parallel import distributed, mesh, pipeline
from qat_zstd_plugin_tpu_torch.utils import config
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
