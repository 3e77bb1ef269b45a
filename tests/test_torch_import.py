"""The port runs with jax unimportable.

tests/conftest.py imports jax into this process, so each check runs in a
subprocess whose import hook refuses jax and jaxlib.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "qat_zstd_plugin_tpu_torch")

BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib'):
            raise ImportError('jax is blocked')
        return None
sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, {repo!r})
"""

SCRIPTS = {
    "import": """
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch.ops import _build, glue_kernels, match_pipeline
from qat_zstd_plugin_tpu_torch.runtime import device, gpu_codec
from qat_zstd_plugin_tpu_torch import corpus, profile_l1
assert qzt.GpuCodec is gpu_codec.GpuCodec
assert 'jax' not in sys.modules
print('ok')
""",
    "compress": """
import numpy as np
import qat_zstd_plugin_tpu_torch as qzt
rng = np.random.default_rng(0)
data = (rng.integers(0, 8, 131072 * 4 + 999, np.uint8)).tobytes()
codec = qzt.GpuCodec(level=1, batch=4, device='cpu')
frame = codec.compress(data)
assert qzt.decompress(frame, len(data)) == data
assert codec.device_blocks == 4
assert 'jax' not in sys.modules
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


def test_no_jax_import_in_the_port():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                assert "import jax" not in src, f
                assert "from jax" not in src, f
