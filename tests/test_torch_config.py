"""The port's process defaults (utils/config.py, the QZ_* variables)
against the JAX package's, on the CPU.

GpuCodec reads the defaults TpuCodec reads, and explicit arguments win.
QZ_FORCE_BACKEND is the one designed difference: "" (unset) and the
reference's "tpu" require the card here, as "cuda" does, and raise
without one; only "cpu" runs the twins. QZ_SECOND_PARSE=1's frame at
level 9 equals the JAX package's byte for byte.
"""

import dataclasses
import os

import pytest
import torch

import qat_zstd_plugin_tpu as qz
from qat_zstd_plugin_tpu.runtime.tpu_codec import TpuCodec
from qat_zstd_plugin_tpu.utils import config as jconfig
import qat_zstd_plugin_tpu_torch as qzt
from qat_zstd_plugin_tpu_torch import oracle
from qat_zstd_plugin_tpu_torch.corpus import make_corpus
from qat_zstd_plugin_tpu_torch.runtime.gpu_codec import GpuCodec
from qat_zstd_plugin_tpu_torch.utils import config

torch.set_num_threads(2)  # six test workers share a few cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARS = ("QZ_BATCH", "QZ_BLOCK_SIZE", "QZ_MAX_SEQ", "QZ_FORCE_BACKEND",
        "QZ_CHECKSUM", "QZ_DEBUG_LEVEL", "QZ_DEVICE_ENTROPY",
        "QZ_SECOND_PARSE")


@pytest.fixture
def env(monkeypatch):
    """Set QZ_* variables (all others unset) and re-read both packages'
    configs; both are reset afterwards."""
    for name in VARS:
        monkeypatch.delenv(name, raising=False)

    def set_vars(**kw):
        for name, value in kw.items():
            monkeypatch.setenv(name, value)
        config.set(None)
        jconfig.set(None)

    try:
        yield set_vars
    finally:
        config.set(None)
        jconfig.set(None)


def test_config_env(env):
    """Twin of tests/test_aux.py::test_config_env."""
    env(QZ_BATCH="4", QZ_CHECKSUM="0")
    cfg = config.Config.from_env()
    assert cfg.batch == 4 and cfg.checksum is False


ENVS = {
    "none": {},
    "all": dict(QZ_BATCH="3", QZ_BLOCK_SIZE="16384", QZ_MAX_SEQ="2048",
                QZ_FORCE_BACKEND="cpu", QZ_CHECKSUM="0", QZ_DEBUG_LEVEL="2",
                QZ_DEVICE_ENTROPY="Hybrid", QZ_SECOND_PARSE="1"),
    "bad_ints": dict(QZ_BATCH="eight", QZ_MAX_SEQ="", QZ_CHECKSUM="yes",
                     QZ_SECOND_PARSE="x", QZ_DEVICE_ENTROPY="FULL"),
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_config_fields_equal_reference(env, name):
    env(**ENVS[name])
    mine = dataclasses.asdict(config.Config.from_env())
    assert mine == dataclasses.asdict(jconfig.Config.from_env())
    assert list(mine) == [f.name for f in dataclasses.fields(jconfig.Config)]
    assert dataclasses.asdict(config.Config()) == \
        dataclasses.asdict(jconfig.Config())
    assert config.get() is config.get()


def test_config_drives_codec_defaults(env):
    """Twin of tests/test_aux.py::test_config_drives_codec_defaults: the
    frame equals TpuCodec(level=1, use_device=True)'s under the same
    variables."""
    env(QZ_BATCH="3", QZ_BLOCK_SIZE="16384", QZ_MAX_SEQ="2048",
        QZ_CHECKSUM="0", QZ_FORCE_BACKEND="cpu")
    c = GpuCodec(level=1)
    assert (c.batch, c.block_size, c.max_seq) == (3, 16384, 2048)
    assert c.device == torch.device("cpu")
    with open(os.path.join(REPO, "SURVEY.md"), "rb") as fh:
        data = fh.read()[:40000]
    f = c.compress(data)
    assert not (f[4] & 0x04)  # QZ_CHECKSUM=0: no content checksum
    assert oracle.decompress(f, len(data)) == data
    assert f == TpuCodec(level=1, use_device=True).compress(data)
    assert c.compress(data, checksum=True)[4] & 0x04
    # Explicit constructor arguments still win over the config.
    c2 = GpuCodec(level=1, batch=9, block_size=32768, max_seq=999,
                  device="cpu")
    assert (c2.batch, c2.block_size, c2.max_seq) == (9, 32768, 999)
    # The top-level compress keeps its explicit batch, block size and
    # checksum, as the reference's does.
    f3 = qzt.compress(data, level=1, device="cpu")
    assert f3[4] & 0x04
    assert f3 == qz.compress(data, level=1, use_device=True)


@pytest.mark.parametrize("value", [None, "", "tpu", "cuda"])
def test_force_backend_requires_the_card(env, value):
    """Unset, "", "tpu" and "cuda" all mean device="cuda": without a card
    GpuCodec raises, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device")
    env(**({} if value is None else {"QZ_FORCE_BACKEND": value}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuCodec(level=1)
    assert GpuCodec(level=1, device="cpu").device == torch.device("cpu")


def test_force_backend_cpu_and_bogus(env):
    env(QZ_FORCE_BACKEND="cpu")
    assert GpuCodec(level=4).device == torch.device("cpu")
    env(QZ_FORCE_BACKEND="bogus")
    with pytest.raises(ValueError, match="QZ_FORCE_BACKEND"):
        GpuCodec(level=1)
    assert GpuCodec(level=1, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("value", ["", "0", "off", "1", "full", "hybrid",
                                   "HYBRID", "Off"])
def test_device_entropy_env_maps_as_reference(env, value):
    env(QZ_DEVICE_ENTROPY=value, QZ_FORCE_BACKEND="cpu")
    got = GpuCodec(level=1).device_entropy
    assert got == TpuCodec(level=1).device_entropy
    assert got == {"": False, "0": False, "off": False, "1": True,
                   "full": True, "hybrid": "hybrid"}[value.lower()]
    # An explicit argument wins.
    assert GpuCodec(level=1, device_entropy=False).device_entropy is False


def test_device_entropy_env_typo_raises(env):
    env(QZ_DEVICE_ENTROPY="hybird", QZ_FORCE_BACKEND="cpu")
    with pytest.raises(ValueError, match="QZ_DEVICE_ENTROPY"):
        GpuCodec(level=1)
    with pytest.raises(ValueError, match="QZ_DEVICE_ENTROPY"):
        TpuCodec(level=1)
    assert GpuCodec(level=1, device_entropy="hybrid").device_entropy == \
        "hybrid"


def test_second_parse_opt_in(env):
    """Twin of tests/test_ratio_regression.py::test_second_parse_opt_in:
    QZ_SECOND_PARSE=1's level-9 frame equals TpuCodec's byte for byte,
    decodes, and is at most 1.001 times the default rule's frame."""
    data = make_corpus(512 << 10, seed=9)
    env()
    f_rule = GpuCodec(level=9, batch=4, device="cpu").compress(data)
    env(QZ_SECOND_PARSE="1")
    c2 = GpuCodec(level=9, batch=4, device="cpu")
    f_b2 = c2.compress(data)
    assert f_b2 == TpuCodec(level=9, batch=4, use_device=True).compress(data)
    assert oracle.decompress(f_b2, len(data)) == data
    assert len(f_b2) <= len(f_rule) * 1.001, (len(f_b2), len(f_rule))
    assert f_b2 != f_rule  # the option changes the frame
