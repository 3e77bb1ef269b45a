"""The kernel library's build key, without nvcc: every file under csrc/
(headers included) and the flags pick the library's directory."""

import os
import shutil

import torch

from qat_zstd_plugin_tpu_torch.ops import _build

torch.set_num_threads(2)  # six test workers share a few cores


def _copy(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return csrc


def test_unchanged_sources_reuse_the_library(tmp_path):
    csrc = _copy(tmp_path)
    assert _build.library_path(str(csrc)) == _build.library_path(str(csrc))
    assert _build.library_path(str(csrc)) == _build.library_path()
    assert os.path.basename(_build.library_path()) == _build.LIB_NAME


def test_a_header_edit_changes_the_library(tmp_path):
    csrc = _copy(tmp_path)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc/ has a shared header"
    before = _build.library_path(str(csrc))
    with open(headers[0], "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path(str(csrc)) != before


def test_a_source_edit_or_new_file_changes_the_library(tmp_path):
    csrc = _copy(tmp_path)
    before = _build.library_path(str(csrc))
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = _build.library_path(str(csrc))
    assert added != before
    src = sorted(csrc.glob("*.cu"))[0]
    src.write_text(src.read_text() + "\n")
    assert _build.library_path(str(csrc)) not in (before, added)


def test_every_source_is_compiled_and_bound():
    """One nvcc per .cu file; every entry point has argument types."""
    names = [os.path.basename(s) for s in _build._sources()]
    assert names == ["content_kernels.cu", "dense_kernels.cu",
                     "fse_kernels.cu", "l1_kernels.cu",
                     "literals_kernels.cu", "parsed_kernels.cu",
                     "sort_kernels.cu", "verified_kernels.cu"]
    text = "".join(open(s).read() for s in _build._sources())
    for name, argtypes in _build.SIGNATURES.items():
        assert f"int {name}(" in text, name
        assert argtypes[-1] is _build._P  # the stream
        # As many C parameters as ctypes argument types.
        params = text.split(f"int {name}(", 1)[1].split(")", 1)[0]
        assert params.count(",") + 1 == len(argtypes), name
