"""When the port rebuilds a CUDA library: ``_device._stale`` on file times.

Needs no nvcc: the sources and the library are empty files in a temporary
``csrc/`` and ``build/kernels/`` with chosen modification times.
"""

import os

import pytest

from stedm_tpu_torch import _device


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build" / "kernels"
    csrc.mkdir()
    build.mkdir(parents=True)
    monkeypatch.setattr(_device, "CSRC", csrc)
    monkeypatch.setattr(_device, "BUILD_DIR", build)

    def touch(path, mtime):
        path.write_text("")
        os.utime(path, (mtime, mtime))

    return csrc, build, touch


def test_missing_library_is_stale(tree):
    csrc, _, touch = tree
    touch(csrc / "kern.cu", 1000)
    assert _device._stale("kern")


@pytest.mark.parametrize("cu,cuh,lib,stale", [
    (1000, 1000, 2000, False),   # newer than the source and the header
    (3000, 1000, 2000, True),    # the source was edited after the build
    (1000, 3000, 2000, True),    # a header was edited after the build
    (1000, None, 2000, False),   # no header at all
])
def test_library_older_than_source_or_header_is_stale(tree, cu, cuh, lib, stale):
    csrc, build, touch = tree
    touch(csrc / "kern.cu", cu)
    touch(csrc / "other.cu", 5000)               # another library's source does not count
    if cuh is not None:
        touch(csrc / "shared.cuh", cuh)
    touch(build / "libkern.so", lib)
    assert _device._stale("kern") is stale
