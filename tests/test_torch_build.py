"""mxtpu_torch._build's library names: the hash in a kernel library's
name covers its source and every shared header under ``csrc/``, so an
edited kernel or header never loads a stale library. Runs without nvcc:
only the names are computed."""

import os
import shutil

import pytest

from mxtpu_torch import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """The package's sources copied to a scratch package directory."""
    shutil.copytree(os.path.join(_build._PKG, "csrc"), tmp_path / "csrc")
    monkeypatch.setattr(_build, "_PKG", str(tmp_path))
    return tmp_path / "csrc"


@pytest.mark.parametrize("edited", ["flash_fwd_sm90.cu", "sm90.cuh"])
def test_library_name_follows_source_and_headers(csrc_copy, edited):
    before = _build.lib_path("flash_fwd_sm90")
    with open(csrc_copy / edited, "a") as f:
        f.write("\n// edited\n")
    assert _build.lib_path("flash_fwd_sm90") != before


def test_library_name_is_stable(csrc_copy):
    assert _build.lib_path("flash_bwd_sm90") == _build.lib_path(
        "flash_bwd_sm90")
    assert _build.lib_path("flash_fwd_sm90") != _build.lib_path(
        "flash_bwd_sm90")


def test_every_source_is_listed():
    """Every kernel source in ``csrc/`` builds: it is in SOURCES."""
    csrc = os.path.join(_build._PKG, "csrc")
    listed = {os.path.basename(p) for p in _build.SOURCES.values()}
    assert listed == {f for f in os.listdir(csrc) if f.endswith(".cu")}
