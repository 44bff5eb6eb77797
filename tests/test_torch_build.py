"""mxtpu_torch._build's library names: the hash in a kernel library's
name covers its source and every shared header under ``csrc/``, so an
edited kernel or header never loads a stale library. Runs without nvcc:
only the names are computed. Also the f32 rule of the CUDA-core (simt)
route, read from its sources: no tensor-core instruction and no TF32;
the parser of the compiler's report that ``chip_smoke.py`` phase 1 fails
a spill by; and the routes of ``kernel_sweep.py``'s cases (K5's
``decode`` cases: their spread of shapes)."""

import os
import re
import shutil

import pytest
import torch

import chip_smoke
import kernel_sweep
from mxtpu_torch import _build
from mxtpu_torch.ops import attention, quant_attention

SIMT_FILES = ("flash_fwd.cu", "flash_bwd.cu", "simt.cuh")


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


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_simt_library_names_follow_simt_header(csrc_copy, name):
    before = _build.lib_path(name)
    with open(csrc_copy / "simt.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.lib_path(name) != before


@pytest.mark.parametrize("fname", SIMT_FILES)
def test_simt_sources_stay_f32(fname):
    """The simt route sums f32 on the CUDA cores: its code (comments aside)
    names no TF32 type or conversion and no tensor-core product."""
    with open(os.path.join(_build._PKG, "csrc", fname)) as f:
        src = f.read()
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S).lower()
    for word in ("tf32", "mma.sync", "wgmma", "mma_sync", "wmma"):
        assert word not in code, f"{fname} uses {word}"


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__ab_12_flash_bwd_cu_cd19flash_bwd_dq_kernelIfLi64EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__ab_12_flash_bwd_cu_cd19flash_bwd_dq_kernelIfLi64EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Function properties for _ZN45_GLOBAL__N__ab_12_flash_bwd_cu_cd22flash_bwd_fused_kernelI13__nv_bfloat16Li256EEEvNS_4ArgsE
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16 bytes cumulative stack size
"""


def test_ptxas_report_names_each_instantiation():
    assert chip_smoke.simt_instantiations(PTXAS_LOG) == [
        ("flash_bwd_dq_kernel", "f32", 64, 168, 0, 0),
        ("flash_bwd_fused_kernel", "bf16", 256, 255, 12, 8)]


@pytest.mark.parametrize("kind", ["fwd", "dq", "bwd", "fused", "simt-fwd",
                                  "simt-dq", "simt-bwd", "simt-fused",
                                  "decode"])
def test_sweep_cases_take_their_kinds_route(kind):
    cases = kernel_sweep.cases_of(kind)
    assert cases and any(c[-1] for c in cases)  # checked and timed shapes
    if kind == "decode":
        # K5 has one route; its cases span the slots, buckets, head dims,
        # caches and q dtypes it takes, and every case it splits runs more
        # than one block a (slot, head)
        assert {c[0] for c in cases} == {1, 8, 32}
        assert {c[2] for c in cases} == {32, 96, 256, 704, 1024, 2048}
        assert {c[3] for c in cases} == {40, 64, 128, 256, 512}
        assert {c[4] for c in cases} == {"int8", "fp8"}
        assert {c[5] for c in cases} == {"float32", "bfloat16"}
        for S, H, TOT, D, *_ in cases:
            assert quant_attention._chunk(S, H, TOT, D, 132, 32) % 32 == 0
            assert D <= quant_attention._DMAX
        # cases whose cursors all sit in chunk 0 of a split cache, checked
        # through a kernel that reads the output in the same CUDA graph
        assert {c[0] for c in cases if c[6] == "early"} == {1, 8}
        return
    route, base = kernel_sweep.split_kind(kind)
    for c in cases:
        D, dtype = c[4], getattr(torch, c[-2])
        assert attention._fwd_route(dtype, D) == route, c
        assert base != "fused" or c[2] == c[3], c
