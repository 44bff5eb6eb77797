"""``mxtpu_torch.rtc`` (K6) where there is no card.

rtc compiles CUDA C with NVRTC and launches it through the driver API, so
its kernels run only on the card (``chip_smoke.py`` phases 11 and 12 hold
them against their plain versions there). What runs here: the signature
grammar, the export and name rules, the refusals without CUDA and of CPU
arrays, the argument checks made before any launch, and the user kernels
of ``chip_smoke.py`` checked against the argument layout their signatures
declare.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
import mxtpu_torch
from mxtpu_torch import nd, rtc
from mxtpu_torch.rtc import KernelArg


@pytest.fixture(autouse=True)
def _on_cpu():
    with mxtpu_torch.Context("cpu"):
        yield


def test_parse_signature_types_pointers_and_scalars():
    args = rtc.parse_signature("const float *x, float* y ,double alpha, int n,"
                               " const __half *h, int64_t k, uint8_t *m")
    assert args == [
        KernelArg(True, "float", True, "x"), KernelArg(False, "float", True, "y"),
        KernelArg(False, "double", False, "alpha"),
        KernelArg(False, "int", False, "n"),
        KernelArg(True, "__half", True, "h"),
        KernelArg(False, "int64_t", False, "k"),
        KernelArg(False, "uint8_t", True, "m")]
    assert rtc.parse_signature("  ") == []
    assert rtc.parse_signature("float *") == [KernelArg(False, "float", True,
                                                        "")]


@pytest.mark.parametrize("bad,exc", [
    ("float x y", ValueError), ("const", ValueError), ("float **x", ValueError),
    ("const float x", ValueError), ("long double x", ValueError),
    ("unsigned *x", TypeError), ("float16 *x", TypeError),
])
def test_parse_signature_refuses_bad_strings(bad, exc):
    with pytest.raises(exc):
        rtc.parse_signature(bad)


def test_exports_lower_and_undeclared_templates_refuse():
    mod = rtc.CudaModule.__new__(rtc.CudaModule)   # no card: no compile
    mod.exports = ("axpy<float>",)
    mod._lowered = {"axpy<float>": "_Z4axpyIfEvPKT_PS0_S0_i"}
    assert mod.lowered_name("axpy<float>") == "_Z4axpyIfEvPKT_PS0_S0_i"
    assert mod.lowered_name("saxpy") == "saxpy"      # extern "C": as written
    with pytest.raises(ValueError, match="not in exports"):
        mod.lowered_name("axpy<double>")


def test_module_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: CudaModule compiles there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rtc.CudaModule(chip_smoke.SAXPY_SRC)


def _saxpy():
    """saxpy's kernel object without a module: launch checks its
    arguments before it touches a module or the driver."""
    return rtc.CudaKernel(None, "saxpy", "saxpy", chip_smoke.SAXPY_SIG)


@pytest.mark.parametrize("case,exc,needle", [
    ("cpu arrays", ValueError, "CPU NDArray"),
    ("cpu ctx", ValueError, "not a GPU context"),
    ("dtype", TypeError, "must be torch.float32"),
    ("count", ValueError, "takes 5 arguments"),
    ("not an array", TypeError, "must be an NDArray"),
    ("scalar type", TypeError, "must be a number"),
    ("fractional int", TypeError, "must be an integer"),
    ("int range", ValueError, "does not fit in int"),
])
def test_launch_refuses_before_any_launch(case, exc, needle):
    x = nd.array(np.ones(8, np.float32))
    args = [x, x, x, 2.5, 8]
    ctx = mxtpu_torch.gpu(0)
    if case == "cpu ctx":
        ctx = mxtpu_torch.cpu()
    elif case == "dtype":
        args[0] = x.astype("float64")
    elif case == "count":
        args = args[:3]
    elif case == "not an array":
        args[1] = np.ones(8, np.float32)
    elif case == "scalar type":
        args[3] = "2.5"
    elif case == "fractional int":
        args[4] = 8.5
    elif case == "int range":
        args[4] = 2 ** 40
    k = _saxpy()
    with pytest.raises(exc, match=needle):
        k.launch(args, ctx, (1,), (8,))
    assert k.launches == 0


def _params(source, name, **subst):
    """The parameter list of kernel ``name`` in CUDA source, with template
    types substituted."""
    m = re.search(r"__global__\s+void\s+" + name + r"\s*\(([^)]*)\)", source)
    assert m, name
    params = m.group(1)
    for t, v in subst.items():
        params = re.sub(rf"\b{t}\b", v, params)
    return params


@pytest.mark.parametrize("source,name,sig,subst", [
    ("SAXPY_SRC", "saxpy", chip_smoke.SAXPY_SIG, {}),
    ("SAXPY_SRC", "tile_double", chip_smoke.TILE_SIG, {}),
    ("SAXPY_SRC", "segment_reverse", chip_smoke.REVERSE_SIG, {}),
    ("AXPY_SRC", "axpy", "const float *x, float *y, float alpha, int n",
     {"T": "float"}),
    ("AXPY_SRC", "axpy", "const double *x, double *y, double alpha, int n",
     {"T": "double"}),
    ("CE_SRC", "softmax_ce_fwd", chip_smoke.CE_FWD_SIG, {}),
    ("CE_SRC", "softmax_ce_bwd", chip_smoke.CE_BWD_SIG, {}),
])
def test_smoke_kernels_declare_their_argument_layout(source, name, sig,
                                                     subst):
    """The signature each smoke kernel is fetched with is its parameter
    list: the same C types, pointers, constness and names."""
    declared = _params(getattr(chip_smoke, source), name, **subst)
    assert rtc.parse_signature(declared) == rtc.parse_signature(sig)
