"""Every op of the port's registry against the JAX package's, on the CPU.

The ops of ``ops/{elementwise,reduce,matrix,init_ops,random,nn,
optimizer_ops,sequence,rnn}.py`` and the ``Custom`` op are registered in
both packages under the same names (the update ops' pure functions here;
their in-place ``nd`` wrappers in ``tests/test_torch_optimizers.py``).
One parametrised test runs each registered name (aliases included) in
both packages on the same numpy inputs and compares the outputs: float
results within 1e-5 relative + 1e-6 absolute (f32 reassociation between
two implementations of the same sums), integer and index results exactly,
dtypes equal. For a differentiable op the gradients of ``sum(out * c)``
(``c`` a fixed random cotangent) with respect to its float inputs are
compared too: the port's through its ``autograd``, the JAX package's
through ``jax.vjp`` of its registered function. Random ops draw from
different generators (threefry against torch's), so for them the test
holds shapes and dtypes equal and checks that a seed reproduces the draws;
their moments are checked in ``tests/test_torch_ndarray.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu
import mxtpu.operator  # noqa: F401  (registers Custom)
from mxtpu import rng as jrng
from mxtpu.ops import registry as jreg

import mxtpu_torch
from mxtpu_torch import autograd as tag
from mxtpu_torch import nd as tnd
from mxtpu_torch import rng as trng
from mxtpu_torch.ops import registry as treg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6

SLICE_MODULES = ("elementwise", "reduce", "matrix", "init_ops", "random",
                 "nn", "operator", "optimizer_ops", "attention",
                 "quantization", "sequence", "rnn")
# ops of those modules that wait for a later slice (SyncBatchNorm needs
# parallel/collectives)
WAITING = {"contrib.SyncBatchNorm", "contrib._contrib_SyncBatchNorm"}
# every module whose ops the port registers: the slice's, the ``nd.image``
# ops, held to the JAX package in tests/test_torch_image.py, the detection
# slice's, held to it in tests/test_torch_detection.py, and ``linalg``,
# held to it in tests/test_torch_linalg.py
REGISTERED_MODULES = SLICE_MODULES + ("image_ops", "order", "contrib_ops",
                                      "detection", "spatial", "linalg")


@pytest.fixture(autouse=True)
def _on_cpu():
    with mxtpu_torch.Context("cpu"):
        yield


def U(*shape, lo=-2.0, hi=2.0):
    return lambda rs: rs.uniform(lo, hi, shape).astype(np.float32)


def I(*shape, hi=3):
    return lambda rs: rs.randint(0, hi, shape).astype(np.float32)


def K(value):
    return lambda rs: np.asarray(value)


def case(*args, grad=True, **kwargs):
    return (args, kwargs, grad)


_POS = dict(lo=0.5, hi=2.0)
_UNIT = dict(lo=-0.9, hi=0.9)
_UNARY_DOMAIN = {
    "log": _POS, "log1p": _POS, "log2": _POS, "log10": _POS, "sqrt": _POS,
    "rsqrt": _POS, "reciprocal": _POS, "gammaln": _POS, "gamma": _POS,
    "rcbrt": _POS, "arcsin": _UNIT, "arccos": _UNIT, "arctanh": _UNIT,
    "erfinv": _UNIT, "arccosh": dict(lo=1.1, hi=3.0),
}
_UNARY = ["abs", "sign", "ceil", "floor", "round", "rint", "trunc", "fix",
          "exp", "expm1", "log", "log1p", "log2", "log10", "sqrt", "rsqrt",
          "cbrt", "square", "reciprocal", "negative", "sin", "cos", "tan",
          "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
          "arccosh", "arctanh", "degrees", "radians", "erf", "erfinv",
          "gammaln", "logical_not", "isnan", "isinf", "isfinite", "gamma",
          "rcbrt", "relu", "sigmoid", "softsign", "softrelu"]

CASES = {n: [case(U(3, 4, **_UNARY_DOMAIN.get(n, {})))] for n in _UNARY}
CASES["gamma"].append(case(K(np.array([-1.5, -0.5, 0.5, 2.5, 4.0],
                                      np.float32))))
CASES["abs"].append(case(K(np.array([[-3, 0, 2]], np.int32)), grad=False))
CASES.update({
    "hard_sigmoid": [case(U(3, 4), alpha=0.3, beta=0.4)],
    "clip": [case(U(3, 4), a_min=-0.5, a_max=1.0)],
    "smooth_l1": [case(U(3, 4), scalar=1.5)],
    "_grad_add": [case(U(3, 4), U(3, 4))],
    "add_n": [case(U(3, 4), U(3, 4), U(3, 4))],
    "_square_sum": [case(U(2, 3, 4), axis=(0, 2), keepdims=True),
                    case(U(2, 3, 4))],
})
for n in ["add", "subtract", "multiply", "maximum", "minimum", "hypot",
          "arctan2", "rsubtract"]:
    CASES[n] = [case(U(3, 4), U(1, 4)), case(U(3, 4), K(np.float32(1.5)))]
for n in ["divide", "mod", "rdivide", "rmod"]:
    CASES[n] = [case(U(3, 4, **_POS), U(1, 4, **_POS))]
CASES["mod"].append(case(U(3, 4), K(np.float32(0.75)), grad=False))
CASES["add"].append(case(K(np.arange(6, dtype=np.int32).reshape(2, 3)),
                         K(np.int32(2)), grad=False))
for n in ["power", "rpower"]:
    CASES[n] = [case(U(3, 4, **_POS), U(1, 4))]
for n in ["equal", "not_equal", "greater", "greater_equal", "lesser",
          "lesser_equal", "logical_and", "logical_or", "logical_xor"]:
    CASES[n] = [case(I(3, 4), I(1, 4))]
for n in ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_maximum_scalar", "_minimum_scalar", "_hypot_scalar"]:
    CASES[n] = [case(U(3, 4), scalar=0.7)]
for n in ["_div_scalar", "_rdiv_scalar", "_power_scalar", "_mod_scalar",
          "_rmod_scalar", "_rpower_scalar"]:
    CASES[n] = [case(U(3, 4, **_POS), scalar=1.3)]
for n in ["_equal_scalar", "_not_equal_scalar", "_greater_scalar",
          "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar",
          "_logical_and_scalar", "_logical_or_scalar", "_logical_xor_scalar"]:
    CASES[n] = [case(I(3, 4), scalar=1.0)]

# reductions
for n in ["sum", "mean", "prod", "nansum", "nanprod", "max", "min"]:
    CASES[n] = [case(U(2, 3, 4), axis=1), case(U(2, 3, 4), axis=(0, 2),
                                                keepdims=True),
                case(U(2, 3, 4), axis=1, exclude=True), case(U(2, 3, 4))]
CASES["sum"] += [case(K(np.arange(12, dtype=np.int32).reshape(3, 4)),
                      axis=0, grad=False),
                 case(U(2, 3), axis=())]
CASES["mean"].append(case(K(np.arange(12, dtype=np.int32).reshape(3, 4)),
                          axis=1, grad=False))
CASES["nansum"].append(case(K(np.array([[1.0, np.nan], [2.0, 3.0]],
                                       np.float32)), axis=1, grad=False))
for n in ["all", "any"]:
    CASES[n] = [case(I(3, 4, hi=2), axis=1), case(I(3, 4, hi=2))]
CASES.update({
    "argmax": [case(U(3, 4), axis=1), case(U(3, 4)),
               case(U(3, 4), axis=0, keepdims=True)],
    "argmin": [case(U(3, 4), axis=1), case(U(3, 4))],
    "argmax_channel": [case(U(3, 4))],
    "norm": [case(U(3, 4)), case(U(3, 4), ord=1, axis=1, keepdims=True)],
    "L2Normalization": [case(U(2, 3, 4)), case(U(2, 3, 4), mode="channel"),
                        case(U(2, 3, 4), mode="spatial")],
    "histogram": [case(U(20, lo=0.0, hi=1.0), bin_cnt=5, range=(0.0, 1.0)),
                  case(U(20), bins=4),
                  case(U(20), bins=K(np.array([-2.0, -0.5, 0.0, 1.0, 2.0],
                                              np.float32)))],
})

# matrix
CASES.update({
    "dot": [case(U(3, 4), U(4, 5)), case(U(4, 3), U(4, 5), transpose_a=True),
            case(U(3, 4), U(5, 4), transpose_b=True), case(U(4), U(4)),
            case(U(2, 3, 4), U(4, 5))],
    "batch_dot": [case(U(2, 3, 4), U(2, 4, 5)),
                  case(U(2, 4, 3), U(2, 5, 4), transpose_a=True,
                       transpose_b=True)],
    "khatri_rao": [case(U(3, 2), U(4, 2))],
    "reshape": [case(U(2, 3, 4), shape=(0, -1)), case(U(2, 3, 4), shape=(-3, 0)),
                case(U(2, 3, 4), shape=(-4, 1, 2, -2)),
                case(U(2, 3, 4), shape=(4, -1), reverse=True),
                case(U(2, 3, 4), shape=(-2,))],
    "reshape_like": [case(U(2, 6), U(3, 4))],
    "flatten": [case(U(2, 3, 4))],
    "transpose": [case(U(2, 3, 4)), case(U(2, 3, 4), axes=(1, 0, 2))],
    "swapaxes": [case(U(2, 3, 4), dim1=0, dim2=2)],
    "expand_dims": [case(U(2, 3), axis=1)],
    "squeeze": [case(U(2, 1, 3, 1)), case(U(2, 1, 3, 1), axis=1)],
    "broadcast_to": [case(U(1, 4), shape=(3, 4)), case(U(3, 1), shape=(0, 4))],
    "broadcast_like": [case(U(1, 4), U(3, 4))],
    "broadcast_axis": [case(U(1, 4, 1), axis=(0, 2), size=(2, 3))],
    "cast": [case(U(3, 4, lo=-9, hi=9), dtype="int32"),
             case(U(3, 4), dtype="float16"), case(U(3, 4), dtype="uint8"),
             case(I(3, 4), dtype="bool")],
    "stop_gradient": [case(U(3, 4))],
    "identity": [case(U(3, 4))],
    "shape_array": [case(U(2, 3, 4))],
    "size_array": [case(U(2, 3, 4))],
    "concat": [case(U(2, 3), U(2, 4)), case(U(2, 3), U(1, 3), dim=0)],
    "stack": [case(U(2, 3), U(2, 3), axis=1)],
    "split": [case(U(2, 6), num_outputs=3),
              case(U(4, 3), num_outputs=2, axis=0, squeeze_axis=False),
              case(U(2, 3), num_outputs=2, axis=0, squeeze_axis=True)],
    "slice": [case(U(4, 5), begin=(1, 0), end=(3, 5)),
              case(U(4, 5), begin=(None, 4), end=(None, 0), step=(1, -2)),
              case(U(4, 5, 2), begin=(3,), end=(None,), step=(-1,))],
    "slice_axis": [case(U(4, 5), axis=1, begin=1, end=4),
                   case(U(4, 5), axis=0, begin=-3, end=None)],
    "slice_like": [case(U(4, 5), U(2, 3)), case(U(4, 5), U(2, 3), axes=(1,))],
    "reverse": [case(U(3, 4), axis=1), case(U(3, 4), axis=(0, 1))],
    "tile": [case(U(2, 3), reps=(2, 1, 2))],
    "repeat": [case(U(2, 3), repeats=2, axis=1), case(U(2, 3), repeats=2)],
    "pad": [case(U(1, 2, 3, 4), mode="constant",
                 pad_width=(0, 0, 0, 0, 1, 2, 2, 1), constant_value=0.5),
            case(U(1, 2, 3, 4), mode="edge", pad_width=(0, 0, 0, 0, 1, 2, 2, 1)),
            case(U(1, 2, 3, 4), mode="reflect",
                 pad_width=(0, 0, 0, 0, 2, 1, 1, 3))],
    "depth_to_space": [case(U(1, 8, 2, 3), block_size=2)],
    "space_to_depth": [case(U(1, 2, 4, 6), block_size=2)],
    "take": [case(U(5, 3), K(np.array([[0, 4], [-1, 7]], np.float32))),
             case(U(5, 3), K(np.array([0, 2, 5], np.float32)), axis=1,
                  mode="wrap")],
    "batch_take": [case(U(4, 5), K(np.array([0, 4, 2, 1], np.float32)))],
    "pick": [case(U(4, 5), K(np.array([0, 4, 2, 1], np.float32))),
             case(U(4, 5), K(np.array([0, 3, 2, 1, 1], np.float32)), axis=0,
                  keepdims=True)],
    "one_hot": [case(K(np.array([0, 2, 1, 4], np.float32)), depth=5),
                case(K(np.array([[0, 2]], np.float32)), depth=3, on_value=2.0,
                     off_value=-1.0, dtype="int32")],
    "gather_nd": [case(U(3, 4), K(np.array([[0, 2, 1], [1, 3, 0]],
                                           np.float32)))],
    "scatter_nd": [case(U(3), K(np.array([[0, 2, 0], [1, 3, 1]], np.float32)),
                        shape=(3, 4))],
    "where": [case(I(3, 4, hi=2), U(3, 4), U(3, 4))],
    "Embedding": [case(K(np.array([[0, 3], [2, 2]], np.float32)), U(4, 5),
                       input_dim=4, output_dim=5)],
    "diag": [case(U(4)), case(U(4), k=1), case(U(3, 4), k=-1)],
    "ravel_multi_index": [case(K(np.array([[0, 2, 1], [3, 1, 9]], np.float32)),
                               shape=(3, 4))],
    "unravel_index": [case(K(np.array([0, 5, 11], np.float32)), shape=(3, 4))],
    "_identity_with_attr_like_rhs": [case(U(3, 4), U(3, 4))],
    "_slice_assign": [case(U(4, 5), U(2, 5), begin=(1,), end=(3,)),
                      case(U(4, 5), U(4, 2), begin=(None, 4), end=(None, 0),
                           step=(None, -2))],
    "_slice_assign_scalar": [case(U(4, 5), scalar=2.0, begin=(1, 1),
                                  end=(3, 4))],
    "_scatter_set_nd": [case(U(3, 4), U(2), K(np.array([[0, 2], [1, 3]],
                                                       np.float32)))],
})

# creation
CASES.update({
    "zeros": [case(shape=(2, 3)), case(shape=4, dtype="int32")],
    "ones": [case(shape=(2, 3))],
    "full": [case(shape=(2, 3), val=2.5)],
    "zeros_like": [case(U(2, 3))],
    "ones_like": [case(U(2, 3))],
    "full_like": [case(U(2, 3), fill_value=3.0)],
    "arange": [case(start=1, stop=7, step=1.5, repeat=2), case(start=5),
               case(start=0, stop=5, dtype="int32")],
    "linspace": [case(start=0.0, stop=1.0, num=5),
                 case(start=-1.0, stop=2.0, num=4, endpoint=False)],
    "eye": [case(N=3), case(N=3, M=4, k=1)],
})

# int8 quantization: codes and their travelling ranges (no gradient)
_QRS = np.random.RandomState(16)


def _codes(shape, dtype=np.int8):
    lo, hi = (0, 256) if dtype == np.uint8 else (-127, 128)
    return K(_QRS.randint(lo, hi, shape).astype(dtype))


def _r(v):
    return K(np.array([v], np.float32))


CASES.update({
    "quantize": [case(U(4, 16), _r(-1.5), _r(1.8), grad=False),
                 case(U(4, 16, lo=-0.2, hi=2.0), _r(0.0), _r(1.7),
                      out_type="uint8", grad=False)],
    "dequantize": [case(_codes((4, 16)), _r(-1.5), _r(1.8), grad=False),
                   case(_codes((4, 16), np.uint8), _r(0.0), _r(1.7),
                        grad=False)],
    "requantize": [case(K(_QRS.randint(-2 ** 20, 2 ** 20, (8, 8))
                          .astype(np.int32)), _r(-2.0 ** 31 + 1),
                        _r(2.0 ** 31 - 1), grad=False),
                   case(K(_QRS.randint(-2 ** 20, 2 ** 20, (8, 8))
                          .astype(np.int32)), _r(-2.0 ** 31 + 1),
                        _r(2.0 ** 31 - 1), min_calib_range=-3e5,
                        max_calib_range=2e5, grad=False)],
    "quantized_flatten": [case(_codes((2, 3, 4, 4)), _r(-1.0), _r(1.0),
                               grad=False)],
    "quantized_pooling": [case(_codes((1, 2, 5, 5)), _r(-1.0), _r(1.0),
                               kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               pool_type="avg", grad=False),
                          case(_codes((1, 2, 5, 5), np.uint8), _r(0.0),
                               _r(1.0), grad=False)],
    "quantized_fully_connected": [
        case(_codes((3, 19)), _codes((5, 19)), _r(-1.0), _r(2.0), _r(-0.5),
             _r(0.5), num_hidden=5, grad=False),
        case(_codes((2, 3, 8), np.uint8), _codes((4, 8)), _r(0.0), _r(2.0),
             _r(-0.5), _r(0.5), num_hidden=4, grad=False)],
    "quantized_conv": [
        case(_codes((1, 3, 7, 7), np.uint8), _codes((4, 3, 3, 3)), _r(0.0),
             _r(3.0), _r(-0.7), _r(0.7), kernel=(3, 3), stride=(2, 2),
             pad=(1, 1), num_filter=4, grad=False),
        case(_codes((1, 4, 6, 6)), _codes((4, 2, 3, 3)), _r(-1.0), _r(1.0),
             _r(-0.7), _r(0.7), kernel=(3, 3), dilate=(2, 2), num_filter=4,
             num_group=2, grad=False)],
})

# nn
CASES.update({
    "FullyConnected": [case(U(2, 3, 4), U(5, 12), U(5), num_hidden=5),
                       case(U(2, 3, 4), U(5, 4), num_hidden=5, no_bias=True,
                            flatten=False)],
    "Convolution": [case(U(1, 2, 5, 5), U(4, 2, 3, 3), U(4), kernel=(3, 3),
                         stride=(2, 2), pad=(1, 1), num_filter=4),
                    case(U(1, 4, 6, 6), U(4, 2, 3, 3), kernel=(3, 3),
                         dilate=(2, 2), num_filter=4, num_group=2,
                         no_bias=True),
                    case(U(2, 2, 7), U(3, 2, 3), U(3), kernel=(3,),
                         num_filter=3)],
    "Deconvolution": [case(U(1, 2, 4, 4), U(2, 3, 3, 3), kernel=(3, 3),
                           stride=(2, 2), pad=(1, 1), adj=(1, 1),
                           num_filter=3),
                      case(U(1, 4, 3, 3), U(4, 1, 2, 2), U(2), kernel=(2, 2),
                           num_filter=2, num_group=2, no_bias=False)],
    "Pooling": [case(U(1, 2, 5, 5), kernel=(2, 2), stride=(2, 2)),
                case(U(1, 2, 5, 5), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="avg"),
                case(U(1, 2, 5, 5), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="avg", count_include_pad=False),
                case(U(1, 2, 5, 5), kernel=(2, 2), stride=(2, 2),
                     pool_type="sum", pooling_convention="full"),
                case(U(1, 2, 5, 5), kernel=(2, 2), stride=(2, 2),
                     pooling_convention="full"),
                case(U(1, 2, 6), kernel=(2,), stride=(2,), pool_type="lp"),
                case(U(1, 2, 4, 4), global_pool=True, pool_type="avg"),
                case(U(1, 2, 4, 4), global_pool=True)],
    "UpSampling": [case(U(1, 2, 2, 3), scale=2)],
    "BatchNorm": [case(U(2, 3, 4), U(3), U(3), U(3), U(3, **_POS),
                       fix_gamma=False),
                  case(U(2, 3, 4), U(3), U(3), U(3), U(3, **_POS))],
    "batch_norm_train": [case(U(4, 3, 5), U(3), U(3), fix_gamma=False)],
    "LayerNorm": [case(U(2, 3, 4), U(4), U(4)),
                  case(U(2, 3, 4), U(3), U(3), axis=1)],
    "InstanceNorm": [case(U(2, 3, 4, 2), U(3), U(3))],
    "LRN": [case(U(1, 6, 3, 3), nsize=3)],
    "Activation": [case(U(3, 4), act_type=a) for a in
                   ("relu", "sigmoid", "tanh", "softrelu", "softsign")],
    "LeakyReLU": [case(U(3, 4), act_type="leaky", slope=0.1),
                  case(U(2, 3, 4), U(3), act_type="prelu"),
                  case(U(3, 4), act_type="elu"),
                  case(U(3, 4), act_type="selu"),
                  case(U(3, 4), act_type="gelu"),
                  case(U(3, 4), act_type="rrelu")],
    "softmax": [case(U(3, 4)), case(U(3, 4), axis=0, temperature=2.0),
                case(U(3, 4), length=K(np.array([2, 4, 1], np.float32)),
                     use_length=True, grad=False)],
    "log_softmax": [case(U(3, 4)), case(U(3, 4), axis=0, temperature=0.5)],
    "softmin": [case(U(3, 4))],
    "SoftmaxActivation": [case(U(2, 3, 4)), case(U(2, 3, 4), mode="channel")],
    # inference: the identity (training draws differ: see the ndarray tests)
    "Dropout": [case(U(3, 4), p=0.5, grad=False)],
    "SoftmaxOutput": [case(U(4, 5), K(np.array([0, 4, 2, 1], np.float32))),
                      case(U(4, 5), K(np.array([0, -1, 2, 1], np.float32)),
                           use_ignore=True, normalization="valid",
                           grad_scale=2.0),
                      case(U(4, 5), K(np.array([0, 3, 2, 1], np.float32)),
                           normalization="batch"),
                      case(U(2, 3, 4), K(np.array([[0, 1, 2, 0],
                                                    [2, 2, 1, 0]], np.float32)),
                           multi_output=True)],
    "make_loss": [case(U(3, 4), grad_scale=0.5)],
    "LinearRegressionOutput": [case(U(4, 3), U(4, 3))],
    "MAERegressionOutput": [case(U(4, 3), U(4, 3), grad_scale=2.0)],
    "LogisticRegressionOutput": [case(U(4, 3), U(4, 3, lo=0.0, hi=1.0))],
    "softmax_cross_entropy": [case(U(4, 5), K(np.array([0, 4, 2, 1],
                                                       np.float32)))],
    "div_sqrt_dim": [case(U(3, 4))],
    "IdentityAttachKLSparseReg": [case(U(4, 3, lo=0.1, hi=0.9), penalty=0.01)],
    "SVMOutput": [case(U(4, 5), K(np.array([0, 4, 2, 1], np.float32))),
                  case(U(4, 5), K(np.array([0, 4, 2, 1], np.float32)),
                       use_linear=True, margin=0.5)],
})

# random: shape and dtype parity, and reproducibility under a seed
RANDOM = {
    "uniform": case(low=-1.0, high=2.0, shape=(3, 4)),
    "normal": case(loc=1.0, scale=2.0, shape=(3, 4)),
    "gamma": case(alpha=0.7, beta=2.0, shape=(3, 4)),
    "exponential": case(lam=2.0, shape=(5,)),
    "poisson": case(lam=3.0, shape=(2, 3)),
    "negative_binomial": case(k=3, p=0.4, shape=(2, 3)),
    "generalized_negative_binomial": case(mu=2.0, alpha=0.5, shape=(2, 3)),
    "randint": case(low=2, high=9, shape=(2, 3)),
    "multinomial": case(K(np.array([[0.2, 0.3, 0.5], [0.6, 0.2, 0.2]],
                                   np.float32)), shape=(4,), get_prob=True),
    "shuffle": case(U(6, 2)),
    "bernoulli": case(p=0.3, shape=(4, 4)),
    "sample_uniform": case(U(2, lo=0, hi=1), U(2, lo=1, hi=2), shape=(3,)),
    "sample_normal": case(U(2), U(2, **_POS), shape=(3,)),
    "sample_gamma": case(U(2, **_POS), U(2, **_POS), shape=(3,)),
    "sample_exponential": case(U(2, **_POS), shape=(3,)),
    "sample_poisson": case(U(2, **_POS), shape=(3,)),
    "sample_negative_binomial": case(K(np.array([2.0, 3.0], np.float32)),
                                     U(2, lo=0.3, hi=0.7), shape=(3,)),
    "sample_generalized_negative_binomial": case(U(2, **_POS),
                                                 U(2, lo=0.0, hi=0.5),
                                                 shape=(3,)),
}


def _custom_case():
    return [case(U(3, 4), op_type="ops_parity_scale", factor=2.5)]


def _register_custom():
    import mxtpu_torch.operator as tops
    for mod in (mxtpu.operator, tops):
        class _Prop(mod.CustomOpProp):
            def __init__(self, factor="1.0"):
                super().__init__()
                self.factor = float(factor)

            def create_operator(self, ctx, in_shapes, in_dtypes):
                f = self.factor

                class _Op(mod.CustomOp):
                    def forward(self, is_train, req, in_data, out_data, aux):
                        self.assign(out_data[0], req[0],
                                    in_data[0].asnumpy() * f)

                    def backward(self, req, out_grad, in_data, out_data,
                                 in_grad, aux):
                        self.assign(in_grad[0], req[0],
                                    out_grad[0].asnumpy() * f)

                return _Op()

        mod.register("ops_parity_scale")(_Prop)


def H(*shape):
    return lambda rs: rs.uniform(-2.0, 2.0, shape).astype(np.float16)


# the fused optimizer updates: pure, not differentiable, (weight, grad,
# *states) with positive states where they sit under a square root
_P = dict(lo=0.1, hi=1.0)
_OPT = dict(lr=0.05, wd=0.01, rescale_grad=0.5)
CASES.update({
    "sgd_update": [case(U(3, 4), U(3, 4), grad=False, clip_gradient=0.3,
                        **_OPT)],
    "sgd_mom_update": [case(U(3, 4), U(3, 4), U(3, 4), grad=False,
                            momentum=0.9, **_OPT)],
    "mp_sgd_update": [case(H(3, 4), H(3, 4), U(3, 4), grad=False, **_OPT)],
    "mp_sgd_mom_update": [case(H(3, 4), H(3, 4), U(3, 4), U(3, 4),
                               grad=False, momentum=0.9, **_OPT)],
    "signsgd_update": [case(U(3, 4), U(3, 4), grad=False, **_OPT)],
    "signum_update": [case(U(3, 4), U(3, 4), U(3, 4), grad=False,
                           momentum=0.9, wd_lh=0.01, **_OPT)],
    "adam_update": [case(U(3, 4), U(3, 4), U(3, 4), U(3, 4, **_P),
                         grad=False, clip_gradient=1.0, **_OPT)],
    "ftml_update": [case(U(3, 4), U(3, 4), U(3, 4, **_P), U(3, 4, **_P),
                         U(3, 4), grad=False, lr=0.05, t=3, wd=0.01)],
    "rmsprop_update": [case(U(3, 4), U(3, 4), U(3, 4, **_P), grad=False,
                            clip_weights=1.0, **_OPT)],
    "rmspropalex_update": [case(U(3, 4), U(3, 4), U(3, 4, lo=2.0, hi=3.0),
                                U(3, 4, lo=-0.1, hi=0.1), U(3, 4),
                                grad=False, **_OPT)],
    "ftrl_update": [case(U(3, 4), U(3, 4), U(3, 4), U(3, 4, **_P),
                         grad=False, lamda1=0.1, **_OPT)],
    "_sparse_adagrad_update": [case(U(3, 4), U(3, 4), U(3, 4, **_P),
                                    grad=False, **_OPT)],
})

_register_custom()
CASES["Custom"] = _custom_case()
# contrib.flash_attention (registered from ops/attention.py): causal and
# cross-length, against the JAX op's XLA path on the CPU
CASES["flash_attention"] = [
    case(U(1, 2, 8, 4), U(1, 2, 8, 4), U(1, 2, 8, 4), causal=True),
    case(U(2, 1, 5, 8), U(2, 1, 7, 8), U(2, 1, 7, 8), scale=0.5)]

# sequence ops: lengths per batch element, on axis 0 and on axis 1
_LENS = K(np.array([2, 4, 1], np.float32))
CASES.update({
    "SequenceMask": [
        case(U(4, 3, 2), _LENS, use_sequence_length=True, value=-1.0),
        case(U(3, 4, 2), _LENS, use_sequence_length=True, axis=1),
        case(U(4, 3))],
    "SequenceLast": [
        case(U(4, 3, 2), _LENS, use_sequence_length=True),
        case(U(3, 4), _LENS, use_sequence_length=True, axis=1),
        case(U(4, 3))],
    "SequenceReverse": [
        case(U(4, 3, 2), _LENS, use_sequence_length=True),
        case(U(4, 3))],
})


# RNN: T 4, B 2, I 3, H 5; weights of a gate block of H rows a gate
def _scan_case(mode, gates, reverse):
    g = gates * 5
    state = [U(2, 5), U(2, 5)] if mode == "lstm" else [U(2, 5)]
    return case(U(4, 2, 3), *state, U(g, 3, **_UNIT), U(g, **_UNIT),
                U(g, 5, **_UNIT), U(g, **_UNIT), mode=mode, reverse=reverse)


CASES["rnn_scan"] = [_scan_case(m, g, r)
                     for m, g in (("lstm", 4), ("gru", 3), ("rnn_tanh", 1),
                                  ("rnn_relu", 1))
                     for r in (False, True)]
# the packed vectors: 2-layer bidirectional GRU (810 = weights 240 + 450,
# biases 120), 1-layer LSTM (160 + 40), 1-layer rnn_tanh (40 + 10)
CASES["RNN"] = [
    case(U(4, 2, 3), U(810, **_UNIT), U(4, 2, 5), state_size=5, num_layers=2,
         mode="gru", bidirectional=True, state_outputs=True),
    case(U(4, 2, 3), U(200, **_UNIT), U(1, 2, 5), U(1, 2, 5), state_size=5,
         num_layers=1, mode="lstm", state_outputs=True),
    case(U(4, 2, 3), U(50, **_UNIT), U(1, 2, 5), state_size=5, num_layers=1,
         mode="rnn_tanh")]


def _slice_names(modules=SLICE_MODULES):
    names = []
    for k in jreg.list_ops():
        mod = jreg.get_op(k).fn.__module__.rsplit(".", 1)[-1]
        if mod in modules and k not in WAITING:
            names.append(k)
    return names


def test_registry_lists_the_slice():
    """The port registers exactly the JAX package's ops of the registered
    modules (and their aliases), less those that wait."""
    names = _slice_names(REGISTERED_MODULES)
    assert sorted(treg.list_ops()) == sorted(names)
    for ns in ("random", "contrib", "image", "linalg"):
        assert treg.list_ops(ns) == sorted(
            k[len(ns) + 1:] for k in names if k.startswith(ns + "."))


def _build(rs, spec):
    return spec(rs) if callable(spec) else spec


def _arrays(case_, seed):
    args, kwargs, grad = case_
    rs = np.random.RandomState(seed)
    np_args = [_build(rs, a) for a in args]
    np_kwargs = {k: (_build(rs, v) if callable(v) else v)
                 for k, v in kwargs.items()}
    return np_args, np_kwargs, grad


def _wrap(pkg_nd, v):
    """A numpy array as an NDArray; a 0-d one as a Python scalar."""
    if isinstance(v, np.ndarray):
        return pkg_nd.array(v) if v.ndim else v.item()
    return v


def _run(key, np_args, np_kwargs, cot_seed, with_grad):
    """The port's op through its ``invoke`` and ``autograd``: outputs
    (numpy) and the gradients of sum(out * c) for the float array inputs."""
    args = [_wrap(tnd, a) for a in np_args]
    kwargs = {k: _wrap(tnd, v) for k, v in np_kwargs.items()}
    op = treg.get_op(key)
    outs = treg.invoke(op, *args, **kwargs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    res = [o.asnumpy() for o in outs]
    if not with_grad:
        return res, None
    leaves = [a for a in args if hasattr(a, "attach_grad")
              and a.dtype == np.float32]
    for a in leaves:
        a.attach_grad()
    rs = np.random.RandomState(cot_seed)
    with tag.record():
        outs = treg.invoke(op, *args, **kwargs)
        outs = outs if isinstance(outs, tuple) else (outs,)
    heads = [o for o in outs if o.dtype == np.float32]
    cots = [tnd.array(rs.uniform(-1, 1, o.shape).astype(np.float32))
            for o in heads]
    tag.backward(heads, head_grads=cots)
    return res, [a.grad.asnumpy() for a in leaves]


def _run_jax(key, np_args, np_kwargs, cot_seed, with_grad):
    """The JAX package's op on the same inputs: its registered function
    under one ``jax.jit`` (forward, and ``jax.vjp`` of it for the same
    cotangents), which compiles once per case where eager dispatch
    compiles every primitive."""
    op = jreg.get_op(key)
    args = [jnp.asarray(a) if a.ndim else a.item() for a in np_args]
    kwargs = {k: (jnp.asarray(v) if v.ndim else v.item())
              if isinstance(v, np.ndarray) else v
              for k, v in np_kwargs.items()}
    if op.resolve_kwargs is not None:
        kwargs = op.resolve_kwargs(dict(kwargs))
    pos = [i for i, a in enumerate(args)
           if hasattr(a, "dtype") and a.dtype == np.float32]

    def f(*xs):
        full = list(args)
        for i, x in zip(pos, xs):
            full[i] = x
        return op.fn(*full, **kwargs)

    xs = [args[i] for i in pos]
    if not with_grad:
        outs = jax.jit(f)(*xs)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        return [np.asarray(o) for o in outs], None
    shapes = jax.eval_shape(f, *xs)
    multi = isinstance(shapes, (tuple, list))
    rs = np.random.RandomState(cot_seed)
    cots = [jnp.asarray(rs.uniform(-1, 1, s.shape).astype(np.float32))
            if s.dtype == np.float32 else jnp.zeros(s.shape, s.dtype)
            for s in (shapes if multi else [shapes])]

    @jax.jit
    def fwd_bwd(xs, cots):
        outs, vjp = jax.vjp(f, *xs)
        return outs, vjp(tuple(cots) if multi else cots[0])

    outs, grads = fwd_bwd(xs, cots)
    outs = outs if multi else (outs,)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _compare(a, b, what):
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


@pytest.mark.parametrize("key", _slice_names())
def test_op_matches_jax(key):
    """An op's every case under its own name; an alias (the same op in
    both registries) its first case, forward only."""
    op = treg.get_op(key)
    canonical = f"{op.namespace}.{op.name}" if op.namespace else op.name
    assert jreg.get_op(key).name == op.name
    if op.namespace == "random":
        return _check_random(key, op)
    diff = op.differentiable
    cases = CASES[op.name]
    if key != canonical:
        cases = [cases[0][:2] + (False,)]
    for i, c in enumerate(cases):
        np_args, np_kwargs, grad = _arrays(c, seed=i)
        want_grad = bool(grad and (diff(np_kwargs) if callable(diff)
                                   else diff))
        j_out, j_grad = _run_jax(key, np_args, np_kwargs, 100 + i, want_grad)
        t_out, t_grad = _run(key, np_args, np_kwargs, 100 + i, want_grad)
        assert len(j_out) == len(t_out)
        for n, (a, b) in enumerate(zip(j_out, t_out)):
            _compare(a, b, f"{key} case {i} output {n}")
        for n, (a, b) in enumerate(zip(j_grad or [], t_grad or [])):
            _compare(a, b, f"{key} case {i} gradient {n}")


def _check_random(key, op):
    np_args, np_kwargs, _ = _arrays(RANDOM[op.name], seed=0)
    jop = jreg.get_op(key)
    # The JAX package makes a thread's global key on its first draw; made
    # inside the trace below, it would be a leaked tracer for every later
    # draw of this process. Make it here, outside any trace.
    jrng._global()
    j_out = jax.eval_shape(lambda: jop.fn(
        *[jnp.asarray(a) for a in np_args], **np_kwargs))
    j_out = j_out if isinstance(j_out, (tuple, list)) else (j_out,)
    draws = []
    for _ in range(2):
        trng.seed(11)
        t_out, _ = _run(key, np_args, np_kwargs, 0, False)
        draws.append(t_out)
    for a, b in zip(j_out, draws[0]):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), key
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b, err_msg=f"{key}: seed 11 twice")
