"""mxtpu_torch's convolution and pooling layers against the JAX package's,
on the CPU.

Every layer class of ``gluon/nn/conv_layers.py`` (``Conv1D/2D/3D``, their
``Transpose`` forms, ``Max/AvgPool1D/2D/3D``, the six ``Global*Pool`` and
``ReflectionPad2D``) is built in both packages at a small shape, with
deferred and given ``in_channels``, groups (depthwise too), strides,
dilation, padding, ``output_padding``, ``ceil_mode`` and
``count_include_pad``; dilation on the convolutions only: the JAX
package's transposed convolution makes a dilated output ``dilation - 1``
wider than MXNet's ``(in - 1) * stride - 2 * pad + dilation * (kernel -
1) + 1 + output_padding``, which the port keeps (held below on the port
alone). The port loads the JAX layer's ``.params`` file;
then the forward and the gradients of ``sum(out * c)`` (a fixed random
``c``) with respect to the input and every parameter agree within 1e-5
rel + 1e-6 abs, and the parameters' names, shapes and dtypes are the
reference's.
"""

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import gluon as jgluon
from mxtpu import nd as jnd

import mxtpu_torch as mx
from mxtpu_torch import autograd as ag
from mxtpu_torch import gluon, nd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-6)

# id -> (layer factory over a package's ``nn``, input shape)
CASES = {
    "conv1d": (lambda nn: nn.Conv1D(4, 3, padding=1, in_channels=3),
               (2, 3, 9)),
    "conv1d_deferred_stride_dilation": (
        lambda nn: nn.Conv1D(5, 3, strides=2, dilation=2, use_bias=False),
        (2, 3, 13)),
    "conv2d_deferred": (lambda nn: nn.Conv2D(6, 3, padding=1), (2, 4, 7, 7)),
    "conv2d_groups_dilation": (
        lambda nn: nn.Conv2D(6, (3, 2), strides=(2, 1), padding=(1, 0),
                             dilation=(1, 2), groups=2, in_channels=4),
        (2, 4, 9, 8)),
    "conv2d_depthwise_relu": (
        lambda nn: nn.Conv2D(4, 3, strides=2, padding=1, groups=4,
                             activation="relu", use_bias=False),
        (2, 4, 8, 8)),
    "conv3d_deferred": (lambda nn: nn.Conv3D(4, 2, padding=(1, 0, 1)),
                        (1, 2, 4, 5, 5)),
    "conv1d_transpose": (
        lambda nn: nn.Conv1DTranspose(3, 3, strides=2, padding=1,
                                      output_padding=1, in_channels=2),
        (2, 2, 6)),
    "conv2d_transpose_groups_deferred": (
        lambda nn: nn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                      output_padding=1, groups=2),
        (2, 4, 5, 5)),
    "conv2d_transpose_strided_tanh": (
        lambda nn: nn.Conv2DTranspose(3, 2, strides=(1, 2), activation="tanh",
                                      use_bias=False),
        (1, 2, 4, 6)),
    "conv3d_transpose": (lambda nn: nn.Conv3DTranspose(2, 2, strides=2),
                         (1, 3, 2, 3, 3)),
    "maxpool1d_pad": (lambda nn: nn.MaxPool1D(3, 2, padding=1), (2, 3, 9)),
    "maxpool2d_ceil": (lambda nn: nn.MaxPool2D(3, 2, ceil_mode=True),
                       (2, 3, 8, 8)),
    "maxpool2d_rect_pad": (
        lambda nn: nn.MaxPool2D((2, 3), (2, 1), padding=(1, 1)),
        (1, 2, 7, 6)),
    "maxpool3d": (lambda nn: nn.MaxPool3D(2), (1, 2, 4, 4, 6)),
    "avgpool1d_exclude_pad": (
        lambda nn: nn.AvgPool1D(3, 2, padding=1, count_include_pad=False),
        (2, 3, 8)),
    "avgpool2d_ceil_exclude_pad": (
        lambda nn: nn.AvgPool2D(3, 2, padding=1, ceil_mode=True,
                                count_include_pad=False),
        (2, 3, 8, 8)),
    "avgpool2d_include_pad": (
        lambda nn: nn.AvgPool2D(3, 2, padding=1), (2, 3, 7, 7)),
    "avgpool3d_ceil": (lambda nn: nn.AvgPool3D(2, ceil_mode=True),
                       (1, 2, 5, 4, 5)),
    "global_maxpool1d": (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 7)),
    "global_maxpool2d": (lambda nn: nn.GlobalMaxPool2D(), (2, 3, 5, 6)),
    "global_maxpool3d": (lambda nn: nn.GlobalMaxPool3D(), (1, 2, 3, 4, 5)),
    "global_avgpool1d": (lambda nn: nn.GlobalAvgPool1D(), (2, 3, 7)),
    "global_avgpool2d": (lambda nn: nn.GlobalAvgPool2D(), (2, 3, 5, 6)),
    "global_avgpool3d": (lambda nn: nn.GlobalAvgPool3D(), (1, 2, 3, 4, 5)),
    "reflection_pad2d": (lambda nn: nn.ReflectionPad2D(1), (2, 3, 4, 5)),
    "reflection_pad2d_uneven": (lambda nn: nn.ReflectionPad2D((1, 2, 2, 0)),
                                (1, 2, 4, 5)),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.Context("cpu"):
        yield


def _table(net):
    return [(k, tuple(p.shape), str(p.dtype))
            for k, p in net.collect_params().items()]


def _run(pkg_nd, pkg_ag, layer, x, c):
    """Forward, and the gradients of sum(out * c) for the input and each
    parameter."""
    xa = pkg_nd.array(x)
    xa.attach_grad()
    with pkg_ag.record():
        out = layer(xa)
        loss = (out * pkg_nd.array(c)).sum()
    loss.backward()
    grads = [xa.grad.asnumpy()] + [
        p.grad().asnumpy() for p in layer.collect_params().values()
        if p.grad_req != "null"]
    return out.asnumpy(), grads


@pytest.mark.parametrize("case", list(CASES))
def test_layer_forward_and_gradients_equal_jax(case, tmp_path):
    make, shape = CASES[case]
    rs = np.random.RandomState(len(case))
    x = rs.randn(*shape).astype(np.float32)
    jl, tl = make(jgluon.nn), make(gluon.nn)
    jl.initialize(jmx.initializer.Uniform(0.5))
    out_shape = jl(jnd.array(x)).shape   # completes deferred shapes
    if len(jl.collect_params()):
        f = str(tmp_path / "layer.params")
        jl.save_parameters(f)
        tl.load_parameters(f, ctx=mx.cpu())
    assert _table(tl) == _table(jl)
    c = rs.randn(*out_shape).astype(np.float32)
    jo, jg = _run(jnd, jag, jl, x, c)
    to, tg = _run(nd, ag, tl, x, c)
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, **TOL)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **TOL)


def test_deferred_in_channels_complete_from_the_first_input():
    conv = gluon.nn.Conv2D(8, 3, groups=2, prefix="c_")
    tconv = gluon.nn.Conv2DTranspose(8, 3, groups=2, prefix="t_")
    assert conv.collect_params()["c_weight"].shape == (8, 0, 3, 3)
    assert tconv.collect_params()["t_weight"].shape == (0, 4, 3, 3)
    for layer in (conv, tconv):
        layer.initialize(ctx=mx.cpu())
        layer(nd.ones((1, 6, 5, 5)))
    assert conv.collect_params()["c_weight"].shape == (8, 3, 3, 3)
    assert tconv.collect_params()["t_weight"].shape == (6, 4, 3, 3)
    # MXNet's transposed output size, dilated: (4 - 1) + 2 * (2 - 1) + 1
    dil = gluon.nn.Conv2DTranspose(3, 2, strides=(1, 2), dilation=2,
                                   in_channels=2)
    dil.initialize(ctx=mx.cpu())
    assert dil(nd.ones((1, 2, 4, 6))).shape == (1, 3, 6, 13)
    with pytest.raises(NotImplementedError, match="channels-first"):
        gluon.nn.Conv2D(4, 3, layout="NHWC")
