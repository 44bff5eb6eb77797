"""Vision model zoo — port of ``mxtpu/gluon/model_zoo/vision.py``: ResNet
v1/v2 (18/34/50/101/152), VGG 11/13/16/19 (with and without BatchNorm),
AlexNet, SqueezeNet 1.0/1.1, DenseNet 121/161/169/201, MobileNet v1 (four
multipliers) and v2, Inception-V3 and LeNet.

Every network is assembled, as in the reference, from the same family
tables (``_RESNET_SPEC``, ``_VGG_SPEC``, ...) by the same generic cells:

* ``_cna``       — conv[+BatchNorm][+activation] appended to a sequence
* ``_Residual``  — ``y = tail(main(stem(x)) + shortcut(stem(x)))``
* ``_Fork``      — channel concat of parallel branches
* ``_DenseCell`` — ``y = concat(x, body(x))``
* ``_Net``       — features then output, in the net's own name scope

so each parameter has the reference's name (``<prefix>stage1_conv0_weight``)
and a ``.params`` file written by either package loads in the other. As
there, a convolution that feeds a BatchNorm has no bias (a deliberate
departure from MXNet's zoo), and ``relu6`` is ``clip(x, 0, 6)``.

The cells are layers of the port (``gluon/block.py``): a net computes on
tensors (``DataParallelTrainer``, ``ChainedPredictor``), and called with
NDArrays it records one node. A net starts in predict mode (``eval()``):
a call with tensors runs BatchNorm on its running statistics unless the
caller turns training on; a call with NDArrays follows ``autograd``.
Input widths are left to the first forward (deferred shapes). Data is
NCHW. ``pretrained=True`` reads a local file
(``model_store``); nothing downloads.
"""

from __future__ import annotations

import torch

from ...ndarray.ndarray import NDArray
from ...ops import elementwise as _elementwise
from ...ops import nn as _ops
from .. import nn
from ..nn.basic_layers import _Layer

__all__ = ["get_model", "get_resnet", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "alexnet", "squeezenet1_0",
           "squeezenet1_1", "densenet121", "densenet161", "densenet169",
           "densenet201", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "mobilenet_v2_1_0", "mobilenet_v2_0_75",
           "mobilenet_v2_0_5", "mobilenet_v2_0_25", "inception_v3", "lenet",
           "LeNet"]


# ---------------------------------------------------------------------------
# generic cells
# ---------------------------------------------------------------------------


def _seq(*blocks, prefix=""):
    s = nn.HybridSequential(prefix=prefix)
    for b in blocks:
        s.add(b)
    return s


def _relu6(x):
    """``clip(x, 0, 6)`` on a tensor, or through ``nd`` on an NDArray."""
    if isinstance(x, NDArray):
        from ... import ndarray as nd
        return nd.clip(x, 0.0, 6.0)
    return _elementwise._clip(x, 0.0, 6.0)


def _act(name):
    if name == "relu6":
        return nn.HybridLambda(_relu6)
    return nn.Activation(name)


def _cna(seq, ch, k=1, s=1, p=0, *, g=1, norm=True, act="relu", bias=None,
         eps=1e-5):
    """Append a conv[+BatchNorm][+activation] unit to ``seq``; ``bias``
    defaults to False when a norm follows and True for a bare conv."""
    if bias is None:
        bias = not norm
    seq.add(nn.Conv2D(ch, kernel_size=k, strides=s, padding=p, groups=g,
                      use_bias=bias))
    if norm:
        seq.add(nn.BatchNorm(epsilon=eps))
    if act:
        seq.add(_act(act))
    return seq


class _Residual(_Layer):
    """``y = tail(main(h) + shortcut(h))`` with ``h = stem(x)``; the
    identity path bypasses the stem. ResNet v1: no stem, a projection
    shortcut, ``tail='relu'``; v2: a BatchNorm + relu stem shared by main
    and projection, no tail; MobileNetV2: ``main`` alone."""

    def __init__(self, main, shortcut=None, stem=None, tail=None, **kwargs):
        super().__init__(**kwargs)
        self.main = main
        self.shortcut = shortcut
        self.stem = stem
        self._tail = tail

    def forward(self, x):
        identity = x
        h = self.stem(x) if self.stem is not None else x
        if self.shortcut is not None:
            identity = self.shortcut(h)
        y = self.main(h) + identity
        if self._tail:
            y = _ops._activation(y, act_type=self._tail)
        return y


class _Fork(_Layer):
    """Branches run on the same input, their outputs concatenated along
    channels."""

    def __init__(self, *branches, **kwargs):
        super().__init__(**kwargs)
        self.branches = list(branches)
        for i, b in enumerate(self.branches):
            self.register_child(b, f"branch{i}")

    def forward(self, x):
        return torch.cat([b(x) for b in self.branches], dim=1)


class _DenseCell(_Layer):
    """DenseNet connectivity: ``concat(x, body(x))``."""

    def __init__(self, body, **kwargs):
        super().__init__(**kwargs)
        self.body = body

    def forward(self, x):
        return torch.cat([x, self.body(x)], dim=1)


class _Net(_Layer):
    """features then output, shared by every family; ``build()`` returns
    ``(features, output)`` and runs in this block's name scope, so the
    names are net-relative and the same from instance to instance."""

    def __init__(self, build, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features, self.output = build()
        self.eval()     # predict mode, as a Gluon block outside training

    def forward(self, x):
        return self.output(self.features(x))


def _pretrained(net, name, ctx):
    from .model_store import load_pretrained
    load_pretrained(net, name, ctx)


# ---------------------------------------------------------------------------
# ResNet v1/v2
# ---------------------------------------------------------------------------

# depth -> (unit kind, units per stage, stage widths incl. stem width)
_RESNET_SPEC = {
    18: ("basic", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


def _resnet_convs(kind, c, s, version):
    """(width, kernel, stride, pad) rows of a unit: the v1 bottleneck
    strides its first 1x1, the v2 one its 3x3."""
    if kind == "basic":
        return [(c, 3, s, 1), (c, 3, 1, 1)]
    if version == 1:
        return [(c // 4, 1, s, 0), (c // 4, 3, 1, 1), (c, 1, 1, 0)]
    return [(c // 4, 1, 1, 0), (c // 4, 3, s, 1), (c, 1, 1, 0)]


def _resnet_unit(version, kind, c, s, project):
    convs = _resnet_convs(kind, c, s, version)
    main = nn.HybridSequential(prefix="")
    if version == 1:
        for i, (w, k, st, pd) in enumerate(convs):
            _cna(main, w, k, st, pd, act="relu" if i < len(convs) - 1
                 else None)
        shortcut = _cna(nn.HybridSequential(prefix=""), c, 1, s,
                        act=None) if project else None
        return _Residual(main, shortcut, tail="relu")
    stem = _seq(nn.BatchNorm(), nn.Activation("relu"))
    for i, (w, k, st, pd) in enumerate(convs):
        if i > 0:
            main.add(nn.BatchNorm())
            main.add(nn.Activation("relu"))
        main.add(nn.Conv2D(w, kernel_size=k, strides=st, padding=pd,
                           use_bias=False))
    shortcut = nn.Conv2D(c, kernel_size=1, strides=s,
                         use_bias=False) if project else None
    return _Residual(main, shortcut, stem=stem)


def _resnet_stage(version, kind, n_units, c, in_c, stride, index):
    stage = nn.HybridSequential(prefix=f"stage{index}_")
    with stage.name_scope():
        stage.add(_resnet_unit(version, kind, c, stride,
                               project=(stride != 1 or in_c != c)))
        for _ in range(n_units - 1):
            stage.add(_resnet_unit(version, kind, c, 1, project=False))
    return stage


def get_resnet(version: int, num_layers: int, pretrained: bool = False,
               ctx=None, classes: int = 1000, thumbnail: bool = False,
               **kwargs):
    """A ResNet; ``thumbnail=True`` swaps the 7x7 + max-pool stem for a
    bare 3x3 (CIFAR-sized input)."""
    if version not in (1, 2):
        raise ValueError(f"resnet version must be 1 or 2, got {version}")
    kind, units, widths = _RESNET_SPEC[num_layers]

    def build():
        feats = nn.HybridSequential(prefix="")
        if version == 2:
            feats.add(nn.BatchNorm(scale=False, center=False))
        if thumbnail:
            _cna(feats, widths[0], 3, 1, 1, norm=False, act=None, bias=False)
        else:
            _cna(feats, widths[0], 7, 2, 3, act="relu")
            feats.add(nn.MaxPool2D(3, 2, 1))
        in_c = widths[0]
        for i, (n, c) in enumerate(zip(units, widths[1:])):
            feats.add(_resnet_stage(version, kind, n, c, in_c,
                                    1 if i == 0 else 2, i + 1))
            in_c = c
        if version == 2:
            feats.add(nn.BatchNorm())
            feats.add(nn.Activation("relu"))
        feats.add(nn.GlobalAvgPool2D())
        feats.add(nn.Flatten())
        return feats, nn.Dense(classes, in_units=in_c)

    net = _Net(build, **kwargs)
    if pretrained:
        _pretrained(net, f"resnet{num_layers}_v{version}", ctx)
    return net


def _resnet_factory(version, depth):
    def make(**kw):
        return get_resnet(version, depth, **kw)
    make.__name__ = f"resnet{depth}_v{version}"
    return make


resnet18_v1 = _resnet_factory(1, 18)
resnet34_v1 = _resnet_factory(1, 34)
resnet50_v1 = _resnet_factory(1, 50)
resnet101_v1 = _resnet_factory(1, 101)
resnet152_v1 = _resnet_factory(1, 152)
resnet18_v2 = _resnet_factory(2, 18)
resnet34_v2 = _resnet_factory(2, 34)
resnet50_v2 = _resnet_factory(2, 50)
resnet101_v2 = _resnet_factory(2, 101)
resnet152_v2 = _resnet_factory(2, 152)


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

# depth -> convs per stage; the widths are the same at every depth
_VGG_SPEC = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
             16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}
_VGG_WIDTHS = [64, 128, 256, 512, 512]


def _vgg(depth, batch_norm=False, pretrained=False, ctx=None, classes=1000,
         **kwargs):
    def build():
        feats = nn.HybridSequential(prefix="")
        for reps, width in zip(_VGG_SPEC[depth], _VGG_WIDTHS):
            for _ in range(reps):
                _cna(feats, width, 3, 1, 1, norm=batch_norm, act="relu",
                     bias=True)
            feats.add(nn.MaxPool2D(strides=2))
        for _ in range(2):
            feats.add(nn.Dense(4096, activation="relu"))
            feats.add(nn.Dropout(0.5))
        return feats, nn.Dense(classes)

    net = _Net(build, **kwargs)
    if pretrained:
        _pretrained(net, f"vgg{depth}{'_bn' if batch_norm else ''}", ctx)
    return net


def _vgg_factory(depth, bn):
    def make(**kw):
        return _vgg(depth, batch_norm=bn, **kw)
    make.__name__ = f"vgg{depth}{'_bn' if bn else ''}"
    return make


vgg11, vgg13, vgg16, vgg19 = (_vgg_factory(d, False) for d in (11, 13, 16, 19))
vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn = (_vgg_factory(d, True)
                                          for d in (11, 13, 16, 19))


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------

# (out channels, kernel, stride, pad, max-pool after?)
_ALEXNET_SPEC = [(64, 11, 4, 2, True), (192, 5, 1, 2, True),
                 (384, 3, 1, 1, False), (256, 3, 1, 1, False),
                 (256, 3, 1, 1, True)]


def alexnet(pretrained=False, ctx=None, classes=1000, **kwargs):
    def build():
        feats = nn.HybridSequential(prefix="")
        for ch, k, s, p, pool in _ALEXNET_SPEC:
            _cna(feats, ch, k, s, p, norm=False, act="relu", bias=True)
            if pool:
                feats.add(nn.MaxPool2D(3, 2))
        feats.add(nn.Flatten())
        for _ in range(2):
            feats.add(nn.Dense(4096, activation="relu"))
            feats.add(nn.Dropout(0.5))
        return feats, nn.Dense(classes)

    net = _Net(build, **kwargs)
    if pretrained:
        _pretrained(net, "alexnet", ctx)
    return net


# ---------------------------------------------------------------------------
# SqueezeNet
# ---------------------------------------------------------------------------


def _fire(squeeze, expand):
    """1x1 squeeze, then parallel 1x1 and 3x3 expands, concatenated."""
    e1 = _cna(nn.HybridSequential(prefix=""), expand, 1, norm=False,
              bias=True)
    e3 = _cna(nn.HybridSequential(prefix=""), expand, 3, 1, 1, norm=False,
              bias=True)
    return _seq(
        _cna(nn.HybridSequential(prefix=""), squeeze, 1, norm=False,
             bias=True),
        _Fork(e1, e3))


# version -> (stem (ch, k, s), fire squeeze widths between the pools)
_SQUEEZENET_SPEC = {
    "1.0": ((96, 7, 2), [[16, 16, 32], [32, 48, 48, 64], [64]]),
    "1.1": ((64, 3, 2), [[16, 16], [32, 32], [48, 48, 64, 64]]),
}


def _squeezenet(version, classes=1000, **kwargs):
    (ch, k, s), groups = _SQUEEZENET_SPEC[version]

    def build():
        feats = nn.HybridSequential(prefix="")
        _cna(feats, ch, k, s, norm=False, act="relu", bias=True)
        for squeezes in groups:
            feats.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            for sq in squeezes:
                feats.add(_fire(sq, sq * 4))
        feats.add(nn.Dropout(0.5))
        out = nn.HybridSequential(prefix="")
        _cna(out, classes, 1, norm=False, act="relu", bias=True)
        out.add(nn.GlobalAvgPool2D())
        out.add(nn.Flatten())
        return feats, out

    return _Net(build, **kwargs)


def _strip(kw):
    if kw.pop("pretrained", False):
        raise NotImplementedError(
            "pretrained weights are not published for this family; load a "
            "local checkpoint via net.load_parameters() instead")
    kw.pop("ctx", None)
    return kw


def squeezenet1_0(**kw):
    return _squeezenet("1.0", **_strip(kw))


def squeezenet1_1(**kw):
    return _squeezenet("1.1", **_strip(kw))


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------

# depth -> (stem width, growth rate, layers per dense block)
_DENSENET_SPEC = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def _bn_relu_conv(seq, ch, k, p=0):
    seq.add(nn.BatchNorm())
    seq.add(nn.Activation("relu"))
    seq.add(nn.Conv2D(ch, kernel_size=k, padding=p, use_bias=False))
    return seq


def _dense_block(n_layers, growth, bn_size, dropout, index):
    block = nn.HybridSequential(prefix=f"stage{index}_")
    with block.name_scope():
        for _ in range(n_layers):
            body = nn.HybridSequential(prefix="")
            _bn_relu_conv(body, bn_size * growth, 1)
            _bn_relu_conv(body, growth, 3, 1)
            if dropout:
                body.add(nn.Dropout(dropout))
            block.add(_DenseCell(body))
    return block


def _densenet(depth, bn_size=4, dropout=0.0, classes=1000, **kwargs):
    stem_w, growth, blocks = _DENSENET_SPEC[depth]

    def build():
        feats = nn.HybridSequential(prefix="")
        _cna(feats, stem_w, 7, 2, 3, act="relu")
        feats.add(nn.MaxPool2D(3, 2, 1))
        width = stem_w
        for i, n in enumerate(blocks):
            feats.add(_dense_block(n, growth, bn_size, dropout, i + 1))
            width += n * growth
            if i != len(blocks) - 1:
                width //= 2
                feats.add(_bn_relu_conv(nn.HybridSequential(prefix=""),
                                        width, 1))
                feats.add(nn.AvgPool2D(2, 2))
        feats.add(nn.BatchNorm())
        feats.add(nn.Activation("relu"))
        feats.add(nn.GlobalAvgPool2D())
        feats.add(nn.Flatten())
        return feats, nn.Dense(classes)

    return _Net(build, **kwargs)


def densenet121(**kw):
    return _densenet(121, **_strip(kw))


def densenet161(**kw):
    return _densenet(161, **_strip(kw))


def densenet169(**kw):
    return _densenet(169, **_strip(kw))


def densenet201(**kw):
    return _densenet(201, **_strip(kw))


# ---------------------------------------------------------------------------
# MobileNet v1/v2
# ---------------------------------------------------------------------------

# v1: (pointwise out width, stride of the depthwise before it) per unit
_MOBILENET_V1_SPEC = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                      (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                      (512, 1), (1024, 2), (1024, 1)]

# v2: (expansion t, out width, stride) per inverted-residual unit
_MOBILENET_V2_SPEC = [(1, 16, 1), (6, 24, 2), (6, 24, 1), (6, 32, 2),
                      (6, 32, 1), (6, 32, 1), (6, 64, 2), (6, 64, 1),
                      (6, 64, 1), (6, 64, 1), (6, 96, 1), (6, 96, 1),
                      (6, 96, 1), (6, 160, 2), (6, 160, 1), (6, 160, 1),
                      (6, 320, 1)]


def _mobilenet_v1(multiplier=1.0, classes=1000, **kwargs):
    def build():
        feats = nn.HybridSequential(prefix="")
        width = int(32 * multiplier)
        _cna(feats, width, 3, 2, 1)
        for out_w, stride in _MOBILENET_V1_SPEC:
            out_w = int(out_w * multiplier)
            _cna(feats, width, 3, stride, 1, g=width)   # depthwise
            _cna(feats, out_w, 1)                       # pointwise
            width = out_w
        feats.add(nn.GlobalAvgPool2D())
        feats.add(nn.Flatten())
        return feats, nn.Dense(classes)

    return _Net(build, **kwargs)


def _inverted_residual(in_w, t, out_w, stride):
    body = nn.HybridSequential(prefix="")
    mid = in_w * t
    _cna(body, mid, 1, act="relu6")
    _cna(body, mid, 3, stride, 1, g=mid, act="relu6")
    _cna(body, out_w, 1, act=None)  # linear projection
    if stride == 1 and in_w == out_w:
        return _Residual(body)
    return body


def _mobilenet_v2(multiplier=1.0, classes=1000, **kwargs):
    def build():
        feats = nn.HybridSequential(prefix="features_")
        width = int(32 * multiplier)
        _cna(feats, width, 3, 2, 1, act="relu6")
        for t, out_w, stride in _MOBILENET_V2_SPEC:
            out_w = int(out_w * multiplier)
            feats.add(_inverted_residual(width, t, out_w, stride))
            width = out_w
        last = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _cna(feats, last, 1, act="relu6")
        feats.add(nn.GlobalAvgPool2D())
        out = nn.HybridSequential(prefix="output_")
        out.add(nn.Conv2D(classes, 1, use_bias=False))
        out.add(nn.Flatten())
        return feats, out

    return _Net(build, **kwargs)


def _mobilenet_factory(builder, multiplier, name):
    def make(**kw):
        return builder(multiplier, **_strip(kw))
    make.__name__ = name
    return make


mobilenet1_0 = _mobilenet_factory(_mobilenet_v1, 1.0, "mobilenet1_0")
mobilenet0_75 = _mobilenet_factory(_mobilenet_v1, 0.75, "mobilenet0_75")
mobilenet0_5 = _mobilenet_factory(_mobilenet_v1, 0.5, "mobilenet0_5")
mobilenet0_25 = _mobilenet_factory(_mobilenet_v1, 0.25, "mobilenet0_25")
mobilenet_v2_1_0 = _mobilenet_factory(_mobilenet_v2, 1.0, "mobilenet_v2_1_0")
mobilenet_v2_0_75 = _mobilenet_factory(_mobilenet_v2, 0.75,
                                       "mobilenet_v2_0_75")
mobilenet_v2_0_5 = _mobilenet_factory(_mobilenet_v2, 0.5, "mobilenet_v2_0_5")
mobilenet_v2_0_25 = _mobilenet_factory(_mobilenet_v2, 0.25,
                                       "mobilenet_v2_0_25")


# ---------------------------------------------------------------------------
# Inception V3
# ---------------------------------------------------------------------------
#
# A branch is a list of units: ("conv", ch, kernel, stride, pad),
# ("avg", k, s, p), ("max", k, s), or ("fork", [branch, ...]) for the
# split-concat tails of the "E" blocks.


def _inception_branch(units):
    seq = nn.HybridSequential(prefix="")
    for u in units:
        kind = u[0]
        if kind == "conv":
            _, ch, k, s, p = u
            _cna(seq, ch, k, s, p, eps=0.001)
        elif kind == "avg":
            seq.add(nn.AvgPool2D(u[1], u[2], u[3]))
        elif kind == "max":
            seq.add(nn.MaxPool2D(u[1], u[2]))
        elif kind == "fork":
            seq.add(_Fork(*[_inception_branch(b) for b in u[1]]))
        else:
            raise ValueError(f"unknown inception unit kind {kind!r}")
    return seq


def _mixed(*branches):
    return _Fork(*[_inception_branch(b) for b in branches])


def _conv(ch, k, s=1, p=0):
    return ("conv", ch, k, s, p)


def _inception_a(pool_w):
    return _mixed(
        [_conv(64, 1)],
        [_conv(48, 1), _conv(64, 5, 1, 2)],
        [_conv(64, 1), _conv(96, 3, 1, 1), _conv(96, 3, 1, 1)],
        [("avg", 3, 1, 1), _conv(pool_w, 1)])


def _inception_b():
    return _mixed(
        [_conv(384, 3, 2)],
        [_conv(64, 1), _conv(96, 3, 1, 1), _conv(96, 3, 2)],
        [("max", 3, 2)])


def _inception_c(w7):
    return _mixed(
        [_conv(192, 1)],
        [_conv(w7, 1), _conv(w7, (1, 7), 1, (0, 3)),
         _conv(192, (7, 1), 1, (3, 0))],
        [_conv(w7, 1), _conv(w7, (7, 1), 1, (3, 0)),
         _conv(w7, (1, 7), 1, (0, 3)), _conv(w7, (7, 1), 1, (3, 0)),
         _conv(192, (1, 7), 1, (0, 3))],
        [("avg", 3, 1, 1), _conv(192, 1)])


def _inception_d():
    return _mixed(
        [_conv(192, 1), _conv(320, 3, 2)],
        [_conv(192, 1), _conv(192, (1, 7), 1, (0, 3)),
         _conv(192, (7, 1), 1, (3, 0)), _conv(192, 3, 2)],
        [("max", 3, 2)])


def _inception_e():
    split = [[_conv(384, (1, 3), 1, (0, 1))], [_conv(384, (3, 1), 1, (1, 0))]]
    return _mixed(
        [_conv(320, 1)],
        [_conv(384, 1), ("fork", split)],
        [_conv(448, 1), _conv(384, 3, 1, 1), ("fork", split)],
        [("avg", 3, 1, 1), _conv(192, 1)])


def inception_v3(classes=1000, **kw):
    kw = _strip(kw)

    def build():
        feats = nn.HybridSequential(prefix="")
        for ch, k, s, p in [(32, 3, 2, 0), (32, 3, 1, 0), (64, 3, 1, 1)]:
            _cna(feats, ch, k, s, p, eps=0.001)
        feats.add(nn.MaxPool2D(3, 2))
        for ch, k in [(80, 1), (192, 3)]:
            _cna(feats, ch, k, eps=0.001)
        feats.add(nn.MaxPool2D(3, 2))
        for pool_w in (32, 64, 64):
            feats.add(_inception_a(pool_w))
        feats.add(_inception_b())
        for w7 in (128, 160, 160, 192):
            feats.add(_inception_c(w7))
        feats.add(_inception_d())
        feats.add(_inception_e())
        feats.add(_inception_e())
        feats.add(nn.AvgPool2D(8))
        feats.add(nn.Dropout(0.5))
        feats.add(nn.Flatten())
        return feats, nn.Dense(classes)

    return _Net(build, **kw)


# ---------------------------------------------------------------------------
# LeNet
# ---------------------------------------------------------------------------


class LeNet(_Layer):
    """LeNet-5-style MNIST network: (conv, tanh, max-pool) twice, then a
    dense tanh layer and the output."""

    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            feats = nn.HybridSequential(prefix="")
            for ch in (20, 50):
                _cna(feats, ch, 5, norm=False, act="tanh", bias=True)
                feats.add(nn.MaxPool2D(2, 2))
            feats.add(nn.Flatten())
            feats.add(nn.Dense(500, activation="tanh"))
            self.features = feats
            self.output = nn.Dense(classes)
        self.eval()

    def forward(self, x):
        return self.output(self.features(x))


def lenet(**kw):
    return LeNet(**_strip(kw))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn, "alexnet": alexnet,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
    "inceptionv3": inception_v3, "lenet": lenet,
}


def get_model(name: str, **kwargs):
    """The zoo network ``name`` (a key of the reference's table)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
