"""mxtpu_torch's symbolic front end against the JAX package's, on the CPU.

* Every op wrapper the JAX package's ``tests/test_symbol.py`` uses
  (``Convolution``, ``Activation``, ``Pooling``, ``Flatten``,
  ``FullyConnected``, ``SoftmaxOutput``, ``BatchNorm``, ``sum``, and
  ``Group`` of two heads): the same graph bound to the same seeded numpy
  arrays in both packages gives the same outputs, and the gradients of
  sum(out * c) for a seeded c, within 1e-5 rel + 1e-6 abs.
* ``infer_shape``/``infer_type`` equal; ``tojson`` equal as parsed JSON,
  and each package loads the other's; an MXNet 1.x nnvm JSON loads and
  runs.
* ``Executor``: ``grad_req`` write, add and null; a BatchNorm graph's
  moving statistics after a training forward; ``backward`` twice after
  one forward; a fresh dropout mask each forward that its backward uses
  (``tests/test_step_cache.py:234-286``).
* ``nd.contrib.flash_attention`` and ``sym.contrib.flash_attention``
  against the JAX Pallas kernels run in interpret mode: outputs within
  1e-5, gradients within 1e-4.
* ``SymbolBlock`` and ``SymbolBlock.imports`` against the JAX package's;
  ``AttrScope``; ``bool(sym)`` refused.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import nd as jnd
from mxtpu import symbol as jsym
from mxtpu.gluon.block import SymbolBlock as JSymbolBlock
from mxtpu.ops.attention import (_flash_attention_pallas,
                                 _flash_backward_pallas)
from mxtpu.symbol.symbol import _reset_names as jax_reset_names

import mxtpu_torch as mx
from mxtpu_torch import autograd as ag
from mxtpu_torch import nd
from mxtpu_torch import symbol as sym
from mxtpu_torch.gluon import SymbolBlock
from mxtpu_torch.symbol.symbol import _reset_names


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


@pytest.fixture(autouse=True)
def _on_cpu():
    _reset_names()
    jax_reset_names()
    with mx.Context("cpu"):
        yield


# ---------------------------------------------------------------------------
# the same graph in both packages
# ---------------------------------------------------------------------------


def _graph(s, which):
    """Graph ``which`` built with package namespace ``s``, and its input
    shapes."""
    data = s.Variable("data")
    if which == "Convolution":
        return s.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                             name="conv"), {"data": (2, 3, 6, 6)}
    if which == "Activation":
        return s.Activation(s.FullyConnected(data, num_hidden=5, name="fc"),
                            act_type="tanh"), {"data": (3, 4)}
    if which == "Pooling":
        return s.Pooling(s.Convolution(data, kernel=(3, 3), num_filter=2,
                                       name="conv"),
                         kernel=(2, 2), stride=(2, 2), pool_type="max"), \
            {"data": (2, 1, 6, 6)}
    if which == "Flatten":
        return s.FullyConnected(s.Flatten(data), num_hidden=3, name="fc"), \
            {"data": (2, 2, 3)}
    if which == "FullyConnected":
        return s.FullyConnected(data, num_hidden=6, name="fc"), \
            {"data": (4, 5)}
    if which == "SoftmaxOutput":
        return s.SoftmaxOutput(s.FullyConnected(data, num_hidden=3,
                                                name="fc"), name="softmax"), \
            {"data": (4, 5), "softmax_label": (4,)}
    if which == "BatchNorm":
        return s.FullyConnected(s.BatchNorm(data, fix_gamma=False,
                                            name="bn"),
                                num_hidden=4, name="fc"), {"data": (6, 3)}
    if which == "sum":
        return s.sum(s.FullyConnected(data, num_hidden=4, name="fc"),
                     axis=1), {"data": (3, 5)}
    if which == "Group":
        fc = s.FullyConnected(data, num_hidden=4, name="fc")
        return s.Group([s.Activation(fc, act_type="relu"),
                        s.sum(fc, axis=1)]), {"data": (3, 5)}
    raise KeyError(which)


OPS = ["Convolution", "Activation", "Pooling", "Flatten", "FullyConnected",
       "SoftmaxOutput", "BatchNorm", "sum", "Group"]


def _values(net, shapes, seed):
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n == "softmax_label":
            args[n] = rs.randint(0, 3, s).astype(np.float32)
        else:
            args[n] = rs.randn(*s).astype(np.float32)
    auxs = {n: (np.ones(s, np.float32) if n.endswith("var")
                else np.zeros(s, np.float32))
            for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _run(pkg_sym, pkg_nd, ctx, which, seed, grad_req="write"):
    net, shapes = _graph(pkg_sym, which)
    args, auxs = _values(net, shapes, seed)
    arrs = {k: pkg_nd.array(v) for k, v in args.items()}
    grads = {k: pkg_nd.zeros(v.shape) for k, v in args.items()}
    ex = net.bind(ctx, arrs, args_grad=grads, grad_req=grad_req,
                  aux_states={k: pkg_nd.array(v) for k, v in auxs.items()})
    outs = ex.forward(is_train=True)
    rs = np.random.RandomState(seed + 100)
    cots = [rs.randn(*o.shape).astype(np.float32) for o in outs]
    ex.backward([pkg_nd.array(c) for c in cots])
    return ([o.asnumpy() for o in outs],
            {k: v.asnumpy() for k, v in ex.grad_dict.items()},
            {k: v.asnumpy() for k, v in ex.aux_dict.items()})


@pytest.mark.parametrize("which", OPS)
def test_op_wrapper_forward_and_gradients_match_jax(which):
    j_out, j_grad, j_aux = _run(jsym, jnd, None, which, seed=len(which))
    t_out, t_grad, t_aux = _run(sym, nd, mx.cpu(), which, seed=len(which))
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a, b, **TOL)
    assert sorted(t_grad) == sorted(j_grad)
    for k in j_grad:
        np.testing.assert_allclose(t_grad[k], j_grad[k], err_msg=k, **TOL)
    for k in j_aux:
        np.testing.assert_allclose(t_aux[k], j_aux[k], err_msg=k, **TOL)


@pytest.mark.parametrize("which", OPS)
def test_infer_shape_type_and_json_match_jax(which):
    jnet, shapes = _graph(jsym, which)
    tnet, _ = _graph(sym, which)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_outputs() == jnet.list_outputs()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert tnet.infer_shape(**shapes) == jnet.infer_shape(**shapes)
    assert tnet.infer_type() == jnet.infer_type()
    assert json.loads(tnet.tojson()) == json.loads(jnet.tojson())
    # each package loads the other's graph
    assert json.loads(sym.load_json(jnet.tojson()).tojson()) == \
        json.loads(jnet.tojson())
    assert json.loads(jsym.load_json(tnet.tojson()).tojson()) == \
        json.loads(tnet.tojson())


def test_lenet_infer_shape_and_attr_scope():
    data = sym.Variable("data")
    with mx.AttrScope(ctx_group="dev1"):
        c1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=6,
                             name="conv1")
    p1 = sym.Pooling(sym.Activation(c1, act_type="tanh"), kernel=(2, 2),
                     stride=(2, 2), pool_type="max")
    fc = sym.FullyConnected(sym.Flatten(p1), num_hidden=10, name="fc1")
    net = sym.SoftmaxOutput(fc, name="softmax")
    arg_shapes, out_shapes, _ = net.infer_shape(data=(8, 1, 28, 28))
    shapes = dict(zip(net.list_arguments(), arg_shapes))
    assert shapes["conv1_weight"] == (6, 1, 5, 5)
    assert shapes["fc1_weight"] == (10, 6 * 12 * 12)
    assert shapes["softmax_label"] == (8,)
    assert out_shapes == [(8, 10)]
    assert c1.attr("ctx_group") == "dev1"
    assert net.attr_dict()["conv1"]["ctx_group"] == "dev1"
    assert sym.load_json(net.tojson()).attr_dict() == net.attr_dict()
    with pytest.raises(mx.base.NotImplementedForSymbol):
        bool(data == c1)


def _ref_mlp_json():
    """An MLP graph in MXNet 1.x's nnvm schema (all-string attrs, explicit
    weight/bias nodes, 3-int input refs)."""
    return json.dumps({
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "null", "name": "fc1_weight", "inputs": []},
            {"op": "null", "name": "fc1_bias", "inputs": []},
            {"op": "FullyConnected", "name": "fc1",
             "attrs": {"num_hidden": "8", "no_bias": "False",
                       "workspace": "512"},
             "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0]]},
            {"op": "Activation", "name": "relu1",
             "attrs": {"act_type": "relu"}, "inputs": [[3, 0, 0]]},
            {"op": "null", "name": "fc2_weight", "inputs": []},
            {"op": "null", "name": "fc2_bias", "inputs": []},
            {"op": "FullyConnected", "name": "fc2",
             "attrs": {"num_hidden": "3"},
             "inputs": [[4, 0, 0], [5, 0, 0], [6, 0, 0]]},
            {"op": "null", "name": "softmax_label", "inputs": []},
            {"op": "SoftmaxOutput", "name": "softmax",
             "inputs": [[7, 0, 0], [8, 0, 0]]},
        ],
        "arg_nodes": [0, 1, 2, 5, 6, 8],
        "node_row_ptr": list(range(11)),
        "heads": [[9, 0, 0]],
        "attrs": {"mxnet_version": ["int", 10500]},
    })


def test_reference_mxnet_json_loads_and_runs():
    s = sym.load_json(_ref_mlp_json())
    js = jsym.load_json(_ref_mlp_json())
    assert s.list_arguments() == js.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
        "softmax_label"]
    rs = np.random.RandomState(0)
    feed = {"data": rs.rand(5, 4), "fc1_weight": rs.rand(8, 4),
            "fc1_bias": rs.rand(8), "fc2_weight": rs.rand(3, 8),
            "fc2_bias": rs.rand(3), "softmax_label": np.zeros(5)}
    feed = {k: v.astype(np.float32) for k, v in feed.items()}
    out = s.eval(**{k: nd.array(v) for k, v in feed.items()})[0].asnumpy()
    h = np.maximum(feed["data"] @ feed["fc1_weight"].T + feed["fc1_bias"], 0)
    logits = h @ feed["fc2_weight"].T + feed["fc2_bias"]
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(out, e / e.sum(axis=1, keepdims=True), **TOL)
    bad = json.loads(_ref_mlp_json())
    bad["nodes"][4]["attrs"]["no_such_attr"] = "1"
    with pytest.raises(ValueError, match="no_such_attr"):
        sym.load_json(json.dumps(bad))


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def test_executor_grad_req_write_add_null_match_jax():
    reqs = {"data": "null", "fc_weight": "add", "fc_bias": "write"}
    j = _run(jsym, jnd, None, "FullyConnected", 3, grad_req=reqs)
    t = _run(sym, nd, mx.cpu(), "FullyConnected", 3, grad_req=reqs)
    for k in reqs:
        np.testing.assert_allclose(t[1][k], j[1][k], err_msg=k, **TOL)
    assert not t[1]["data"].any()          # null: the buffer is untouched
    # add accumulates over backward calls, write overwrites
    net, shapes = _graph(sym, "FullyConnected")
    args, _ = _values(net, shapes, 3)
    ex = net.bind(mx.cpu(), {k: nd.array(v) for k, v in args.items()},
                  args_grad={k: nd.zeros(v.shape) for k, v in args.items()},
                  grad_req=reqs)
    ex.forward(is_train=True)
    ex.backward()
    w1, b1 = (ex.grad_dict[k].asnumpy() for k in ("fc_weight", "fc_bias"))
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["fc_weight"].asnumpy(), 2 * w1,
                               **TOL)
    np.testing.assert_array_equal(ex.grad_dict["fc_bias"].asnumpy(), b1)


def test_executor_backward_twice_and_fresh_dropout_each_forward():
    """Each forward draws a fresh mask, its backward (twice) uses that
    forward's mask, and a graph's backward matches the JAX package's
    closed form."""
    x = sym.Variable("x")
    d = sym.Dropout(x, p=0.5, name="drop")
    xv = np.random.RandomState(0).rand(64).astype(np.float32) + 0.5
    ex = d.bind(mx.cpu(), {"x": nd.array(xv)},
                args_grad={"x": nd.zeros((64,))})
    masks = []
    for _ in range(3):
        out = ex.forward(is_train=True)[0].asnumpy()
        for _ in range(2):
            ex.backward(nd.array(np.ones(64, np.float32)))
            np.testing.assert_allclose(
                (out != 0).astype(np.float32) * 2.0,
                ex.grad_dict["x"].asnumpy(), rtol=1e-6)
        masks.append(tuple(out != 0))
    assert len(set(masks)) > 1
    # the FullyConnected case of tests/test_step_cache.py: cot @ w, cot^T @ x
    xs, w = sym.Variable("x"), sym.Variable("w")
    y = sym.FullyConnected(xs, w, no_bias=True, num_hidden=3, name="fc")
    xv = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    wv = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    cot = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    ex = y.bind(mx.cpu(), {"x": nd.array(xv), "w": nd.array(wv)},
                args_grad={"x": nd.zeros((4, 5)), "w": nd.zeros((3, 5))})
    for _ in range(3):
        ex.forward()
        ex.backward(nd.array(cot))
        np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(), cot @ wv,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ex.grad_dict["w"].asnumpy(), cot.T @ xv,
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="backward before forward"):
        y.bind(mx.cpu(), {"x": nd.array(xv), "w": nd.array(wv)}).backward()


def test_simple_bind_and_reshape():
    net, _ = _graph(sym, "SoftmaxOutput")
    ex = net.simple_bind(mx.cpu(), data=(4, 5))
    assert ex.arg_dict["fc_weight"].shape == (3, 5)
    assert ex.grad_dict["fc_weight"].shape == (3, 5)
    ex2 = ex.reshape(data=(7, 5))
    assert ex2.forward()[0].shape == (7, 3)
    assert ex2.arg_dict["fc_weight"] is ex.arg_dict["fc_weight"]


# ---------------------------------------------------------------------------
# flash attention through nd and sym
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_nd_and_sym_match_pallas_interpret(causal):
    rs = np.random.RandomState(7 + causal)
    q, k, v, g = (rs.randn(1, 2, 128, 64).astype(np.float32)
                  for _ in range(4))
    scale = 1.0 / math.sqrt(64)
    qa, ka, va = map(jnp.asarray, (q, k, v))
    ref, lse = _flash_attention_pallas(qa, ka, va, causal=causal,
                                       scale=scale, interpret=True)
    ref_grads = _flash_backward_pallas(qa, ka, va, ref, lse, jnp.asarray(g),
                                       causal, scale, interpret=True)
    # nd.contrib.flash_attention under autograd
    arrs = [nd.array(a) for a in (q, k, v)]
    for a in arrs:
        a.attach_grad()
    with ag.record():
        out = nd.contrib.flash_attention(*arrs, causal=causal)
    out.backward(nd.array(g))
    np.testing.assert_allclose(out.asnumpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for a, r in zip(arrs, ref_grads):
        np.testing.assert_allclose(a.grad.asnumpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)
    assert nd.contrib.attention is not None
    # sym.contrib.flash_attention through an Executor
    qs, ks, vs = (sym.Variable(n) for n in "qkv")
    att = sym.contrib.flash_attention(qs, ks, vs, causal=causal)
    assert att.infer_shape(q=q.shape, k=k.shape, v=v.shape)[1] == [q.shape]
    ex = att.bind(mx.cpu(), dict(zip("qkv", map(nd.array, (q, k, v)))),
                  args_grad={n: nd.zeros(q.shape) for n in "qkv"})
    np.testing.assert_allclose(ex.forward(is_train=True)[0].asnumpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    ex.backward(nd.array(g))
    for n, r in zip("qkv", ref_grads):
        np.testing.assert_allclose(ex.grad_dict[n].asnumpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# SymbolBlock
# ---------------------------------------------------------------------------


def test_symbol_block_and_imports_match_jax(tmp_path):
    jnet, shapes = _graph(jsym, "BatchNorm")
    tnet, _ = _graph(sym, "BatchNorm")
    jblk = JSymbolBlock(jnet, ["data"])
    jblk.initialize(init=jmx.initializer.Xavier())
    x = np.random.RandomState(5).randn(6, 3).astype(np.float32)
    with jag.predict_mode():
        jblk(jnd.array(x))
    pf = str(tmp_path / "bn-0000.params")
    jnd.save(pf, {f"arg:{n}": p.data()
                  for n, p in jblk.collect_params().items()})
    sf = str(tmp_path / "bn-symbol.json")
    jnet.save(sf)
    tblk = SymbolBlock.imports(sf, ["data"], pf, ctx=mx.cpu())
    for blk, pkg_nd, pkg_ag in ((jblk, jnd, jag), (tblk, nd, ag)):
        xs = pkg_nd.array(x)
        with pkg_ag.record():
            y = blk(xs)
            loss = (y * y).sum()
        loss.backward()
    np.testing.assert_allclose(tblk(nd.array(x)).asnumpy(),
                               jblk(jnd.array(x)).asnumpy(), **TOL)
    for (n, jp), tp in zip(jblk.collect_params().items(),
                           tblk.collect_params().values()):
        assert tp.name == n
        np.testing.assert_allclose(tp.data().asnumpy(), jp.data().asnumpy(),
                                   err_msg=n, **TOL)
        if jp.grad_req != "null":
            np.testing.assert_allclose(tp.grad().asnumpy(),
                                       jp.grad().asnumpy(), err_msg=n,
                                       rtol=1e-4, atol=1e-5)
    # a block over a graph completes its shapes at the first forward
    blk = SymbolBlock(tnet, ["data"])
    blk.initialize(ctx=mx.cpu())
    assert blk(nd.array(x)).shape == (6, 4)
    assert blk.collect_params()["fc_weight"].shape == (4, 3)
    with pytest.raises(NotImplementedError, match="StableHLO"):
        blk.export(str(tmp_path / "e"))
