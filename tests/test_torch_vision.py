"""mxtpu_torch's vision model zoo against the JAX package's, on the CPU.

* Every name of ``get_model``'s table builds in both packages with the same
  parameter names, shapes (deferred input widths as 0) and dtypes, in the
  same order, without a forward.
* One net per family (``classes=10``, B=1), at the smallest input whose
  last stage is still at least 1x1 (32 for the stride-32 nets, 63 for
  AlexNet, 299 for Inception-V3's 8x8 average pool, 16 for LeNet): the
  JAX net loads the port's weights from its ``.params`` file and runs
  hybridized (one compiled program a mode); the predict-mode and
  train-mode outputs, and BatchNorm's running statistics after the
  train-mode forward, agree within 1e-4 abs + 1e-4 rel. Dropout layers run
  at rate 0 in the train-mode pass of both packages: their generators
  differ by design (``tests/test_torch_train.py`` holds Dropout's
  statistics).
* ``.params`` files load both ways: the port's file into the JAX net and
  that net's file back into the port, bit for bit; so do dicts of numpy
  arrays by name (``convert.gluon_arrays``, ``load_gluon_arrays``).
* ``model_store`` finds a local ``<name>.params`` (``$MXTPU_REPO_DIR`` or
  ``~/.mxtpu/models``) and otherwise raises the reference's message;
  ``purge`` deletes the local files; a family without published weights
  refuses ``pretrained=True``.
"""

import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu import autograd as jag
from mxtpu import nd as jnd
from mxtpu.gluon.model_zoo import model_store as jstore
from mxtpu.gluon.model_zoo import vision as jvision

import mxtpu_torch as mx
from mxtpu_torch import autograd as ag
from mxtpu_torch import convert, nd
from mxtpu_torch.gluon.model_zoo import model_store, vision


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)

FAMILIES = [("resnet18_v1", 32), ("resnet18_v2", 32), ("vgg11_bn", 32),
            ("alexnet", 63), ("squeezenet1.1", 32), ("densenet121", 32),
            ("mobilenet0.25", 32), ("mobilenetv2_0.25", 32),
            ("inceptionv3", 299), ("lenet", 16)]


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.Context("cpu"):
        yield


def _table(net):
    return [(k, tuple(p.shape), str(p.dtype))
            for k, p in net.collect_params().items()]


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _input(name, size, seed=0):
    ch = 1 if name == "lenet" else 3
    return np.random.RandomState(seed).randn(1, ch, size, size) \
        .astype(np.float32)


def test_every_name_is_in_both_tables():
    assert sorted(vision._models) == sorted(jvision._models)
    assert set(vision.__all__) == set(jvision.__all__)


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_names_shapes_dtypes_equal_jax(name):
    jnet = jvision.get_model(name, prefix="net_")
    tnet = vision.get_model(name, prefix="net_")
    assert _table(tnet) == _table(jnet)


def _pair(name, size, tmp_path):
    """The port's net, initialized (Xavier) and completed by one predict
    forward, and the JAX net loaded from its ``.params`` file and
    hybridized (one compiled program a mode: its eager ops compile one by
    one, minutes for the larger nets on the CPU)."""
    x = _input(name, size)
    tnet = vision.get_model(name, classes=10, prefix="net_")
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    tnet(nd.array(x))
    f = str(tmp_path / "port.params")
    tnet.save_parameters(f)
    jnet = jvision.get_model(name, classes=10, prefix="net_")
    jnet.load_parameters(f)
    jnet.hybridize()
    return jnet, tnet, x


@pytest.mark.parametrize("name,size", FAMILIES, ids=[n for n, _ in FAMILIES])
def test_family_forward_and_running_stats_equal_jax(name, size, tmp_path):
    jnet, tnet, x = _pair(name, size, tmp_path)
    jo = jnet(jnd.array(x)).asnumpy()
    to = tnet(nd.array(x)).asnumpy()
    assert to.shape == (1, 10)
    np.testing.assert_allclose(to, jo, **TOL)
    for net in (jnet, tnet):
        for block in _blocks(net):
            if type(block).__name__ == "Dropout":
                block._rate = 0.0
    with jag.train_mode():
        jo = jnet(jnd.array(x)).asnumpy()
    with ag.train_mode():
        to = tnet(nd.array(x)).asnumpy()
    np.testing.assert_allclose(to, jo, **TOL)
    jw, tw = _weights(jnet), _weights(tnet)
    assert list(tw) == list(jw)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **TOL)


def _blocks(net):
    out = [net]
    for child in net._children.values() if hasattr(net, "_children") \
            else net._child_blocks():
        out += _blocks(child)
    return out


@pytest.mark.parametrize("name", ["resnet18_v2", "mobilenet0.25"])
def test_params_files_load_both_ways(name, tmp_path):
    """The port's file into the JAX net (``_pair``) and the JAX net's file
    back into a fresh port net: the same bits."""
    jnet, tnet, x = _pair(name, 32, tmp_path)
    f = str(tmp_path / "jax.params")
    jnet.save_parameters(f)
    back = vision.get_model(name, classes=10, prefix="net_")
    back.load_parameters(f, ctx=mx.cpu())
    tw, bw = _weights(tnet), _weights(back)
    assert list(bw) == list(tw)
    for k in tw:
        np.testing.assert_array_equal(bw[k], tw[k], err_msg=k)
    np.testing.assert_array_equal(back(nd.array(x)).asnumpy(),
                                  tnet(nd.array(x)).asnumpy())


def test_numpy_arrays_by_name_cross_both_ways(tmp_path):
    jnet, tnet, x = _pair("mobilenetv2_0.25", 32, tmp_path)
    jarrays = {k[len("net_"):]: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    fresh = vision.get_model("mobilenetv2_0.25", classes=10, prefix="other_")
    convert.load_gluon_arrays(fresh, jarrays, ctx=mx.cpu())
    np.testing.assert_array_equal(fresh(nd.array(x)).asnumpy(),
                                  tnet(nd.array(x)).asnumpy())
    back = convert.gluon_arrays(fresh)
    assert list(back) == list(jarrays)
    for k, v in jarrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError, match="no such parameter"):
        convert.load_gluon_arrays(fresh, {"nope_weight": v}, ctx=mx.cpu())


def test_model_store_is_local_only(tmp_path, monkeypatch):
    repo = tmp_path / "repo"
    repo.mkdir()
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("MXTPU_REPO_DIR", raising=False)
    with pytest.raises(RuntimeError) as port_err:
        model_store.get_model_file("resnet18_v1")
    with pytest.raises(RuntimeError) as jax_err:
        jstore.get_model_file("resnet18_v1")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(RuntimeError, match="not found locally"):
        vision.get_model("resnet18_v1", pretrained=True, ctx=mx.cpu())
    with pytest.raises(NotImplementedError, match="not published"):
        vision.get_model("squeezenet1.1", pretrained=True)
    x = _input("resnet18_v1", 32)
    src = vision.get_model("resnet18_v1", classes=10, prefix="net_")
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    want = src(nd.array(x)).asnumpy()
    src.save_parameters(str(repo / "resnet18_v1.params"))
    monkeypatch.setenv("MXTPU_REPO_DIR", str(repo))
    assert model_store.get_model_file("resnet18_v1") == \
        str(repo / "resnet18_v1.params")
    net = vision.get_model("resnet18_v1", classes=10, pretrained=True,
                           ctx=mx.cpu(), prefix="net_")
    np.testing.assert_array_equal(net(nd.array(x)).asnumpy(), want)
    model_store.purge(str(repo))
    assert not list(repo.iterdir())
