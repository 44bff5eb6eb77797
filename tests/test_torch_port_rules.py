"""The port's standing rules, checked on the source tree.

* Nothing under ``mxtpu_torch/`` and nothing in ``chip_smoke.py`` or
  ``kernel_sweep.py`` imports JAX or the JAX package ``mxtpu`` (relative
  imports inside the port are its own).
* Entry points run on the card unless the caller asks for the CPU: without
  CUDA, building a model, an engine or a ``DeviceFeed`` with no
  ``device``, an ``nd`` array with no ``ctx``, an ``rtc`` module, a
  Gluon ``initialize()`` of a block (a vision zoo net too) or a parameter
  with no ``ctx``, a ``Symbol.simple_bind`` with no ``ctx``, a ``Module``
  with no ``context`` or a ``DataParallelTrainer`` with no ``device`` over
  a ``get_model`` net, an ``ImageRecordIter`` that stages to the card
  (``device_feed=True`` or a CUDA ``ctx``) or a ``DataLoader`` with a
  CUDA ``ctx`` raises instead of running on the CPU; so do the sparse
  constructors (``row_sparse_array``, ``csr_matrix``, ``sparse.zeros``)
  with no ``ctx``.
* Each ported module with a counterpart in the JAX package lies at the
  counterpart's path.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_sources():
    files = sorted((ROOT / "mxtpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_sweep.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "mxtpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_mxtpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("module", [
    "serving/router.py", "observability/exporter.py",
    "observability/flops.py", "initializer.py", "gluon/parameter.py",
    "gluon/block.py", "gluon/nn/basic_layers.py", "gluon/contrib/nn.py",
    "gluon/model_zoo/transformer.py", "gluon/loss.py", "gluon/utils.py",
    "engine.py", "checkpoint/atomic_io.py", "ops/optimizer_ops.py",
    "ndarray/fused_optimizer.py", "optimizer.py", "kvstore.py",
    "gluon/trainer.py", "metric.py", "attribute.py", "symbol/symbol.py",
    "symbol/executor.py", "symbol/__init__.py", "io.py", "callback.py",
    "checkpoint/manager.py", "model.py", "monitor.py", "step_cache.py",
    "module.py", "serving/chained.py", "autograd.py", "ops/attention.py",
    "gluon/nn/conv_layers.py", "gluon/model_zoo/vision.py",
    "gluon/model_zoo/model_store.py", "gluon/model_zoo/__init__.py",
    "parallel/data_parallel.py", "ops/quantization.py", "quant/calibrate.py",
    "quant/train.py", "contrib/__init__.py", "contrib/quantization.py",
    "ops/nn.py", "profiler.py", "ops/sequence.py", "ops/rnn.py",
    "ops/control_flow.py", "jit.py", "gluon/rnn/__init__.py",
    "gluon/rnn/rnn_cell.py", "gluon/rnn/rnn_layer.py",
    "gluon/contrib/rnn.py", "gluon/contrib/__init__.py", "rnn.py",
    "recordio.py", "native.py", "image/__init__.py", "image/image.py",
    "ops/image_ops.py", "gluon/data/__init__.py", "gluon/data/sampler.py",
    "gluon/data/dataset.py", "gluon/data/dataloader.py",
    "gluon/data/vision/__init__.py", "gluon/data/vision/datasets.py",
    "gluon/data/vision/transforms.py", "ops/order.py", "ops/contrib_ops.py",
    "ops/detection.py", "ops/spatial.py", "image/detection.py",
    "ndarray/sparse.py", "ndarray/legacy_io.py", "ops/linalg.py"])
def test_the_counterparts_are_checked(module):
    """Each module that has a counterpart in the JAX package lies where
    its counterpart does, and the import rule above reads it."""
    path = ROOT / "mxtpu_torch" / module
    assert path in _port_sources()
    assert (ROOT / "mxtpu" / module).exists()


def test_entry_points_refuse_the_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card")
    from mxtpu_torch import resolve_device
    from mxtpu_torch.gluon.model_zoo import TransformerLM, transformer_lm
    from mxtpu_torch.serving import ServingEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_lm("tiny", vocab_size=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(50, units=64, num_layers=1, num_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    net = transformer_lm("tiny", vocab_size=50, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(net, quant="int8_kv")
    from mxtpu_torch.optimizer import Adam
    from mxtpu_torch.parallel import DataParallelTrainer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataParallelTrainer(net, lambda out, y: out.sum(), Adam())
    from mxtpu_torch.device_feed import DeviceFeed
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFeed([])
    from mxtpu_torch import nd, rtc
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nd.array([1.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rtc.CudaModule("")
    # Gluon: initialize() with no ctx is the card, also for a model built
    # on the CPU (its seed draw gives way to the initializer)
    from mxtpu_torch import gluon
    with pytest.raises(RuntimeError, match="device='cpu'"):
        net.initialize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gluon.nn.Dense(3, in_units=2).initialize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gluon.Parameter("w", shape=(2, 2)).initialize()
    # the symbolic and Module front ends
    import mxtpu_torch as mx
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2) \
            .simple_bind(data=(1, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mx.mod.Module(net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mx.mod.Module(mx.sym.Variable("data"))
    # a vision zoo net: initialize() with no ctx, and a DataParallelTrainer
    # with no device over a net from get_model
    from mxtpu_torch.gluon.model_zoo import get_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("resnet18_v1", classes=10).initialize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataParallelTrainer(get_model("resnet50_v1"),
                            gluon.loss.SoftmaxCrossEntropyLoss(), Adam())


def test_sparse_constructors_refuse_the_cpu_without_cuda():
    """``row_sparse_array``, ``csr_matrix`` and ``sparse.zeros`` with no
    ``ctx`` put their arrays on the card, as ``nd.array`` does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: no ctx is the card")
    import numpy as np
    import scipy.sparse as sps
    from mxtpu_torch.ndarray import sparse
    dense = np.eye(3, dtype=np.float32)
    calls = [
        lambda: sparse.row_sparse_array((np.ones((1, 3), np.float32), [1]),
                                        shape=(4, 3)),
        lambda: sparse.row_sparse_array(dense),
        lambda: sparse.csr_matrix(dense),
        lambda: sparse.csr_matrix(sps.csr_matrix(dense)),
        lambda: sparse.csr_matrix((np.ones(1), [0], [0, 1, 1]), shape=(2, 3)),
        lambda: sparse.zeros("row_sparse", (4, 3)),
        lambda: sparse.zeros("csr", (4, 3)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_the_data_path_refuses_the_cpu_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the feeds stage there")
    import numpy as np
    import mxtpu_torch as mx
    from mxtpu_torch import recordio
    from mxtpu_torch.gluon.data import ArrayDataset, DataLoader
    rec = str(tmp_path / "a.rec")
    img = np.zeros((8, 8, 3), np.uint8)
    with recordio.MXRecordIO(rec, "w") as w:
        w.write(recordio.pack_img(recordio.IRHeader(0, 1.0, 0, 0), img))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mx.io.ImageRecordIter(rec, (3, 8, 8), 1, device_feed=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mx.io.ImageRecordIter(rec, (3, 8, 8), 1, ctx=mx.gpu(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataLoader(ArrayDataset(np.zeros((4, 2))), 2, ctx=mx.gpu(0))
