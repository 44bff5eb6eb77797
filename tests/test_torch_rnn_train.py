"""mxtpu_torch's ``BucketSentenceIter`` and the word LM's training
against the JAX package's, on the CPU.

* ``BucketSentenceIter``: the same buckets, batches, labels, bucket keys
  and descriptors as the JAX package's, with the default buckets, given
  ones and shuffled (numpy's global generator seeded alike); its batches
  are host arrays.
* 3 ``DataParallelTrainer`` SGD-momentum steps (lr 1.0, momentum 0.9, as
  the reference benchmark's) of a small LSTM word LM (the benchmark's
  shape of model: Embedding -> 2-layer LSTM -> Dense, transposing ``(N,
  T)`` to ``(T, N)`` inside its forward) against the JAX trainer: losses
  within 1e-4 relative, weights within 1e-4 abs + 1e-3 rel; the trainer
  gives the LSTM a device seed for its dropout between layers.
"""

import numpy as np
import pytest
import torch

from mxtpu import gluon as jgluon
from mxtpu import nd as jnd
from mxtpu import optimizer as jopt
from mxtpu import parallel as jparallel
from mxtpu import rnn as jrnn_iter
from mxtpu.gluon import rnn as jrnn
from mxtpu.ndarray.ndarray import NDArray as JNDArray

import mxtpu_torch as mx
from mxtpu_torch import gluon
from mxtpu_torch import optimizer as topt
from mxtpu_torch import rnn as rnn_iter
from mxtpu_torch.convert import gluon_arrays
from mxtpu_torch.gluon import rnn
from mxtpu_torch.parallel import DataParallelTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_RTOL = 1e-4
W_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    state = np.random.get_state()
    with mx.Context("cpu"):
        yield
    np.random.set_state(state)


def _rs(seed):
    return np.random.RandomState(seed)


# ---------------------------------------------------------------------------
# BucketSentenceIter
# ---------------------------------------------------------------------------


def _sentences(seed, n, vocab=20):
    rs = _rs(seed)
    return [list(rs.randint(1, vocab, rs.randint(1, 14))) for _ in range(n)]


def _batches(it):
    it.reset()
    return [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
             [tuple(d) for d in b.provide_data]) for b in it]


@pytest.mark.parametrize("buckets,shuffle",
                         [(None, False), ([4, 8, 12], False),
                          ([4, 8, 12], True)],
                         ids=["default", "given", "shuffled"])
def test_bucket_sentence_iter_matches_jax(buckets, shuffle):
    sents = _sentences(1, 80)
    kw = dict(batch_size=4, buckets=buckets, invalid_label=0,
              shuffle=shuffle)
    np.random.seed(0)
    t_it = rnn_iter.BucketSentenceIter(sents, **kw)
    tb = _batches(t_it)
    np.random.seed(0)
    j_it = jrnn_iter.BucketSentenceIter(sents, **kw)
    jb = _batches(j_it)
    assert t_it.buckets == j_it.buckets and t_it.ndiscard == j_it.ndiscard
    assert t_it.default_bucket_key == j_it.default_bucket_key
    assert [tuple(d) for d in t_it.provide_data] == \
        [tuple(d) for d in j_it.provide_data]
    assert len(tb) == len(jb) > 0
    for (tk, td, tlb, tpd), (jk, jd, jlb, jpd) in zip(tb, jb):
        assert tk == jk and tpd == jpd
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tlb, jlb)
    t_it.reset()
    assert next(t_it).data[0].context == mx.cpu()   # host arrays


# ---------------------------------------------------------------------------
# the word LM through DataParallelTrainer
# ---------------------------------------------------------------------------

V, E, H, T, B = 20, 8, 8, 6, 4


class _TLM(gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.embedding = gluon.nn.Embedding(V, E)
            self.lstm = rnn.LSTM(H, num_layers=2, layout="TNC", input_size=E)
            self.decoder = gluon.nn.Dense(V, in_units=H, flatten=False)

    def forward(self, x):                 # x (N, T) -> logits (T * N, V)
        return self.decoder(self.lstm(self.embedding(x.t()))).reshape(-1, V)


class _JLM(jgluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.embedding = jgluon.nn.Embedding(V, E)
            self.lstm = jrnn.LSTM(H, num_layers=2, layout="TNC", input_size=E)
            self.decoder = jgluon.nn.Dense(V, in_units=H, flatten=False)

    def forward(self, x):
        out = self.decoder(self.lstm(self.embedding(JNDArray(x.data.T))))
        return JNDArray(out.data.reshape(-1, V))


def test_word_lm_trainer_steps_match_jax():
    tnet = _TLM(prefix="lm_")
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    jnet = _JLM(prefix="lm_")
    jnet.initialize()
    jp = jnet.collect_params()
    for k, v in gluon_arrays(tnet).items():
        jp[jnet.prefix + k].set_data(jnd.array(v))
    jdpt = jparallel.DataParallelTrainer(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
        jopt.SGD(learning_rate=1.0, momentum=0.9),
        jparallel.make_mesh((1,), ("dp",)))
    tdpt = DataParallelTrainer(tnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                               topt.SGD(learning_rate=1.0, momentum=0.9),
                               device="cpu")
    assert tdpt._dropouts == [tnet.lstm]     # seeded between layers
    rs = _rs(0)
    tokens = rs.randint(0, V, (T, B))
    x = tokens.T.astype(np.float32)
    y = np.roll(tokens, -1, axis=0).reshape(-1).astype(np.float32)
    jl = [jdpt.step(jnd.array(x), jnd.array(y)) for _ in range(3)]
    tl = [tdpt.step(x, y) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    jw = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tw = {k: p.data().asnumpy() for k, p in tnet.collect_params().items()}
    assert list(tw) == list(jw)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **W_TOL)
