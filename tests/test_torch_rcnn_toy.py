"""The Faster R-CNN toy (``examples/train_rcnn_toy.py``) through the port
against the JAX package on the CPU. ``chip_smoke.example_xavier`` draws
the example's initial weights without JAX; they equal the JAX package's
draw bit for bit. From them the JAX package's graph, one jitted forward
and backward a step as its executor's backward compiles it, trains 150
steps on the example's batches at ``tests/test_examples.py``'s
configuration, and the port's ``simple_bind`` run
(``chip_smoke.rcnn_toy_train``) takes each of those steps from the JAX
run's weights before it. Every step's rpn_acc, roi_acc and pos_frac agree
exactly, the final weights within 1e-4 absolute + 1e-3 relative, and the
last step clears the example's bars.

Each step starts from the JAX run's weights because the run amplifies
rounding: a difference in the last bit of a sum moves a proposal across
the IoU threshold some 100 steps later, and the two runs then go their
own ways (the port on one thread against the port on two does so at step
100 of this run).
"""

import numpy as np
import pytest
import torch

import chip_smoke
import mxtpu_torch as mx

C = chip_smoke.RCNN_TOY


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this file runs: the suite runs in
    parallel workers on shared cores, where each worker's own thread pool
    would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _jax_bound(seed):
    """The example's graph bound in the JAX package, its weights drawn as
    ``main`` draws them after ``mx.rng.seed(seed)``."""
    import mxtpu as jmx
    from examples import train_rcnn_toy as T
    N = C["batch"]
    jmx.rng.seed(seed)
    out = T.build_symbol(N)
    shapes = {"data": (N, 3, T.SIZE, T.SIZE), "im_info": (N, 3),
              "rpn_label": (N, T.A * T.FEAT * T.FEAT),
              "bbox_target": (N, 4 * T.A, T.FEAT, T.FEAT),
              "bbox_weight": (N, 4 * T.A, T.FEAT, T.FEAT),
              "gt_boxes": (N, 4), "gt_cls": (N,)}
    grad_req = {n: ("null" if n in shapes else "write")
                for n in out.list_arguments()}
    ex = out.simple_bind(ctx=jmx.cpu(), grad_req=grad_req, **shapes)
    init = jmx.initializer.Xavier(magnitude=2.0)
    weights = [n for n in out.list_arguments() if n not in shapes]
    for n in weights:
        if n.endswith("_bias"):
            ex.arg_dict[n]._set_data(ex.arg_dict[n].data * 0)
        else:
            init(n, ex.arg_dict[n])
    return out, {n: ex.arg_dict[n].asnumpy() for n in weights}


@pytest.mark.parametrize("seed", [0, 1])
def test_example_weights_are_the_jax_draw(seed):
    _, ref = _jax_bound(seed)
    drawn = [n for n in ref if not n.endswith("_bias")]
    got = chip_smoke.example_xavier([ref[n].shape for n in drawn], seed, 2.0)
    for n, g in zip(drawn, got):
        assert g.dtype == ref[n].dtype and np.array_equal(g, ref[n]), n


def _jax_train(out, w0, steps):
    """The JAX package's run of the example: each step one jitted
    ``jax.vjp`` of the bound graph with unit head gradients (what its
    executor's backward compiles), then SGD; the metrics read the
    outputs from the weights before the update, as ``main`` reads
    ``ex.outputs``. Returns the metrics, the weights each step started
    from and the final weights."""
    import jax
    import jax.numpy as jnp
    from examples import train_rcnn_toy as T
    from mxtpu import autograd as jag
    from mxtpu.symbol.symbol import eval_graph
    N, lr = C["batch"], C["lr"]

    @jax.jit
    def step(w, feed):
        def pure(wv):
            return tuple(eval_graph(out._heads, {**feed, **wv}, True,
                                    resolved={}))
        outs, vjp = jax.vjp(pure, w)
        (g,) = vjp(tuple(jnp.ones_like(o) for o in outs))
        return {n: w[n] - lr * g[n] for n in w}, outs

    rs = np.random.RandomState(0)
    anchors = T.anchors_hw_a()
    im_info = np.tile([T.SIZE, T.SIZE, 1.0], (N, 1)).astype(np.float32)
    w = {n: jnp.asarray(v) for n, v in w0.items()}
    hist, starts = [], []
    for _ in range(steps):
        starts.append({n: np.array(v) for n, v in w.items()})
        imgs, gtb, gtc = T.make_batch(rs, N)
        lab, tgt, wgt = T.rpn_targets(anchors, gtb)
        feed = dict(data=imgs, im_info=im_info, rpn_label=lab,
                    bbox_target=tgt, bbox_weight=wgt, gt_boxes=gtb,
                    gt_cls=gtc)
        with jag.train_mode(), jag.pause(train_mode=True):
            w, outs = step(w, {k: jnp.asarray(v) for k, v in feed.items()})
        rpn_prob, _, roi_prob, _, roi_label = [np.asarray(o) for o in outs]
        labeled = lab >= 0
        hist.append((
            float((((rpn_prob[:, 1, :] > 0.5) == (lab > 0.5))
                   & labeled).sum() / max(labeled.sum(), 1)),
            float((roi_prob.argmax(axis=1) == roi_label).mean()),
            float((roi_label > 0).mean())))
    return hist, starts, {n: np.asarray(v) for n, v in w.items()}


def test_rcnn_toy_tracks_jax():
    out, w0 = _jax_bound(0)
    jhist, starts, jw = _jax_train(out, w0, C["steps"])
    thist, tw, _ = chip_smoke.rcnn_toy_train(torch, mx, mx.cpu(),
                                             C["steps"], start=starts)
    for i, (t, j) in enumerate(zip(thist, jhist)):
        assert t == j, f"step {i}: port {t}, JAX {j}"
    for n in jw:
        np.testing.assert_allclose(tw[n], jw[n], rtol=1e-3, atol=1e-4,
                                   err_msg=n)
    rpn_acc, roi_acc, pos_frac = thist[-1]
    assert rpn_acc > C["rpn_acc"] and roi_acc > C["roi_acc"] \
        and pos_frac > C["pos_frac"], thist[-1]


if __name__ == "__main__":
    # The JAX package's run over initial-weight seeds 0-5: each one's last
    # step and its mean over the last 10 (rpn_acc, roi_acc, pos_frac).
    # From the repo's root: PYTHONPATH=. python tests/test_torch_rcnn_toy.py
    import jax
    jax.config.update("jax_platforms", "cpu")
    for seed in range(6):
        hist = _jax_train(*_jax_bound(seed), C["steps"])[0]
        tail = np.mean(hist[-C["tail"]:], axis=0)
        print(f"seed {seed}: last step {np.round(hist[-1], 4).tolist()}, "
              f"last {C['tail']} steps {np.round(tail, 4).tolist()}")
