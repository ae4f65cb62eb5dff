"""The port's ``gluon.contrib`` (``mxnet_tpu_torch/gluon/contrib``): the
Estimator with its event handlers and the contrib layers, against the
reference's, on the CPU.

The fits carry the reference's MLP weights into the port by
structural name (``convert.set_block_params``) and feed both the same
batches: the per-batch losses and the final weights agree within rtol
1e-5, atol 1e-6 after a few epochs (the same f32 ops; the two packages
may sum in another order, and Adam's steps carry a difference on), and
the metrics, the stopping epochs and the checkpoint files are the same.
The contrib layers run on the same inputs and weights: outputs within
rtol 1e-6, atol 1e-6 (one matmul or BatchNorm; ``Identity``,
``PixelShuffle2D`` and the concatenations are exact).

The ``cuda`` case runs a fit with validation on the card against the
same fit on the CPU: losses, metrics and weights within rtol 1e-4,
atol 1e-5 (six SGD steps whose matmuls the card sums in another
order).
"""
import os

import numpy as np
import pytest

import mxnet_tpu_torch as P
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

TOL = dict(rtol=1e-5, atol=1e-6)


def _dataset(n=256, dim=8, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(dim, classes)
    X = rng.randn(n, dim).astype(np.float32)
    y = np.argmax(X @ W, axis=1).astype(np.float32)
    return X, y


class _ListLoader:
    """Re-iterable batches of one package's NDArrays."""

    def __init__(self, pkg, X, y, batch=64):
        ctx = pkg.cpu()
        self.batches = [(pkg.nd.array(X[i:i + batch], ctx=ctx),
                         pkg.nd.array(y[i:i + batch], ctx=ctx))
                        for i in range(0, len(X), batch)]

    def __iter__(self):
        return iter(self.batches)


_WEIGHTS = {}


def _mlp(pkg, classes):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8),
                nn.Dense(classes, in_units=16))
    return net


def _net(pkg, classes=3, ctx=None):
    """The test MLP with the same weights in both packages: the
    reference draws them once (Xavier, seeded), every net takes them
    (on ``ctx``, default the CPU)."""
    if classes not in _WEIGHTS:
        np.random.seed(0)
        ref = _mlp(R, classes)
        ref.initialize(R.initializer.Xavier(), ctx=R.cpu())
        _WEIGHTS[classes] = {k: v.data().asnumpy() for k, v in
                             ref._collect_params_with_prefix().items()}
    ctx = ctx or pkg.cpu()
    net = _mlp(pkg, classes)
    net.initialize(ctx=ctx)
    for k, v in net._collect_params_with_prefix().items():
        v.set_data(pkg.nd.array(_WEIGHTS[classes][k], ctx=ctx))
    return net


def _recorder(pkg):
    class Losses(pkg.gluon.contrib.estimator.BatchEnd):
        def __init__(self):
            self.seen = []

        def batch_end(self, estimator, *a, **kw):
            self.seen.append(float(kw["loss"].mean().asscalar()))
    return Losses()


def _estimator(pkg, net, ctx=None, **kw):
    return pkg.gluon.contrib.estimator.Estimator(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
        context=ctx or pkg.cpu(), **kw)


def _weights(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def _fit_adam(pkg):
    X, y = _dataset()
    net = _net(pkg)
    est = _estimator(pkg, net, train_metrics=pkg.metric.Accuracy(),
                     trainer=pkg.gluon.Trainer(net.collect_params(), "adam",
                                               {"learning_rate": 0.01}))
    rec = _recorder(pkg)
    est.fit(_ListLoader(pkg, X, y), epochs=3, event_handlers=[rec])
    return (rec.seen, est.train_metrics[0].get(),
            est.train_loss_metric.get()[1], _weights(net))


def test_fit_matches_the_reference():
    """Three epochs of Adam: the losses of all 12 batches, the train
    accuracy, the loss metric and the weights."""
    (l0, acc0, lm0, w0), (l1, acc1, lm1, w1) = _fit_adam(R), _fit_adam(P)
    np.testing.assert_allclose(l1, l0, **TOL)
    assert acc1 == acc0 and acc1[1] > 0.6
    np.testing.assert_allclose(lm1, lm0, **TOL)
    for a, b in zip(w1, w0):
        np.testing.assert_allclose(a, b, **TOL)


def _early(pkg):
    X, y = _dataset()
    est = _estimator(pkg, _net(pkg), train_metrics=pkg.metric.Accuracy())
    h = pkg.gluon.contrib.estimator
    early = h.EarlyStoppingHandler(monitor=est.val_metrics[0], patience=2)
    rec = _recorder(pkg)
    est.fit(_ListLoader(pkg, X, y), val_data=_ListLoader(pkg, X, y),
            epochs=8, event_handlers=[early, rec])
    return early.current_epoch, early.stopped_epoch, rec.seen, \
        est.val_metrics[0].get(), est.val_loss_metric.get()


def test_validation_and_early_stopping_match_the_reference():
    a, b = _early(P), _early(R)
    assert a[:2] == b[:2] and a[3][0] == b[3][0]
    np.testing.assert_allclose(a[2], b[2], **TOL)
    np.testing.assert_allclose(a[3][1], b[3][1], **TOL)
    np.testing.assert_allclose(a[4][1], b[4][1], **TOL)


def _fit_batches_with_validation(pkg, ctx=None):
    """``fit(train, val, batches=6)`` over epochs of 4 batches with a
    ValidationHandler on a batch period of 3: it validates after batches
    3 and 6 and at the one epoch end (a fit that stops inside its first
    epoch validates on the batch period only).  SGD with momentum; the
    batches on the host, moved by the Estimator."""
    X, y = _dataset()
    net = _net(pkg, ctx=ctx)
    est = _estimator(pkg, net, ctx=ctx, train_metrics=pkg.metric.Accuracy(),
                     trainer=pkg.gluon.Trainer(
                         net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9}))
    h = pkg.gluon.contrib.estimator
    val = _ListLoader(pkg, X[:128], y[:128])
    rec, seen = _recorder(pkg), []

    def evaluate(val_data):
        est.evaluate(val_data)
        seen.append((est.val_metrics[0].get()[1],
                     est.val_loss_metric.get()[1]))
    est.fit(_ListLoader(pkg, X, y), val, batches=6, event_handlers=[
        rec, h.ValidationHandler(val, evaluate, batch_period=3)])
    return rec.seen, seen, est.train_metrics[0].get()[1], _weights(net)


def _same_fit(a, b, tol):
    np.testing.assert_allclose(a[0], b[0], **tol)
    assert len(a[1]) == len(b[1]) == 3
    np.testing.assert_allclose(a[1], b[1], **tol)
    np.testing.assert_allclose(a[2], b[2], **tol)
    for x, w in zip(a[3], b[3]):
        np.testing.assert_allclose(x, w, **tol)


def test_fit_batches_with_validation_matches_the_reference():
    _same_fit(_fit_batches_with_validation(P),
              _fit_batches_with_validation(R), TOL)


@pytest.mark.cuda
def test_card_fit_batches_with_validation_matches_cpu(cuda_device):
    got = _fit_batches_with_validation(P, P.gpu(0))
    _same_fit(got, _fit_batches_with_validation(P),
              dict(rtol=1e-4, atol=1e-5))


def _stops(pkg):
    X, y = _dataset()
    h = pkg.gluon.contrib.estimator
    stop = h.StoppingHandler(max_batch=3)
    est = _estimator(pkg, _net(pkg))
    est.fit(_ListLoader(pkg, X, y), batches=3, event_handlers=[stop])

    class CountEpochs(h.EpochEnd):
        n = 0

        def epoch_end(self, estimator, *a, **kw):
            CountEpochs.n += 1
    est.fit(_ListLoader(pkg, X, y), epochs=3, event_handlers=[CountEpochs()])
    small = _ListLoader(pkg, *_dataset(n=64))
    est.fit(small, epochs=0)
    est.fit(small, batches=0)
    est.fit(iter(list(small)), epochs=5)     # one-shot: stops, no spin
    return stop.current_batch, CountEpochs.n, _weights(est.net)


def test_stopping_and_custom_handlers_match_the_reference():
    a, b = _stops(P), _stops(R)
    assert a[:2] == b[:2] == (3, 3)
    for x, y in zip(a[2], b[2]):
        np.testing.assert_allclose(x, y, **TOL)


def _checkpoint(pkg, path):
    X, y = _dataset()
    net = _net(pkg)
    est = _estimator(pkg, net, train_metrics=pkg.metric.Accuracy())
    h = pkg.gluon.contrib.estimator
    ckpt = h.CheckpointHandler(path, model_prefix="m",
                               monitor=est.train_metrics[0], save_best=True,
                               batch_period=3, max_checkpoints=2)
    est.fit(_ListLoader(pkg, X, y), epochs=2, event_handlers=[ckpt])
    net2 = _net(pkg)
    net2.load_parameters(os.path.join(path, "m-best.params"),
                         ctx=pkg.cpu())
    xa = pkg.nd.array(X[:4], ctx=pkg.cpu())
    resumed = _estimator(pkg, _net(pkg))
    again = h.CheckpointHandler(path, model_prefix="m",
                                resume_from_checkpoint=True, verbose=1)
    resumed.fit(_ListLoader(pkg, X, y), epochs=1, event_handlers=[again])
    return (sorted(os.listdir(path)), net(xa).asnumpy(),
            net2(xa).asnumpy(), again.current_epoch,
            _weights(resumed.net))


def test_checkpoints_match_the_reference(tmp_path):
    """Epoch and batch checkpoints (the oldest dropped past
    ``max_checkpoints``), the best model reloaded to the same outputs,
    and a resume from the newest epoch checkpoint and its states."""
    a = _checkpoint(P, str(tmp_path / "p"))
    b = _checkpoint(R, str(tmp_path / "r"))
    assert a[0] == b[0] and "m-best.params" in a[0]
    np.testing.assert_allclose(a[1], b[1], **TOL)
    np.testing.assert_allclose(a[2], b[2], **TOL)
    assert a[3] == b[3] == 3       # resumed at epoch 2, one more
    for x, y in zip(a[4], b[4]):
        np.testing.assert_allclose(x, y, **TOL)


def test_estimator_defaults_match_the_reference():
    names = []
    for pkg in (P, R):
        est = _estimator(pkg, _net(pkg),
                         train_metrics=pkg.metric.TopKAccuracy(top_k=2))
        assert est.val_metrics[0].top_k == 2
        assert isinstance(est.trainer, pkg.gluon.Trainer)
        with pytest.raises(pkg.base.MXNetError):
            pkg.gluon.contrib.estimator.Estimator(_net(pkg), None)
        est.max_epoch, est.max_batch = 1, None
        names.append([type(h).__name__
                      for h in est._prepare_handlers([], None)])
    assert names[0] == names[1]


# --- contrib layers ----------------------------------------------------------
def _layers(pkg, x):
    cn, nn = pkg.gluon.contrib.nn, pkg.gluon.nn
    ctx = pkg.cpu()
    xs = pkg.nd.array(x, ctx=ctx)
    hc = cn.HybridConcurrent(axis=1, prefix="hc_")
    with hc.name_scope():
        hc.add(nn.Dense(4, in_units=5), nn.Dense(4, in_units=5),
               cn.Identity())
    c = cn.Concurrent(axis=1, prefix="c_")
    with c.name_scope():
        c.add(nn.Dense(3, in_units=5), cn.Identity())
    last = cn.HybridConcurrent(prefix="last_")
    last.add(cn.Identity(), cn.Identity())
    blocks = {"hc": hc, "c": c, "last": last}
    rng = np.random.RandomState(1)
    for b in blocks.values():
        b.initialize(ctx=ctx)
        for p in b.collect_params().values():
            p.set_data(pkg.nd.array(rng.randn(*p.shape).astype(np.float32),
                                    ctx=ctx))
    out = {k: b(xs).asnumpy() for k, b in blocks.items()}
    hc.hybridize()
    out["hc_hybrid"] = hc(xs).asnumpy()
    img = pkg.nd.array(np.arange(2 * 8 * 3 * 3, dtype=np.float32)
                       .reshape(2, 8, 3, 3), ctx=ctx)
    out["shuffle"] = cn.PixelShuffle2D(2)(img).asnumpy()
    out["shuffle_pair"] = cn.PixelShuffle2D((4, 2))(img).asnumpy()
    bn_x = pkg.nd.array(rng.randn(2, 4, 3, 3).astype(np.float32), ctx=ctx)
    sbn, bn = cn.SyncBatchNorm(in_channels=4), nn.BatchNorm(in_channels=4)
    for name, b in (("sync_bn", sbn), ("bn", bn)):
        b.initialize(ctx=ctx)
        with pkg.autograd.record():
            out[name + "_train"] = b(bn_x).asnumpy()
        out[name] = b(bn_x).asnumpy()
    out["repr"] = repr(cn.SparseEmbedding(10, 4))
    return out


def test_contrib_layers_match_the_reference():
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    a, b = _layers(P, x), _layers(R, x)
    assert a["repr"] == b["repr"] == "SparseEmbedding(10 -> 4)"
    for k in b:
        if k != "repr":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert a["hc"].shape == (2, 13) and a["last"].shape == (2, 10)
    np.testing.assert_array_equal(a["hc"][:, 8:], x)
    np.testing.assert_array_equal(a["hc"], a["hc_hybrid"])
    np.testing.assert_array_equal(a["sync_bn"], a["bn"])
    np.testing.assert_array_equal(a["sync_bn_train"], a["bn_train"])


def test_hybrid_concurrent_axis_defaults():
    """contrib's ``HybridConcurrent`` concatenates on the last axis, the
    zoo's (SqueezeNet) on the channel axis, in both packages."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import squeezenet as PS
    from mxnet_tpu.gluon.model_zoo.vision import squeezenet as RS
    for pkg, zoo in ((P, PS), (R, RS)):
        assert pkg.gluon.contrib.nn.HybridConcurrent().axis == -1
        assert zoo.HybridConcurrent().axis == 1
    with pytest.raises(P.base.MXNetError):
        P.gluon.contrib.nn.PixelShuffle2D((2, 2, 2))
