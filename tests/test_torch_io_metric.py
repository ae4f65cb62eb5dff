"""The port's host-side training utilities against the reference's, on
the CPU: ``metric.py`` (every metric on the same numpy inputs, exactly
equal: both run the same host numpy code), ``io.NDArrayIter`` (batches,
``pad`` and each ``last_batch_handle`` mode exactly equal, shuffling
from the same ``np.random`` seed) and ``ResizeIter``, the initializers
(``One`` and ``Constant`` exact; ``Xavier`` and ``MSRAPrelu`` draw from
``np.random`` in the same order as the reference, so they are held
exactly too, and by the bound or standard deviation each
``rnd_type``/``factor_type``/``magnitude`` sets), ``model.py``'s
checkpoint files and ``callback.py``."""
import logging
import math

import numpy as np
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P


def _inputs(kind, seed=0):
    """(labels, preds) as numpy for a metric family."""
    rng = np.random.RandomState(seed)
    if kind == "class":
        return ([rng.randint(0, 5, 16).astype(np.float32)],
                [rng.rand(16, 5).astype(np.float32)])
    if kind == "binary":
        return ([rng.randint(0, 2, 20).astype(np.float32)],
                [rng.rand(20, 2).astype(np.float32)])
    if kind == "regress":
        return ([rng.randn(12).astype(np.float32)],
                [rng.randn(12, 1).astype(np.float32)])
    if kind == "prob":
        p = rng.rand(10, 6).astype(np.float32)
        return ([rng.randint(0, 6, 10).astype(np.float32)],
                [p / p.sum(1, keepdims=True)])
    if kind == "seq":
        return ([rng.randint(0, 9, (3, 7)).astype(np.float32)],
                [rng.rand(3, 7, 9).astype(np.float32)])
    raise ValueError(kind)


METRICS = [
    ("acc", {}, "class"), ("top_k_acc", {"top_k": 3}, "class"),
    ("f1", {}, "binary"), ("f1", {"average": "micro"}, "binary"),
    ("mcc", {}, "binary"), ("mae", {}, "regress"), ("mse", {}, "regress"),
    ("rmse", {}, "regress"), ("ce", {}, "prob"), ("nll_loss", {}, "prob"),
    ("perplexity", {"ignore_label": 2}, "prob"),
    ("perplexity", {}, "prob"), ("bleu", {}, "seq"),
    ("bleu", {"smooth": True, "max_n": 3}, "seq"),
    ("pearsonr", {}, "regress"), ("loss", {}, "regress"),
    ("acc", {"axis": 2}, "seq"),
]


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=["%s-%d" % (m[0], i)
                              for i, m in enumerate(METRICS)])
def test_metric_equals_the_reference(name, kw, kind):
    r, p = R.metric.create(name, **kw), P.metric.create(name, **kw)
    assert type(p).__name__ == type(r).__name__
    for seed in range(3):
        labels, preds = _inputs(kind, seed)
        r.update([R.nd.array(a) for a in labels],
                 [R.nd.array(a) for a in preds])
        p.update([P.nd.array(a, ctx=P.cpu()) for a in labels],
                 [P.nd.array(a, ctx=P.cpu()) for a in preds])
        assert p.get() == r.get()
    assert p.get_name_value() == r.get_name_value()
    p.reset()
    r.reset()
    assert p.get()[0] == r.get()[0] and math.isnan(p.get()[1])


def test_composite_custom_and_np_metrics():
    labels, preds = _inputs("class")

    def feval(label, pred):
        return float((pred.argmax(1) == label).sum()), label.size

    got, want = [], []
    for mx, out in ((R, want), (P, got)):
        ctx = {} if mx is R else {"ctx": P.cpu()}
        comp = mx.metric.create(["acc", "ce"])
        comp.add(mx.metric.np(feval, name="mine"))
        comp.add(mx.metric.CustomMetric(lambda l, p: float(p.sum())))
        lab = [mx.nd.array(labels[0], **ctx)]
        pre = [mx.nd.array(preds[0] / preds[0].sum(1, keepdims=True),
                           **ctx)]
        comp.update(lab, pre)
        out.append(comp.get())
        out.append(str(comp.get_metric(0)))
    assert got == want


def test_ndarray_iter_modes():
    data = np.arange(70, dtype=np.float32).reshape(10, 7)
    label = np.arange(10, dtype=np.float32)
    with P.cpu():
        for mode in ("pad", "discard", "roll_over"):
            for shuffle in (False, True):
                its = []
                for mx in (R, P):
                    np.random.seed(4)
                    its.append(mx.io.NDArrayIter(
                        data, label, batch_size=4, shuffle=shuffle,
                        last_batch_handle=mode))
                rit, pit = its
                assert pit.provide_data == rit.provide_data
                assert [(d.name, d.shape) for d in pit.provide_label] == \
                    [(d.name, d.shape) for d in rit.provide_label]
                for epoch in range(2):
                    rb, pb = list(rit), list(pit)
                    assert len(pb) == len(rb), (mode, epoch)
                    for a, b in zip(pb, rb):
                        assert a.pad == b.pad
                        for x, y in zip(a.data + a.label, b.data + b.label):
                            np.testing.assert_array_equal(x.asnumpy(),
                                                          y.asnumpy())
                    np.random.seed(5 + epoch)
                    rit.reset()
                    np.random.seed(5 + epoch)
                    pit.reset()
        # a dict of named inputs, and ResizeIter over a short iterator
        it = P.io.NDArrayIter({"a": data, "b": data * 2}, label,
                              batch_size=5)
        assert [d.name for d in it.provide_data] == ["a", "b"]
        rs = P.io.ResizeIter(P.io.NDArrayIter(data, label, batch_size=4),
                             5)
        rr = R.io.ResizeIter(R.io.NDArrayIter(data, label, batch_size=4),
                             5)
        got, want = list(rs), list(rr)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            assert a.pad == b.pad
    d = P.io.DataDesc("data", (4, 3))
    assert d.layout == "NCHW" and P.io.DataDesc.get_batch_axis("TNC") == 1
    b = P.io.DataBatch([P.nd.zeros((2,), ctx=P.cpu())])
    assert "data shapes: [(2,)]" in str(b)


INITS = [("One", {}), ("Constant", {"value": 0.3}),
         ("Xavier", {}), ("Xavier", {"rnd_type": "gaussian",
                                     "factor_type": "in", "magnitude": 2}),
         ("Xavier", {"factor_type": "out", "magnitude": 6}),
         ("MSRAPrelu", {}), ("MSRAPrelu", {"factor_type": "in",
                                           "slope": 0.1})]


@pytest.mark.parametrize("name,kw", INITS,
                         ids=["%s-%d" % (n, i) for i, (n, _) in
                              enumerate(INITS)])
def test_initializer(name, kw):
    shape = (64, 32, 3, 3)
    out = []
    for mx in (R, P):
        arr = mx.nd.zeros(shape) if mx is R else \
            mx.nd.zeros(shape, ctx=P.cpu())
        np.random.seed(11)
        getattr(mx.initializer, name)(**kw)("conv_weight", arr)
        out.append(arr.asnumpy())
        bias = mx.nd.ones((4,)) if mx is R else \
            mx.nd.ones((4,), ctx=P.cpu())
        getattr(mx.initializer, name)(**kw)("conv_bias", bias)
        np.testing.assert_array_equal(bias.asnumpy(), np.zeros(4))
    np.testing.assert_array_equal(out[1], out[0])
    w = out[1]
    if name in ("One", "Constant"):
        np.testing.assert_array_equal(w, np.full(shape, kw.get("value", 1),
                                                 np.float32))
        return
    fan_in, fan_out = 32 * 9, 64 * 9
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[kw.get("factor_type", "avg")]
    if name == "MSRAPrelu":
        magnitude, rnd = 2.0 / (1 + kw.get("slope", 0.25) ** 2), "gaussian"
    else:
        magnitude = kw.get("magnitude", 3)
        rnd = kw.get("rnd_type", "uniform")
    scale = math.sqrt(magnitude / factor)
    if rnd == "uniform":
        assert np.abs(w).max() <= scale
        assert np.abs(w).max() > 0.98 * scale
    else:
        assert abs(w.std() - scale) < 0.03 * scale
    assert P.initializer.create(name.lower(), **kw).__class__.__name__ == \
        name


def test_checkpoint_files_cross_packages(tmp_path):
    """``model.save_checkpoint`` of either package loads in the other
    (symbol and arg/aux params, exact)."""
    rng = np.random.RandomState(0)
    arg = {"fc_weight": rng.randn(3, 4).astype(np.float32),
           "fc_bias": rng.randn(3).astype(np.float32)}
    aux = {"bn_moving_mean": rng.randn(3).astype(np.float32)}
    for writer, reader in ((R, P), (P, R)):
        with writer.name.NameManager():
            sym = writer.sym.FullyConnected(writer.sym.Variable("data"),
                                            num_hidden=3, name="fc")
        prefix = str(tmp_path / writer.__name__)
        ctx = {} if writer is R else {"ctx": P.cpu()}
        writer.model.save_checkpoint(
            prefix, 3, sym, {k: writer.nd.array(v, **ctx)
                             for k, v in arg.items()},
            {k: writer.nd.array(v, **ctx) for k, v in aux.items()})
        s2, a2, x2 = reader.model.load_checkpoint(prefix, 3)
        assert s2.list_arguments() == sym.list_arguments()
        for got, want in ((a2, arg), (x2, aux)):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k].asnumpy(), want[k])


def test_callbacks(caplog):
    caplog.set_level(logging.INFO)
    metric = P.metric.Accuracy()
    metric.update([P.nd.array([1.0, 0.0], ctx=P.cpu())],
                  [P.nd.array([[0.1, 0.9], [0.8, 0.2]], ctx=P.cpu())])
    speed = P.callback.Speedometer(8, frequent=2, auto_reset=False)
    log_metric = P.callback.log_train_metric(2)
    for n in range(5):
        param = P.callback.BatchEndParam(epoch=0, nbatch=n,
                                         eval_metric=metric)
        speed(param)
        log_metric(param)
    assert speed.last_speed is not None and speed.last_speed > 0
    text = caplog.text
    assert "Speed:" in text and "accuracy=1.000000" in text
    assert "Iter[0] Batch[4] Train-accuracy=1.000000" in text
