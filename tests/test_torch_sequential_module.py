"""``mx.mod.SequentialModule`` (``mxnet_tpu_torch/module/
sequential_module.py``) against the reference's, on the CPU: the twin of
``tests/test_symbol_module.py::test_sequential_module_trains``.

Two Modules chained (an FC-ReLU body without labels, an FC-SoftmaxOutput
head taking the labels) train 10 epochs of 4 batches of 16 with Adam
(lr 0.05) in both packages from the reference's Xavier weights (drawn
after ``np.random.seed(0)`` as the reference test draws them, carried
into the port by ``init_params(arg_params=...)``).  The first batch's
outputs agree within 2e-6 and every batch's mean cross-entropy within
1e-5 (the reference's executor is jitted, f32 summation order; measured
1.2e-7 for both), and both reach the reference test's accuracy
threshold (0.8) with the same final accuracy; the outputs come from the
tail module, and the gradients cross the boundary (the body's weights
move).
"""
import numpy as np

from _torch_port import reference as R

import mxnet_tpu_torch as P


def _seq(pkg):
    sym = pkg.sym
    feat = sym.Variable("data")
    body = sym.Activation(sym.FullyConnected(feat, num_hidden=16,
                                             name="fc_body"),
                          act_type="relu", name="act_body")
    head = sym.SoftmaxOutput(sym.FullyConnected(sym.Variable("data"),
                                                num_hidden=3,
                                                name="fc_head"),
                             name="softmax")
    kw = {"context": P.cpu()} if pkg is P else {}
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(body, label_names=[], **kw))
    seq.add(pkg.mod.Module(head, label_names=["softmax_label"], **kw),
            take_labels=True)
    seq.bind(data_shapes=[("data", (16, 10))],
             label_shapes=[("softmax_label", (16,))])
    return seq


def _train(pkg, seq, X, Y):
    from_io = pkg.io.DataBatch if pkg is P else \
        __import__("mxnet_tpu.io.io", fromlist=["DataBatch"]).DataBatch
    kw = {"ctx": P.cpu()} if pkg is P else {}
    seq.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.05})
    metric = pkg.metric.create("acc")
    losses, first = [], None
    for epoch in range(10):
        metric.reset()
        for i in range(0, 64, 16):
            batch = from_io(data=[pkg.nd.array(X[i:i + 16], **kw)],
                            label=[pkg.nd.array(Y[i:i + 16], **kw)])
            seq.forward(batch, is_train=True)
            out = seq.get_outputs()[0].asnumpy()
            if first is None:
                first = out
            losses.append(-np.log(out[np.arange(16),
                                      Y[i:i + 16].astype(int)]).mean())
            seq.backward()
            seq.update()
            seq.update_metric(metric, batch.label)
    return first, losses, metric.get()[1], seq


def test_sequential_module_trains_as_the_reference():
    np.random.seed(0)
    rseq = _seq(R)
    X = np.random.randn(64, 10).astype("float32")
    Y = X[:, :3].argmax(1).astype("float32")
    rseq.init_params(R.initializer.Xavier())
    args, aux = rseq.get_params()
    args = {k: v.asnumpy() for k, v in args.items()}
    pseq = _seq(P)
    pseq.init_params(arg_params={k: P.nd.array(v, ctx=P.cpu())
                                 for k, v in args.items()},
                     aux_params={})
    body0 = args["fc_body_weight"].copy()
    rf, rl, racc, _ = _train(R, rseq, X, Y)
    pf, pl, pacc, pseq = _train(P, pseq, X, Y)
    np.testing.assert_allclose(pf, rf, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pl, rl, rtol=0, atol=1e-5)
    assert racc > 0.8 and pacc > 0.8, (racc, pacc)
    assert pacc == racc
    assert pseq.get_outputs()[0].shape == (16, 3)
    assert not np.allclose(pseq.get_params()[0]["fc_body_weight"]
                           .asnumpy(), body0)
