"""Port parity: the NDArray core of ``mxnet_tpu_torch`` (``nd``, the op
registry, ``autograd``) against ``mxnet_tpu`` on the same numpy inputs.

Each ported op runs in both packages under ``autograd.record()`` and is
differentiated with the same head gradient; values and the gradients of
every input are compared.  Tolerances: f32 values within 1e-5 (abs and
rel), gradients within 1e-4, since XLA:CPU and torch sum in other orders;
running statistics within 1e-6.  Also covered: BatchNorm in training and
inference with its running statistics, the ``out=`` and ``mutate``
contracts, the ``training_aware`` flag, the default context, and the
``.params`` container read and written by both packages."""
import numpy as np
import pytest
import torch

TOL_V, TOL_G = 1e-5, 1e-4


def _pkgs():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    return (jmx, jmx.cpu()), (mx, mx.cpu())


def _run(opname, inputs, attrs, grad_of=None, seed=0):
    """Run ``nd.<opname>(*inputs, **attrs)`` in both packages, recorded,
    with the inputs named in ``grad_of`` (indices) as variables and a
    random head gradient; returns [(out, [grads]), (out, [grads])]."""
    grad_of = range(len(inputs)) if grad_of is None else grad_of
    res = []
    for pkg, ctx in _pkgs():
        arrs = [pkg.nd.array(x, ctx=ctx) for x in inputs]
        for i in grad_of:
            arrs[i].attach_grad()
        with pkg.autograd.record():
            out = getattr(pkg.nd, opname)(*arrs, **attrs)
        head = np.random.RandomState(seed + 1).randn(*out.shape) \
            .astype(np.float32)
        out.backward(pkg.nd.array(head, ctx=ctx))
        res.append((out.asnumpy(), [arrs[i].grad.asnumpy()
                                    for i in grad_of]))
    return res


def _check(res):
    (jo, jg), (to, tg) = res
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, rtol=TOL_V, atol=TOL_V)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=TOL_G, atol=TOL_G)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


OPS = [
    ("FullyConnected", [(4, 3, 2, 2), (5, 12), (5,)], dict(num_hidden=5)),
    ("FullyConnected", [(4, 6), (5, 6)], dict(num_hidden=5, no_bias=True)),
    ("Convolution", [(2, 3, 9, 9), (4, 3, 7, 7)],
     dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=4,
          no_bias=True)),
    ("Convolution", [(2, 4, 8, 8), (6, 4, 1, 1), (6,)],
     dict(kernel=(1, 1), stride=(2, 2), num_filter=6)),
    ("Convolution", [(2, 4, 6, 6), (4, 2, 3, 3)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=4, num_group=2,
          no_bias=True)),
    ("Pooling", [(2, 3, 9, 9)], dict(kernel=(3, 3), stride=(2, 2),
                                     pad=(1, 1), pool_type="max")),
    ("Pooling", [(2, 3, 8, 8)], dict(kernel=(2, 2), stride=(2, 2),
                                     pool_type="avg")),
    ("Pooling", [(2, 3, 7, 7)], dict(kernel=(3, 3), stride=(2, 2),
                                     pool_type="max",
                                     pooling_convention="full")),
    ("Pooling", [(2, 3, 7, 7)], dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                     pool_type="avg",
                                     count_include_pad=False)),
    ("Pooling", [(2, 3, 5, 5)], dict(kernel=(1, 1), global_pool=True,
                                     pool_type="avg")),
    ("Pooling", [(2, 3, 5, 5)], dict(kernel=(1, 1), global_pool=True,
                                     pool_type="max")),
    ("Activation", [(3, 7)], dict(act_type="relu")),
    ("Activation", [(3, 7)], dict(act_type="sigmoid")),
    ("Activation", [(3, 7)], dict(act_type="tanh")),
    ("Activation", [(3, 7)], dict(act_type="softrelu")),
    ("softmax", [(3, 7)], dict(axis=-1)),
    ("log_softmax", [(3, 7)], dict(axis=1)),
    ("mean", [(3, 4, 5)], dict(axis=0, exclude=True)),
    ("sum", [(3, 4, 5)], dict(axis=1, keepdims=True)),
    ("Flatten", [(3, 4, 5)], dict()),
    ("broadcast_add", [(3, 4), (1, 4)], dict()),
    ("broadcast_mul", [(3, 4), (3, 1)], dict()),
    ("broadcast_sub", [(3, 4), (3, 4)], dict()),
    ("negative", [(3, 4)], dict()),
]


@pytest.mark.parametrize("opname,shapes,attrs", OPS,
                         ids=["%s-%d" % (o[0], i) for i, o in enumerate(OPS)])
def test_op_matches_reference(opname, shapes, attrs):
    inputs = [_randn(*s, seed=i) for i, s in enumerate(shapes)]
    _check(_run(opname, inputs, attrs))


def test_pick_matches_reference():
    data = _randn(5, 6)
    index = np.array([0, 5, 2, 7, -1], np.float32)   # out of range: clipped
    _check(_run("pick", [data, index], dict(axis=-1, keepdims=True),
                grad_of=[0]))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "rsub", "rdiv",
                                "neg", "scalar_add", "scalar_div"])
def test_operators_match_reference(op):
    a, b = _randn(3, 4, seed=1), 1.5 + np.abs(_randn(3, 4, seed=2))
    fns = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
           "mul": lambda x, y: x * y, "div": lambda x, y: x / y,
           "rsub": lambda x, y: 2.0 - y, "rdiv": lambda x, y: 3.0 / y,
           "neg": lambda x, y: -x, "scalar_add": lambda x, y: x + 0.5,
           "scalar_div": lambda x, y: y / 4.0}
    res = []
    for pkg, ctx in _pkgs():
        x, y = pkg.nd.array(a, ctx=ctx), pkg.nd.array(b, ctx=ctx)
        x.attach_grad()
        y.attach_grad()
        with pkg.autograd.record():
            out = fns[op](x, y) * 1.0 + x * 0.0 + y * 0.0
        out.backward()
        res.append((out.asnumpy(), [x.grad.asnumpy(), y.grad.asnumpy()]))
    _check(res)


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_reference(fix_gamma, training):
    """Outputs, the gradients of data, gamma and beta, and the running
    statistics (MXNet's momentum convention, biased batch variance)
    written back through the mutate contract."""
    x = 2.0 + 3.0 * _randn(4, 3, 5, 5)
    gamma, beta = 1.0 + 0.1 * _randn(3, seed=1), _randn(3, seed=2)
    rmean, rvar = _randn(3, seed=3), 1.0 + np.abs(_randn(3, seed=4))
    head = _randn(4, 3, 5, 5, seed=5)
    res = []
    for pkg, ctx in _pkgs():
        arrs = [pkg.nd.array(v, ctx=ctx) for v in (x, gamma, beta, rmean,
                                                    rvar)]
        for a in arrs[:3]:
            a.attach_grad()
        with pkg.autograd.record(train_mode=training):
            out = pkg.nd.BatchNorm(*arrs, eps=1e-5, momentum=0.9,
                                   fix_gamma=fix_gamma)
        out.backward(pkg.nd.array(head, ctx=ctx))
        res.append((out.asnumpy(), [a.grad.asnumpy() for a in arrs[:3]],
                    [a.asnumpy() for a in arrs[3:]]))
    (jo, jg, js), (to, tg, ts) = res
    _check([(jo, jg), (to, tg)])
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    if training:       # the statistics moved by 0.1 * (batch - running)
        want = 0.9 * rmean + 0.1 * x.mean(axis=(0, 2, 3))
        np.testing.assert_allclose(ts[0], want, rtol=1e-5, atol=1e-5)
        want = 0.9 * rvar + 0.1 * x.var(axis=(0, 2, 3))
        np.testing.assert_allclose(ts[1], want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(ts[0], rmean)
        np.testing.assert_array_equal(ts[1], rvar)


def test_batch_norm_default_attrs_and_training_flag():
    """The op's own defaults (eps 1e-3, fix_gamma True) and its
    ``training_aware`` flag: recording in predict mode uses the running
    statistics and leaves them alone."""
    import mxnet_tpu_torch as mx
    x = _randn(4, 2, 3, 3)
    ctx = mx.cpu()
    outs = []
    for pkg, c in _pkgs():
        args = [pkg.nd.array(v, ctx=c) for v in (
            x, 3 * np.ones(2, np.float32), np.zeros(2, np.float32),
            np.zeros(2, np.float32), np.ones(2, np.float32))]
        with pkg.autograd.record(train_mode=False):
            out = pkg.nd.BatchNorm(*args)
        outs.append(out.asnumpy())
        np.testing.assert_array_equal(args[3].asnumpy(), 0.0)
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL_V, atol=TOL_V)
    np.testing.assert_allclose(outs[1], x / np.sqrt(1 + 1e-3), rtol=1e-6)
    with mx.autograd.record():
        assert mx.autograd.is_training() and mx.autograd.is_recording()
        with mx.autograd.pause():
            assert not mx.autograd.is_recording()
        with mx.autograd.predict_mode():
            assert not mx.autograd.is_training()
    assert not mx.autograd.is_recording()
    assert mx.nd.array(x, ctx=ctx).context == mx.cpu()


def test_sgd_ops_out_and_mutate_contract():
    """``sgd_mom_update(w, g, m, out=w)``: the weight is written in place
    through ``out=``, the momentum through ``mutate``, as the reference
    does; ``out=`` is refused while recording.  The reference's eager
    dispatch jit-compiles the op and XLA:CPU contracts it into FMAs, so
    the values agree within 1e-6 (a few ulps), not bit for bit."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    w0, g0, m0 = _randn(6, 4), _randn(6, 4, seed=1), _randn(6, 4, seed=2)
    got = []
    for pkg, ctx in _pkgs():
        w, g, m = (pkg.nd.array(v, ctx=ctx) for v in (w0, g0, m0))
        out = pkg.nd.sgd_mom_update(w, g, m, out=w, lr=0.1, momentum=0.9,
                                    wd=1e-3, rescale_grad=0.5,
                                    clip_gradient=0.3)
        assert out is w
        got.append((w.asnumpy(), m.asnumpy()))
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    w = mx.nd.array(w0, ctx=mx.cpu())
    w.attach_grad()
    with mx.autograd.record():
        with pytest.raises(mx.MXNetError, match="out="):
            mx.nd.negative(w, out=w)
    del jmx


def test_variables_and_grad_req():
    """``attach_grad`` / ``backward``: 'write' replaces the gradient on
    every backward, 'add' accumulates, a head of ones by default; a head
    not computed from a variable cannot be differentiated."""
    import mxnet_tpu_torch as mx
    ctx = mx.cpu()
    for req, want in (("write", 2.0), ("add", 4.0)):
        x = mx.nd.array([1.0, 2.0], ctx=ctx)
        x.attach_grad(grad_req=req)
        for _ in range(2):
            with mx.autograd.record():
                y = x * 2.0
            y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), [want, want])
    with pytest.raises(mx.MXNetError, match="Cannot differentiate"):
        mx.nd.array([1.0], ctx=ctx).backward()
    # a name ``nd`` does not hold raises (the ``_np_*`` ops live in the
    # registry only, as in the reference); the INT8 ops are ported
    with pytest.raises(NotImplementedError, match="not ported"):
        mx.nd._np_sum
    assert callable(mx.nd._contrib_quantize)
    assert not hasattr(mx.nd, "no_such_op")


def test_default_context_is_the_card():
    import mxnet_tpu_torch as mx
    if torch.cuda.is_available():
        assert mx.current_context() == mx.gpu(0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mx.nd.zeros((2,))
    with mx.cpu():
        assert mx.nd.zeros((2,)).context == mx.cpu()
    with pytest.raises(NotImplementedError, match="tpu"):
        mx.context.tpu()


def test_params_file_round_trip_between_packages(tmp_path):
    """The MXTP0001 container: written by either package, read by the
    other, names, dtypes and values intact."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    vals = {"a.weight": _randn(3, 4), "b": np.arange(5, dtype=np.int32),
            "c": np.float32(2.5) * np.ones((), np.float32)}
    for src, dst in ((jmx, mx), (mx, jmx)):
        f = str(tmp_path / ("%s.params" % src.__name__))
        src.nd.save(f, {k: src.nd.array(v, ctx=src.cpu(), dtype=v.dtype)
                        for k, v in vals.items()})
        back = dst.nd.load(f)
        assert sorted(back) == sorted(vals)
        for k, v in vals.items():
            assert back[k].dtype == v.dtype and back[k].shape == v.shape
            np.testing.assert_array_equal(back[k].asnumpy(), v)
    f = str(tmp_path / "list.params")
    mx.nd.save(f, [mx.nd.array(vals["a.weight"], ctx=mx.cpu())])
    np.testing.assert_array_equal(jmx.nd.load(f)[0].asnumpy(),
                                  vals["a.weight"])
    with open(f, "r+b") as fh:
        fh.write(b"NOTMXTP!")
    with pytest.raises(mx.MXNetError, match="bad magic"):
        mx.nd.load(f)
