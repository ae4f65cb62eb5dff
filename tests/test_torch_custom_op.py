"""Port parity: ``mx.operator`` (CustomOp) of ``mxnet_tpu_torch`` against
``mxnet_tpu``, twins of ``tests/test_custom_op.py``, and the NDArray
slicing, slice assignment and ``concat`` that CustomOps use.

Both packages get the same ops (a square and a two-way split with a
custom backward) under the names ``twin_sq`` and ``twin_split2``; each
test feeds both the same numpy inputs.  Outputs and gradients are
compared within 1e-6 (one f32 product or copy each: the square's
``2*x*dy`` and the split's concatenation round the same way on both
sides); the hybridized Dense -> square net within 1e-5 (a matmul in
another summation order)."""
import numpy as np
import pytest

TOL = 1e-6


def _pkgs():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    return (jmx, jmx.cpu()), (mx, mx.cpu())


def _register(pkg):
    """Register the twin ops in ``pkg`` (once)."""
    if "twin_sq" in pkg.operator.get_all_registered_operators():
        return
    op = pkg.operator

    class Square(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @op.register("twin_sq")
    class SquareProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Square()

    class Split2(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            n = in_data[0].shape[0] // 2
            self.assign(out_data[0], req[0], in_data[0][:n])
            self.assign(out_data[1], req[1], in_data[0][n:])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        pkg.nd.concat(out_grad[0], out_grad[1], dim=0))

    @op.register("twin_split2")
    class Split2Prop(op.CustomOpProp):
        def list_outputs(self):
            return ["top", "bottom"]

        def infer_shape(self, in_shape):
            n = in_shape[0][0] // 2
            rest = list(in_shape[0][1:])
            return in_shape, [[n] + rest, [n] + rest], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Split2()


@pytest.fixture
def pkgs():
    out = _pkgs()
    for pkg, _ in out:
        _register(pkg)
    return out


def _x(seed=0, shape=(4, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_custom_forward(pkgs):
    x = _x()
    outs = [pkg.nd.Custom(pkg.nd.array(x, ctx=ctx), op_type="twin_sq")
            .asnumpy() for pkg, ctx in pkgs]
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(outs[1], x * x, rtol=TOL, atol=TOL)


def test_custom_backward_is_custom(pkgs):
    x = _x(1)
    head = _x(2)
    res = []
    for pkg, ctx in pkgs:
        a = pkg.nd.array(x, ctx=ctx)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Custom(a, op_type="twin_sq")
        y.backward(pkg.nd.array(head, ctx=ctx))
        res.append((y.asnumpy(), a.grad.asnumpy()))
    (jy, jg), (ty, tg) = res
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg, 2 * x * head, rtol=TOL, atol=TOL)


def test_custom_multi_output(pkgs):
    x = np.arange(8, dtype="float32").reshape(4, 2)
    res = []
    for pkg, ctx in pkgs:
        a = pkg.nd.array(x, ctx=ctx)
        a.attach_grad()
        with pkg.autograd.record():
            top, bot = pkg.nd.Custom(a, op_type="twin_split2")
            L = (top * 2).sum() + (bot * 3).sum()
        assert top.shape == (2, 2) and bot.shape == (2, 2)
        L.backward()
        res.append((top.asnumpy(), bot.asnumpy(), a.grad.asnumpy()))
    for j, t in zip(*res):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    expect = np.concatenate([np.full((2, 2), 2.0), np.full((2, 2), 3.0)])
    np.testing.assert_allclose(res[1][2], expect)


def test_custom_multi_output_one_head(pkgs):
    """Only one output reaches the loss: the other's gradient is zero on
    both sides."""
    x = _x(3, (6, 2))
    res = []
    for pkg, ctx in pkgs:
        a = pkg.nd.array(x, ctx=ctx)
        a.attach_grad()
        with pkg.autograd.record():
            top, _ = pkg.nd.Custom(a, op_type="twin_split2")
            L = (top * top).sum()
        L.backward()
        res.append(a.grad.asnumpy())
    np.testing.assert_allclose(res[1], res[0], rtol=TOL, atol=TOL)
    assert not res[1][3:].any()


def test_custom_inside_hybridize(pkgs):
    """Dense(4) -> twin_sq in a HybridBlock, eager and hybridized, with
    the reference's weights carried across by structural name."""
    from mxnet_tpu_torch.convert import set_block_params
    x = np.random.RandomState(0).rand(3, 5).astype("float32")
    outs = []
    for (pkg, ctx), arrays in zip(pkgs, (None, "from_ref")):
        class Net(pkg.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                with self.name_scope():
                    self.dense = pkg.gluon.nn.Dense(4)

            def hybrid_forward(self, F, x):
                return F.Custom(self.dense(x), op_type="twin_sq")

        net = Net()
        net.initialize(pkg.initializer.Xavier(), ctx=ctx)
        X = pkg.nd.array(x, ctx=ctx)
        if arrays is None:
            net(X)
            ref_params = {k: v.data().asnumpy() for k, v in
                          net._collect_params_with_prefix().items()}
        else:
            set_block_params(net, ref_params, ctx=ctx)
        eager = net(X).asnumpy()
        net.hybridize()
        outs.append((eager, net(X).asnumpy(), net(X).asnumpy()))
    (j0, j1, j2), (t0, t1, t2) = outs
    for t in (t0, t1, t2):
        np.testing.assert_allclose(t, j0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(j1, j0, rtol=1e-5, atol=1e-6)


def test_custom_registry_listing(pkgs):
    for pkg, _ in pkgs:
        names = pkg.operator.get_all_registered_operators()
        assert "twin_sq" in names and "twin_split2" in names


def test_custom_unknown_type_errors(pkgs):
    for pkg, ctx in pkgs:
        with pytest.raises(pkg.base.MXNetError, match="not registered"):
            pkg.nd.Custom(pkg.nd.zeros((2, 2), ctx=ctx),
                          op_type="definitely_missing")


def test_register_needs_a_prop(pkgs):
    for pkg, _ in pkgs:
        with pytest.raises(pkg.base.MXNetError):
            pkg.operator.register("twin_bad")(object)


def test_create_operator_gets_the_context():
    """The port passes the inputs' Context to ``create_operator`` (an rtc
    launch needs it), and ``is_train`` as it was at the call."""
    import mxnet_tpu_torch as mx
    seen = {}

    class Ident(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen["is_train"] = is_train
            self.assign(out_data[0], req[0], in_data[0])

    @mx.operator.register("twin_ident_ctx")
    class IdentProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            seen["ctx"] = ctx
            return Ident()

    a = mx.nd.array(_x(), ctx=mx.cpu())
    with mx.autograd.record():
        mx.nd.Custom(a, op_type="twin_ident_ctx")
    assert seen == {"ctx": mx.cpu(), "is_train": True}
    with mx.autograd.predict_mode():
        mx.nd.Custom(a, op_type="twin_ident_ctx")
    assert seen["is_train"] is False


# ---------------------------------------------------------------------------
# NDArray slicing, slice assignment and concat against the reference
# ---------------------------------------------------------------------------

KEYS = [
    np.s_[1:3], np.s_[2], np.s_[:, 1], np.s_[..., 1:], np.s_[::2, ::-1][:1],
    np.s_[None, 1], np.s_[-1, 1:3], np.s_[1:, None, 2],
]


@pytest.mark.parametrize("key", KEYS, ids=[str(k) for k in KEYS])
def test_getitem_matches_reference(pkgs, key):
    x = _x(4, (4, 5))
    head = None
    res = []
    for pkg, ctx in pkgs:
        a = pkg.nd.array(x, ctx=ctx)
        a.attach_grad()
        with pkg.autograd.record():
            y = a[key]
        if head is None:
            head = np.random.RandomState(5).randn(*y.shape).astype(np.float32)
        y.backward(pkg.nd.array(head, ctx=ctx))
        res.append((y.asnumpy(), a.grad.asnumpy()))
    (jy, jg), (ty, tg) = res
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(ty, x[key])


def test_getitem_with_index_arrays(pkgs):
    x = _x(6, (5, 3))
    idx = np.array([4, 0, 2], np.int32)
    outs = []
    for pkg, ctx in pkgs:
        a = pkg.nd.array(x, ctx=ctx)
        outs.append(a[pkg.nd.array(idx, ctx=ctx)].asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], x[idx.astype(int)])


def test_getitem_returns_a_copy():
    """Writing into a slice leaves the source as it was (the
    reference's arrays are immutable, so its slices are copies)."""
    import mxnet_tpu_torch as mx
    a = mx.nd.array(_x(7, (4, 3)), ctx=mx.cpu())
    before = a.asnumpy()
    s = a[1:3]
    s[:] = 0
    np.testing.assert_array_equal(a.asnumpy(), before)


SET_KEYS = [np.s_[:], np.s_[1:3], np.s_[0], np.s_[:, 2], np.s_[1:, :2]]


@pytest.mark.parametrize("key", SET_KEYS, ids=[str(k) for k in SET_KEYS])
@pytest.mark.parametrize("scalar", [False, True])
def test_setitem_matches_reference(pkgs, key, scalar):
    x = _x(8, (4, 3))
    res = []
    for pkg, ctx in pkgs:
        a = pkg.nd.array(x, ctx=ctx)
        if scalar:
            value = 2.5
        else:
            shape = np.empty((4, 3))[key].shape
            value = pkg.nd.array(np.arange(np.prod(shape), dtype=np.float32)
                                 .reshape(shape), ctx=ctx)
        a[key] = value
        res.append(a.asnumpy())
    np.testing.assert_array_equal(res[1], res[0])


def test_setitem_refused_on_a_recorded_array():
    import mxnet_tpu_torch as mx
    a = mx.nd.array(_x(), ctx=mx.cpu())
    a.attach_grad()
    with mx.autograd.record():
        with pytest.raises(mx.MXNetError, match="Slice-assign"):
            a[0] = 1.0
    a[0] = 1.0                       # outside recording it is allowed
    assert (a.asnumpy()[0] == 1.0).all()


@pytest.mark.parametrize("dim", [0, 1])
def test_concat_matches_reference(pkgs, dim):
    xs = [_x(9, (2, 3)), _x(10, (2, 3)), _x(11, (2, 3))]
    head = np.random.RandomState(12).randn(
        *np.concatenate(xs, axis=dim).shape).astype(np.float32)
    res = []
    for pkg, ctx in pkgs:
        arrs = [pkg.nd.array(x, ctx=ctx) for x in xs]
        for a in arrs:
            a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.concat(*arrs, dim=dim)
        y.backward(pkg.nd.array(head, ctx=ctx))
        res.append([y.asnumpy()] + [a.grad.asnumpy() for a in arrs])
    for t, j in zip(res[1], res[0]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(res[1][0], np.concatenate(xs, axis=dim))
    np.testing.assert_array_equal(
        pkgs[1][0].nd.Concat(*[pkgs[1][0].nd.array(x, ctx=pkgs[1][1])
                               for x in xs], dim=dim).asnumpy(), res[1][0])
