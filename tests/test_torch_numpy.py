"""The port's ``mx.np`` / ``mx.npx`` / ``mx.util`` on the CPU.

The reference's ``tests/test_numpy.py`` classes run against
``mxnet_tpu_torch`` (NumPy oracles, the tolerances stated in each
assertion; every array made under ``mx.cpu()``, the port's default
context being the card), with the reference's expected dtypes: an int
source is int32, a float one float32.  ``TestAgainstReference`` holds
the API functions that are more than one registry op (stacks, splits,
``array_split``, ``atleast_*``, ``meshgrid``, ``broadcast_arrays``) and
the creation functions against ``mxnet_tpu`` on the same inputs, values
within 1e-6 and dtypes equal.  ``mx.np.random`` cannot reproduce
``jax.random``'s streams: its draws are held to their distribution's
moments within 6 standard errors and a seeded repeat bit for bit.  The
MLP case trains ``examples/mnist_mlp.py``'s network hybridized under
``set_np`` on ``mx.np`` arrays, bit for bit against the classic-NDArray
run.
"""
import numpy as onp
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd

np = mx.np
npx = mx.npx


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _assert_close(a, b, rtol=1e-5, atol=1e-6):
    onp.testing.assert_allclose(a.asnumpy() if hasattr(a, "asnumpy") else a,
                                b, rtol=rtol, atol=atol)


class TestCreation:
    def test_array_dtypes(self):
        a = np.array([1, 2, 3])
        assert a.dtype == onp.int32  # int64→int32 TPU policy
        b = np.array([1.0, 2.0])
        assert b.dtype == onp.float32
        c = np.array([1, 2], dtype="float64")
        assert c.dtype == onp.float64      # the port has float64

    def test_creation_fns(self):
        assert np.zeros((2, 3)).shape == (2, 3)
        assert np.ones(4).sum().item() == 4.0
        _assert_close(np.full((2,), 7.0), onp.full((2,), 7.0))
        _assert_close(np.arange(5), onp.arange(5))
        _assert_close(np.linspace(0, 1, 5), onp.linspace(0, 1, 5))
        _assert_close(np.eye(3), onp.eye(3))
        x = np.array([[1.0, 2.0]])
        _assert_close(np.zeros_like(x), onp.zeros((1, 2)))
        g = np.meshgrid(np.arange(2), np.arange(3))
        assert g[0].shape == (3, 2)

    def test_interop_with_nd(self):
        """np.ndarray IS an NDArray: classic ops and Gluon accept it."""
        a = np.ones((2, 2))
        assert isinstance(a, mx.nd.NDArray)
        out = mx.nd.sum(a)
        assert float(out.asnumpy()) == 4.0
        back = a.as_nd_ndarray()
        assert isinstance(back, mx.nd.NDArray)


class TestElementwise:
    def test_unary_oracle(self):
        x = onp.random.RandomState(0).rand(3, 4).astype("float32") + 0.1
        a = np.array(x)
        for name in ["exp", "log", "sqrt", "sin", "cos", "tanh", "abs",
                     "floor", "ceil", "square", "sign"]:
            _assert_close(getattr(np, name)(a), getattr(onp, name)(x),
                          rtol=1e-5)

    def test_binary_oracle(self):
        r = onp.random.RandomState(1)
        x = r.rand(3, 4).astype("float32") + 0.5
        y = r.rand(4).astype("float32") + 0.5  # broadcasts
        a, b = np.array(x), np.array(y)
        for name in ["add", "subtract", "multiply", "divide", "power",
                     "maximum", "minimum", "arctan2", "hypot"]:
            _assert_close(getattr(np, name)(a, b), getattr(onp, name)(x, y),
                          rtol=1e-5)

    def test_comparisons(self):
        a = np.array([1.0, 2.0, 3.0])
        b = np.array([2.0, 2.0, 2.0])
        assert np.equal(a, b).asnumpy().tolist() == [False, True, False]
        assert np.greater(a, b).asnumpy().tolist() == [False, False, True]
        assert (a > 2).asnumpy().tolist() == [False, False, True]

    def test_scalar_mixing(self):
        a = np.array([1.0, 2.0])
        _assert_close(a + 1, [2.0, 3.0])
        _assert_close(2 * a, [2.0, 4.0])
        _assert_close(1 / a, [1.0, 0.5])


class TestReductions:
    def test_axis_tuples(self):
        x = onp.random.RandomState(2).rand(2, 3, 4).astype("float32")
        a = np.array(x)
        _assert_close(np.sum(a, axis=(0, 2)), x.sum(axis=(0, 2)), rtol=1e-5)
        _assert_close(np.mean(a, axis=(1,)), x.mean(axis=1), rtol=1e-5)
        _assert_close(np.max(a, axis=0, keepdims=True),
                      x.max(axis=0, keepdims=True))
        _assert_close(np.std(a), x.std(), rtol=1e-4)
        _assert_close(np.var(a, ddof=1), x.var(ddof=1), rtol=1e-4)
        _assert_close(np.prod(a, axis=2), x.prod(axis=2), rtol=1e-4)

    def test_arg_and_cum(self):
        x = onp.array([[3.0, 1.0], [2.0, 4.0]], dtype="float32")
        a = np.array(x)
        assert np.argmax(a).item() == 3
        _assert_close(np.argmin(a, axis=0), x.argmin(axis=0))
        _assert_close(np.cumsum(a, axis=1), x.cumsum(axis=1))

    def test_methods(self):
        a = np.array([[1.0, 2.0], [3.0, 4.0]])
        assert a.sum().item() == 10.0
        assert a.mean(axis=0).shape == (2,)
        assert a.max().item() == 4.0


class TestManipulation:
    def test_reshape_transpose(self):
        a = np.arange(6)
        b = a.reshape(2, 3)
        assert b.shape == (2, 3)
        assert b.reshape((3, 2)).shape == (3, 2)
        assert b.reshape(-1).shape == (6,)
        assert b.T.shape == (3, 2)
        c = np.arange(24).reshape(2, 3, 4)
        assert np.transpose(c, (2, 0, 1)).shape == (4, 2, 3)
        assert c.transpose(2, 0, 1).shape == (4, 2, 3)

    def test_concat_stack_split(self):
        a = np.ones((2, 3))
        assert np.concatenate([a, a], axis=1).shape == (2, 6)
        assert np.stack([a, a]).shape == (2, 2, 3)
        assert np.vstack([a, a]).shape == (4, 3)
        assert np.hstack([a, a]).shape == (2, 6)
        parts = np.split(np.arange(9), 3)
        assert len(parts) == 3 and parts[0].shape == (3,)

    def test_misc_manip(self):
        x = onp.arange(12, dtype="float32").reshape(3, 4)
        a = np.array(x)
        _assert_close(np.flip(a, 0), onp.flip(x, 0))
        _assert_close(np.roll(a, 1, axis=1), onp.roll(x, 1, axis=1))
        _assert_close(np.tile(a, (2, 1)), onp.tile(x, (2, 1)))
        _assert_close(np.repeat(a, 2, axis=0), onp.repeat(x, 2, axis=0))
        _assert_close(np.expand_dims(a, 0), x[None])
        _assert_close(np.broadcast_to(np.array([1.0, 2.0]), (3, 2)),
                      onp.broadcast_to([1.0, 2.0], (3, 2)))
        _assert_close(np.pad(a, ((1, 1), (0, 0))),
                      onp.pad(x, ((1, 1), (0, 0))))
        _assert_close(np.tril(a), onp.tril(x))
        _assert_close(np.where(a > 5, a, -1.0), onp.where(x > 5, x, -1.0))
        _assert_close(np.clip(a, 2, 8), onp.clip(x, 2, 8))


class TestLinalg:
    def test_products(self):
        r = onp.random.RandomState(3)
        x = r.rand(3, 4).astype("float32")
        y = r.rand(4, 5).astype("float32")
        _assert_close(np.dot(np.array(x), np.array(y)), x.dot(y), rtol=1e-4)
        _assert_close(np.matmul(np.array(x), np.array(y)), x @ y, rtol=1e-4)
        _assert_close(np.tensordot(np.array(x), np.array(y), axes=1),
                      onp.tensordot(x, y, axes=1), rtol=1e-4)
        _assert_close(np.einsum("ij,jk->ik", np.array(x), np.array(y)),
                      onp.einsum("ij,jk->ik", x, y), rtol=1e-4)
        v = r.rand(3).astype("float32")
        _assert_close(np.outer(np.array(v), np.array(v)), onp.outer(v, v),
                      rtol=1e-5)

    def test_decompositions(self):
        r = onp.random.RandomState(4)
        m = r.rand(4, 4).astype("float32")
        spd = m @ m.T + 4 * onp.eye(4, dtype="float32")
        a = np.array(spd)
        _assert_close(np.linalg.det(a), onp.linalg.det(spd), rtol=1e-3)
        _assert_close(np.linalg.inv(a) , onp.linalg.inv(spd), rtol=1e-3,
                      atol=1e-4)
        L = np.linalg.cholesky(a)
        _assert_close(np.matmul(L, L.T), spd, rtol=1e-4, atol=1e-4)
        w, v = np.linalg.eigh(a)
        _assert_close(np.linalg.norm(a), onp.linalg.norm(spd), rtol=1e-5)
        b = r.rand(4).astype("float32")
        _assert_close(np.linalg.solve(a, np.array(b)),
                      onp.linalg.solve(spd, b), rtol=1e-3, atol=1e-4)


class TestAutogradThroughNp:
    def test_grad_unary_chain(self):
        x = np.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with autograd.record():
            y = np.sum(np.exp(x) * 2)
        y.backward()
        _assert_close(x.grad, 2 * onp.exp([1.0, 2.0, 3.0]), rtol=1e-5)

    def test_grad_matmul(self):
        a = np.ones((2, 3))
        b = np.ones((3, 4))
        a.attach_grad()
        with autograd.record():
            out = np.sum(np.matmul(a, b))
        out.backward()
        _assert_close(a.grad, onp.full((2, 3), 4.0))

    def test_grad_reduction_axis(self):
        x = np.array([[1.0, 2.0], [3.0, 4.0]])
        x.attach_grad()
        with autograd.record():
            y = np.sum(np.mean(x, axis=1) ** 2)
        y.backward()
        # d/dx_ij (sum_i mean_i^2) = 2*mean_i / 2
        m = onp.array([1.5, 3.5])
        _assert_close(x.grad, onp.stack([m, m], axis=1), rtol=1e-5)


class TestRandomNp:
    def test_shapes_and_ranges(self):
        u = np.random.uniform(0, 1, size=(100,))
        assert u.shape == (100,)
        x = u.asnumpy()
        assert (x >= 0).all() and (x < 1).all()
        n = np.random.normal(5.0, 0.01, size=(200,))
        assert abs(n.asnumpy().mean() - 5.0) < 0.1
        r = np.random.randint(0, 10, size=(50,))
        assert r.asnumpy().max() < 10
        assert np.random.randn(2, 3).shape == (2, 3)

    def test_seed_reproducible(self):
        np.random.seed(42)
        a = np.random.uniform(size=(4,)).asnumpy()
        np.random.seed(42)
        b = np.random.uniform(size=(4,)).asnumpy()
        onp.testing.assert_array_equal(a, b)


class TestNpx:
    def test_activations(self):
        x = np.array([-1.0, 0.0, 2.0])
        _assert_close(npx.relu(x), [0.0, 0.0, 2.0])
        _assert_close(npx.sigmoid(x), 1 / (1 + onp.exp([1.0, 0.0, -2.0])),
                      rtol=1e-5)
        s = npx.softmax(np.array([1.0, 2.0, 3.0]))
        _assert_close(np.sum(s), 1.0, rtol=1e-5)
        ls = npx.log_softmax(np.array([1.0, 2.0, 3.0]))
        _assert_close(np.exp(ls).sum(), 1.0, rtol=1e-5)

    def test_nn_ops(self):
        x = np.ones((2, 8))
        w = np.ones((4, 8))
        b = np.zeros((4,))
        out = npx.fully_connected(x, w, b, num_hidden=4)
        _assert_close(out, onp.full((2, 4), 8.0))
        oh = npx.one_hot(np.array([0, 2]), 3)
        _assert_close(oh, onp.eye(3)[[0, 2]])

    def test_set_np_switch(self):
        from mxnet_tpu_torch import util
        assert not util.is_np_array()
        npx.set_np()
        assert util.is_np_array()
        npx.reset_np()
        assert not util.is_np_array()

        @util.use_np
        def inner():
            return util.is_np_array()
        assert inner() is True


class TestSearchLogic:
    def test_search(self):
        x = onp.array([3.0, 0.0, 5.0, 0.0], dtype="float32")
        a = np.array(x)
        nz = np.nonzero(a)
        assert nz[0].asnumpy().tolist() == [0, 2]
        assert np.unique(np.array([3, 1, 3, 2])).asnumpy().tolist() == [1, 2, 3]
        _assert_close(np.sort(a), onp.sort(x))
        _assert_close(np.argsort(a), onp.argsort(x))
        assert np.allclose(a, a + 1e-9)
        assert np.array_equal(a, a)
        assert not np.array_equal(a, a + 1)
        _assert_close(np.bincount(np.array([0, 1, 1, 3])),
                      onp.bincount([0, 1, 1, 3]))


def test_np_statistics_and_misc_extensions():
    """percentile/quantile/cov/histogram/broadcast_arrays/column_stack/
    digitize/diff/trapz/ediff1d coverage."""
    a = np.array([[1., 2., 3.], [4., 5., 6.]])
    assert abs(float(np.percentile(a, 50)) - 3.5) < 1e-5
    assert abs(float(np.quantile(a, 0.5)) - 3.5) < 1e-5
    assert np.cov(a).shape == (2, 2)
    h, edges = np.histogram(np.array([1., 2., 2., 3.]), bins=3)
    assert h.asnumpy().sum() == 4 and edges.shape == (4,)
    b0, b1 = np.broadcast_arrays(np.array([[1.], [2.]]),
                                 np.array([1., 2., 3.]))
    assert b0.shape == b1.shape == (2, 3)
    assert np.column_stack([np.array([1., 2.]),
                            np.array([3., 4.])]).shape == (2, 2)
    assert np.digitize(np.array([0.5, 1.5, 2.5]),
                       np.array([1., 2.])).asnumpy().tolist() == [0, 1, 2]
    assert np.diff(np.array([1., 4., 9.])).asnumpy().tolist() == [3., 5.]
    assert abs(float(np.trapz(np.array([1., 2., 3.]))) - 4.0) < 1e-6
    assert np.ediff1d(a).shape == (5,)


class TestLongTail:
    """Generated jnp-backed long-tail functions vs numpy oracles."""

    def test_unary_family(self):
        a = np.array(onp.array([[3.0, -1.0], [0.5, 2.0]], "float32"))
        for name in ["fliplr", "flipud", "positive", "deg2rad",
                     "rad2deg", "sinc"]:
            got = getattr(np, name)(a).asnumpy()
            want = getattr(onp, name)(a.asnumpy())
            assert onp.allclose(got, want, atol=1e-6), name

    def test_reductions_and_windows(self):
        a = np.array(onp.array([[3.0, -1.0], [0.5, 2.0]], "float32"))
        assert onp.isclose(float(np.ptp(a).asnumpy()), 4.0)
        assert int(np.count_nonzero(a).asnumpy()) == 4
        assert onp.allclose(np.hanning(8).asnumpy(), onp.hanning(8),
                            atol=1e-6)
        assert onp.allclose(np.hamming(5).asnumpy(), onp.hamming(5),
                            atol=1e-6)

    def test_binary_and_multi_output(self):
        a = np.array(onp.array([1.0, -2.0, 3.0], "float32"))
        b = np.array(onp.array([0.5, 0.5, 0.5], "float32"))
        assert onp.allclose(np.fmax(a, b).asnumpy(),
                            onp.fmax(a.asnumpy(), b.asnumpy()))
        assert onp.allclose(np.logaddexp2(a, b).asnumpy(),
                            onp.logaddexp2(a.asnumpy(), b.asnumpy()),
                            rtol=1e-5)
        m, e = np.frexp(a)
        assert onp.allclose(
            m.asnumpy() * 2.0 ** e.asnumpy().astype("float32"),
            a.asnumpy())
        p = np.array(onp.array([1.0, 2.0, 3.0], "float32"))
        x = np.array(onp.array([2.0], "float32"))
        assert onp.allclose(np.polyval(p, x).asnumpy(), [11.0])

    def test_frexp_divmod_grad_semantics(self):
        """frexp has an int-dtype exponent: it must not land on the tape
        (backward would seed a non-float cotangent).  divmod/modf stay
        differentiable — their outputs are float for float inputs, and
        divmod's remainder grad matches np.mod."""
        import pytest
        from mxnet_tpu_torch.base import MXNetError
        a = np.array(onp.array([1.5, -2.25, 3.0], "float32"))
        a.attach_grad()
        with autograd.record():
            m, e = np.frexp(a)
        for outp in (m, e):
            with pytest.raises(MXNetError):
                outp.backward()
        with autograd.record():
            q, r = np.divmod(a, np.array(onp.array([1.0, 1.0, 1.0],
                                                   "float32")))
        r.backward()
        assert onp.allclose(a.grad.asnumpy(), [1.0, 1.0, 1.0])
        with autograd.record():
            frac, whole = np.modf(a)
            L = frac.sum()
        L.backward()
        assert a.grad is not None

    def test_grad_through_generated_fn(self):
        a = np.array(onp.array([[3.0, -1.0]], "float32"))
        a.attach_grad()
        with autograd.record():
            L = np.fmax(a, np.zeros_like(a)).sum()
        L.backward()
        assert onp.allclose(a.grad.asnumpy(), [[1.0, 0.0]])

    def test_scalar_operand_backward(self):
        """Regression: python-scalar operands are tape constants, not
        dropped (replay misalignment crashed backward)."""
        a = np.array(onp.array([[3.0, -1.0]], "float32"))
        a.attach_grad()
        with autograd.record():
            L = np.fmax(a, 0.5).sum()
        L.backward()
        assert onp.allclose(a.grad.asnumpy(), [[1.0, 0.0]])

    def test_in1d_and_out_kwarg(self):
        r = np.in1d(np.array(onp.array([1., 2., 3.], "float32")),
                    np.array(onp.array([2., 4.], "float32"))).asnumpy()
        assert onp.array_equal(r, [False, True, False])
        a = np.array(onp.array([[3.0, -1.0]], "float32"))
        c = np.zeros((1, 2))
        np.fmax(a, np.zeros_like(a), out=c)
        assert onp.allclose(c.asnumpy(), [[3.0, 0.0]])


def _ref():
    import mxnet_tpu
    return mxnet_tpu


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = got.asnumpy(), want.asnumpy()
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    onp.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


class TestAgainstReference:
    """The port's mx.np functions against the reference's, same inputs:
    dtypes equal, values within 1e-6."""

    CASES = [
        ("array", lambda P, x: P.np.array([1, 2, 3])),
        ("array float", lambda P, x: P.np.array([[1.5, 2.0]])),
        ("array numpy f64", lambda P, x: P.np.array(x.astype("float64"))),
        ("arange", lambda P, x: P.np.arange(2, 11, 3)),
        ("arange float", lambda P, x: P.np.arange(0.5, 3.0, 0.5)),
        ("linspace", lambda P, x: P.np.linspace(-1, 2, 7)),
        ("linspace open", lambda P, x: P.np.linspace(0, 1, 4,
                                                     endpoint=False)),
        ("logspace", lambda P, x: P.np.logspace(0, 2, 5)),
        ("eye", lambda P, x: P.np.eye(3, 4, k=1)),
        ("identity", lambda P, x: P.np.identity(3)),
        ("full int", lambda P, x: P.np.full((2, 3), 7, dtype="int32")),
        ("zeros_like", lambda P, x: P.np.zeros_like(P.np.array(x))),
        ("ones_like", lambda P, x: P.np.ones_like(P.np.array(x))),
        ("vstack", lambda P, x: P.np.vstack([P.np.array(x[0]),
                                             P.np.array(x[1])])),
        ("hstack", lambda P, x: P.np.hstack([P.np.array(x),
                                             P.np.array(x)])),
        ("dstack", lambda P, x: P.np.dstack([P.np.array(x),
                                             P.np.array(x)])),
        ("hsplit", lambda P, x: P.np.hsplit(P.np.array(x), 2)),
        ("vsplit", lambda P, x: P.np.vsplit(P.np.array(x), [1])),
        ("atleast_3d", lambda P, x: P.np.atleast_3d(P.np.array(x[0]))),
        ("meshgrid", lambda P, x: P.np.meshgrid(P.np.array(x[0]),
                                                P.np.array(x[1][:2]))),
        ("broadcast_arrays", lambda P, x: P.np.broadcast_arrays(
            P.np.array(x[:, :1]), P.np.array(x[0]))),
        ("where 1-arg", lambda P, x: P.np.where(P.np.array(x) > 0)),
        ("true_divide ints", lambda P, x: P.np.true_divide(
            P.np.array([1, 2, 3]), P.np.array([2, 2, 2]))),
        ("mean ints", lambda P, x: P.np.mean(P.np.array([1, 2, 4]))),
        ("sum bools", lambda P, x: P.np.sum(P.np.array([True, True,
                                                        False]))),
        ("int plus float scalar", lambda P, x: P.np.array([1, 2]) + 0.5),
        ("percentile of array q", lambda P, x: P.np.percentile(
            P.np.array(x), P.np.array([25.0, 75.0]))),
        ("ndarray methods", lambda P, x: [
            P.np.array(x).reshape(2, 2, 2).sum(axis=(0, 2)),
            P.np.array(x).T, P.np.array(x).astype("int32"),
            P.np.array(x).clip(-0.5, 0.5), P.np.array(x).cumsum(axis=1),
            P.np.array(x).std(ddof=1), P.np.array(x).argmax(axis=1),
            P.np.array(x).repeat(2, axis=0), P.np.array(x).flatten()]),
        ("linalg", lambda P, x: [
            P.np.linalg.norm(P.np.array(x)),
            P.np.linalg.det(P.np.array(x[:, :2])),
            P.np.linalg.pinv(P.np.array(x))]),
        ("npx", lambda P, x: [
            P.npx.relu(P.np.array(x)), P.npx.softmax(P.np.array(x)),
            P.npx.log_softmax(P.np.array(x), axis=0),
            P.npx.leaky_relu(P.np.array(x), 0.1),
            P.npx.gelu(P.np.array(x)),
            P.npx.one_hot(P.np.array([0, 3]), 4),
            P.npx.pick(P.np.array(x), P.np.array([1.0, 0.0])),
            P.npx.topk(P.np.array(x), k=2),
            P.npx.batch_dot(P.np.array(x).reshape(2, 2, 2),
                            P.np.array(x).reshape(2, 2, 2)),
            P.npx.sequence_mask(P.np.array(x).reshape(2, 2, 2),
                                P.np.array([1.0, 2.0]),
                                use_sequence_length=True, value=-1.0),
            P.npx.arange_like(P.np.array(x), axis=1)]),
    ]

    @pytest.mark.parametrize("name,fn", CASES, ids=[c[0] for c in CASES])
    def test_function(self, name, fn):
        x = onp.random.RandomState(5).randn(2, 4).astype("float32")
        R = _ref()
        want = fn(R, x)
        got = fn(mx, x)
        _same(got, want)
        for g, w in zip(*[v if isinstance(v, (list, tuple)) else [v]
                          for v in (got, want)]):
            assert type(g).__name__ == type(w).__name__, name


def _moments(x, mean, var):
    n = x.size
    se_mean = (var / n) ** 0.5
    assert abs(x.mean() - mean) < 6 * se_mean, (x.mean(), mean)
    if var > 0:
        # the sample variance's standard error for a distribution with
        # finite fourth moment, bounded by 3 sigma^4 (normal) times 4
        se_var = (4 * 2 * var ** 2 / (n - 1)) ** 0.5
        assert abs(x.var(ddof=1) - var) < 6 * se_var, (x.var(), var)


class TestRandomMoments:
    N = 20000

    @pytest.mark.parametrize("name,draw,mean,var", [
        ("uniform", lambda n: np.random.uniform(-1.0, 3.0, size=(n,)),
         1.0, 16.0 / 12),
        ("normal", lambda n: np.random.normal(2.0, 0.5, size=n), 2.0,
         0.25),
        ("randn", lambda n: np.random.randn(n), 0.0, 1.0),
        ("rand", lambda n: np.random.rand(n), 0.5, 1.0 / 12),
        ("randint", lambda n: np.random.randint(0, 10, size=(n,)), 4.5,
         (100 - 1) / 12.0),
        ("gamma", lambda n: np.random.gamma(2.0, 1.5, size=n), 3.0, 4.5),
        ("exponential", lambda n: np.random.exponential(2.0, size=n),
         2.0, 4.0),
        ("beta", lambda n: np.random.beta(2.0, 3.0, size=n), 0.4,
         0.04),
        ("poisson", lambda n: np.random.poisson(3.0, size=n), 3.0, 3.0),
        ("bernoulli", lambda n: np.random.bernoulli(0.3, size=n), 0.3,
         0.21),
    ])
    def test_moments_and_seeded_repeat(self, name, draw, mean, var):
        np.random.seed(11)
        a = draw(self.N)
        assert isinstance(a, mx.nd.NDArray)
        x = a.asnumpy().astype("float64")
        _moments(x, mean, var)
        np.random.seed(11)
        onp.testing.assert_array_equal(draw(self.N).asnumpy(), a.asnumpy())

    def test_array_split(self):
        x = onp.arange(14.0, dtype="float32").reshape(2, 7)
        for got, want in zip(np.array_split(np.array(x), 3, axis=1),
                             onp.array_split(x, 3, axis=1)):
            onp.testing.assert_array_equal(got.asnumpy(), want)

    def test_host_samplers(self):
        onp.random.seed(3)
        c = np.random.choice(5, size=(4000,))
        assert set(onp.unique(c.asnumpy())) <= set(range(5))
        _moments(c.asnumpy().astype("float64"), 2.0, 2.0)
        p = np.random.permutation(10).asnumpy()
        assert sorted(p.tolist()) == list(range(10))
        m = np.random.multinomial(20, [0.2, 0.3, 0.5], size=3).asnumpy()
        assert m.shape == (3, 3) and (m.sum(1) == 20).all()
        x = np.arange(12).reshape(6, 2)
        before = sorted(x.asnumpy()[:, 0].tolist())
        np.random.shuffle(x)
        assert sorted(x.asnumpy()[:, 0].tolist()) == before


def _mlp(mx_, ctx):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu"),
                nn.Dense(16, activation="relu"), nn.Dense(10))
    net.initialize(mx_.initializer.Xavier(), ctx=ctx)
    return net


def mlp_run(as_np, steps=4, ctx=None, seed=0):
    """``examples/mnist_mlp.py``'s MLP (narrowed) hybridized, ``steps``
    SGD-with-momentum steps on seeded synthetic batches, fed as
    ``mx.np`` arrays under ``set_np`` (``as_np``) or as classic NDArrays.
    Returns the losses and the final weights as numpy."""
    from mxnet_tpu_torch import gluon, util
    ctx = ctx or mx.cpu()
    mx.random.seed(seed)
    onp.random.seed(seed)                  # Xavier draws from numpy
    net = _mlp(mx, ctx)
    rng = onp.random.RandomState(seed)
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    make = (lambda a: np.array(a, ctx=ctx)) if as_np else \
        (lambda a: mx.nd.array(a, ctx=ctx))
    scope = util.np_array(as_np)
    with scope:
        for i in range(steps):
            x = rng.randn(16, 64).astype("float32")
            y = rng.randint(0, 10, 16).astype("float32")
            xd, yd = make(x), make(y)
            with autograd.record():
                L = loss_fn(net(xd), yd)
            L.backward()
            tr.step(16)
            losses.append(L.asnumpy())
    return losses, [p.data().asnumpy() for _, p in
                    sorted(net.collect_params().items())]


def test_mlp_on_np_arrays_is_the_classic_run():
    l_np, w_np = mlp_run(True)
    l_nd, w_nd = mlp_run(False)
    for a, b in zip(l_np + w_np, l_nd + w_nd):
        onp.testing.assert_array_equal(a, b)
    assert onp.isfinite(l_np[-1]).all()
