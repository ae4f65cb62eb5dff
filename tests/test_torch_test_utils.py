"""The port's ``test_utils`` (MXNet's test oracles) on the CPU.

The reference's ``tests/test_test_utils.py`` cases run against
``mxnet_tpu_torch`` under ``mx.cpu()`` (the port's default context is
the card).  The reference's two numeric-gradient cases need
``jax.experimental.enable_x64`` and fail on its side; the port's
gradient oracle runs in torch float64 and passes them, with the
reference's own limits (rtol 1e-2, atol 1e-4).  The parity cases hold
``check_symbolic_forward``/``backward`` and ``check_consistency`` to the
reference's on one graph and one function from the same inputs: values
within 1e-6.  ``check_consistency``'s default contexts are ``[cpu()]``
plus ``gpu(0)`` where a card is present; the ``cuda`` case runs a few
ops of the op sweep, forward and gradient, across the CPU and the card,
each within its family's card limit times the gradient factor
(``tests/_torch_port.py`` ``CARD_TOL``, ``GRAD_FACTOR``).
"""
import numpy as np
import pytest

import _torch_port as T
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import test_utils as tu
from _torch_port import cuda_device  # noqa: F401


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def test_assert_almost_equal_pass_and_fail():
    a = np.ones((3, 3), np.float32)
    tu.assert_almost_equal(a, a + 1e-7)
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(a, a + 1.0)
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(a, np.ones((3, 2), np.float32))
    assert tu.almost_equal(a, a + 1e-7) and not tu.almost_equal(a, a + 1)
    assert tu.same(mx.nd.ones((2,)), np.ones(2, np.float32))


def test_assert_almost_equal_ndarray():
    a = mx.nd.ones((2, 2))
    tu.assert_almost_equal(a, np.ones((2, 2)))


def test_check_numeric_gradient_elemwise():
    tu.check_numeric_gradient(
        lambda x: (x * x).sum(),
        [np.random.randn(3, 4)])


def test_check_numeric_gradient_dot():
    tu.check_numeric_gradient(
        lambda a, b: mx.nd.dot(a, b),
        [np.random.randn(3, 4), np.random.randn(4, 2)])


def test_check_numeric_gradient_runs_in_float64():
    seen = []

    def f(x):
        seen.append(x.dtype)
        return mx.nd.exp(x).sum()
    ad, num = tu.check_numeric_gradient(f, [np.random.rand(5)])
    assert set(str(d) for d in seen) == {"float64"}
    np.testing.assert_allclose(ad[0], num[0], rtol=1e-7)


def test_check_numeric_gradient_catches_wrong_grad():
    with pytest.raises(AssertionError):
        tu.check_numeric_gradient(
            lambda x: mx.nd.sqrt(mx.nd.abs(x) + 2.0) + x.detach() * 0 +
            mx.nd.exp(x * 0) * 0 + _wrong(x),
            [np.random.rand(3) + 0.5])


def _wrong(x):
    # a custom Function with an intentionally wrong backward
    class Bad(mx.autograd.Function):
        def forward(self, a):
            return a * 2

        def backward(self, g):
            return g * 3.0  # wrong: should be 2.0

    return Bad()(x)


def test_check_consistency_dtypes():
    tu.check_consistency(
        lambda x: mx.nd.exp(x),
        [np.random.randn(4, 4)],
        ctx_list=[mx.cpu(), mx.cpu()],
        dtypes=[np.float32, np.float16])


def test_check_consistency_catches_a_difference():
    flip = {"n": 0}

    def fn(x):
        flip["n"] += 1
        return x * (1.0 if flip["n"] == 1 else 1.01)
    with pytest.raises(AssertionError):
        tu.check_consistency(fn, [np.random.randn(3)],
                             ctx_list=[mx.cpu(), mx.cpu()])


def test_check_consistency_default_contexts():
    runs = tu.check_consistency(lambda x: mx.nd.tanh(x),
                                [np.random.randn(2, 3)])
    assert len(runs) == 1 + (mx.num_gpus() > 0)


def test_rand_ndarray_shape():
    a = tu.rand_ndarray((2, 5))
    assert a.shape == (2, 5) and a.dtype == np.float32
    x, y = tu.random_arrays((2, 3), ())
    assert x.shape == (2, 3) and y.shape == ()
    assert tu.rand_shape_nd(3, 4).__len__() == 3
    assert tu.default_context() == mx.cpu()


def test_numeric_grad_matches_the_reference():
    import mxnet_tpu.test_utils as R
    x = np.random.RandomState(0).randn(3, 2)

    def f(a):
        return float(np.sum(np.sin(a) * a))
    got = tu.numeric_grad(f, [x.copy()])
    want = R.numeric_grad(f, [x.copy()])
    np.testing.assert_array_equal(got[0], want[0])


def _graph(S):
    data = S.sym.Variable("data")
    w = S.sym.Variable("w")
    h = S.sym.FullyConnected(data, w, num_hidden=3, no_bias=True,
                             name="fc")
    return S.sym.tanh(h, name="act")


def test_symbolic_oracles_match_the_reference():
    """Both packages' ``check_symbolic_forward``/``backward`` on one graph
    and the same inputs: outputs and gradients within 1e-6 of each other
    and of numpy."""
    import mxnet_tpu as R
    rng = np.random.RandomState(1)
    x = rng.randn(4, 5).astype(np.float32)
    w = rng.randn(3, 5).astype(np.float32)
    g = rng.randn(4, 3).astype(np.float32)
    y = np.tanh(x @ w.T)
    dh = g * (1 - y * y)
    want = {"data": dh @ w, "w": dh.T @ x}
    outs = tu.check_symbolic_forward(_graph(mx), [x, w], [y], rtol=1e-6,
                                     atol=1e-6, ctx=mx.cpu())
    grads = tu.check_symbolic_backward(_graph(mx), [x, w], [g], want,
                                       rtol=1e-5, atol=1e-6, ctx=mx.cpu())
    r_outs = R.test_utils.check_symbolic_forward(_graph(R), [x, w], [y],
                                                 rtol=1e-6, atol=1e-6)
    r_grads = R.test_utils.check_symbolic_backward(_graph(R), [x, w], [g],
                                                   want, rtol=1e-5,
                                                   atol=1e-6)
    np.testing.assert_allclose(outs[0].asnumpy(), r_outs[0].asnumpy(),
                               rtol=1e-6, atol=1e-6)
    for k in ("data", "w"):
        np.testing.assert_allclose(grads[k].asnumpy(),
                                   r_grads[k].asnumpy(), rtol=1e-6,
                                   atol=1e-6)


def test_check_consistency_matches_the_reference():
    import mxnet_tpu as R
    x = np.random.RandomState(2).randn(3, 4)
    runs = tu.check_consistency(lambda a: mx.nd.sigmoid(a) * a, [x],
                                ctx_list=[mx.cpu(), mx.cpu()])
    r_runs = R.test_utils.check_consistency(lambda a: R.nd.sigmoid(a) * a,
                                            [x], ctx_list=[R.cpu(),
                                                           R.cpu()])
    for (dt, out, grads), (rdt, rout, rgrads) in zip(runs, r_runs):
        assert dt == rdt and out.dtype == rout.dtype
        np.testing.assert_allclose(out, rout, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grads[0], rgrads[0], rtol=1e-6,
                                   atol=1e-6)


# ops of the op sweep, forward and input gradient, CPU against the card,
# each within its family's CARD_TOL times GRAD_FACTOR (one limit holds
# the forward and the gradients)
CARD_OPS = [
    ("tanh", lambda nd, a: nd.tanh(a), [(3, 4)], "transc"),
    ("dot", lambda nd, a, b: nd.dot(a, b), [(3, 4), (4, 5)], "reduce"),
    ("softmax", lambda nd, a: nd.softmax(a, axis=-1), [(2, 7)], "transc"),
    ("LayerNorm", lambda nd, a, g, b: nd.LayerNorm(a, g, b),
     [(4, 6), (6,), (6,)], "reduce"),
    ("Convolution", lambda nd, x, w: nd.Convolution(
        x, w, kernel=(3, 3), num_filter=4, no_bias=True, pad=(1, 1)),
     [(2, 3, 6, 6), (4, 3, 3, 3)], "linalg"),
    ("broadcast_mul", lambda nd, a, b: nd.broadcast_mul(a, b),
     [(3, 4), (1, 4)], "arith"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,fn,shapes,fam", CARD_OPS,
                         ids=[c[0] for c in CARD_OPS])
def test_check_consistency_cpu_and_card(name, fn, shapes, fam,
                                        cuda_device):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(3)
    inputs = [rng.randn(*s) for s in shapes]
    rtol, atol = T.grad_tol(fam, T.CARD_TOL)
    runs = tu.check_consistency(lambda *xs: fn(mx.nd, *xs), inputs,
                                rtol=rtol, atol=atol)
    assert len(runs) == 2
