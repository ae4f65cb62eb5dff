"""``autograd.grad`` and ``autograd.Function`` of the port against the
reference's, on the CPU (the twins of ``tests/test_autograd.py``'s
``test_grad_function``, ``test_higher_order`` and
``test_custom_function``, and more cases).

Values are f32 results of a few elementwise ops and sums, so they are
held within ``rtol 1e-6, atol 1e-7`` of the reference's.  A node whose
backward launches a hand-written kernel (flash attention, ``Custom``)
is differentiable once: a second derivative through it raises, and
never comes back as zeros.  ``grad`` inside a hybridized block's
forward works as the reference's traced call does; on the card that
forward is a captured CUDA graph (the ``cuda`` case).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

TOL = dict(rtol=1e-6, atol=1e-7)


def _arr(pkg, a):
    a = np.asarray(a, np.float32)
    return pkg.nd.array(a, ctx=P.cpu()) if pkg is P else pkg.nd.array(a)


def _both(fn):
    """``fn(pkg)`` in the reference and the port, as numpy trees."""
    def host(v):
        if isinstance(v, (list, tuple)):
            return [host(u) for u in v]
        return v.asnumpy() if hasattr(v, "asnumpy") else v
    return host(fn(R)), host(fn(P))


def _close(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _close(u, v)
    else:
        np.testing.assert_allclose(b, a, **TOL)


def test_grad_function():
    """Twin of tests/test_autograd.py:84: the gradient comes back and
    the variable's ``.grad`` buffer stays zero."""
    def fn(pkg):
        x = _arr(pkg, [1.0, 2.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x).sum()
        g = pkg.autograd.grad(y, [x])
        return [g[0], x.grad]
    want, got = _both(fn)
    _close(want, got)
    np.testing.assert_array_equal(got[1], [0.0, 0.0])


def test_higher_order():
    """Twin of tests/test_autograd.py:95: d2(x^3)/dx2 through
    ``create_graph=True``."""
    def fn(pkg):
        x = _arr(pkg, [2.0, -1.5])
        x.attach_grad()
        with pkg.autograd.record():
            y = x * x * x
            dy = pkg.autograd.grad(y, [x], create_graph=True)[0]
            d2y = pkg.autograd.grad(dy, [x])[0]
        return [dy, d2y]
    want, got = _both(fn)
    _close(want, got)
    np.testing.assert_allclose(got[1], [12.0, -9.0])


def test_custom_function():
    """Twin of tests/test_autograd.py:146: a user sigmoid with
    ``save_for_backward``/``saved_tensors``."""
    def fn(pkg):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = pkg.nd.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

        x = _arr(pkg, [0.0, 1.0, -2.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = Sigmoid()(x)
            z = (y * _arr(pkg, [1.0, 2.0, 3.0])).sum()
        z.backward()
        return [y, x.grad]
    want, got = _both(fn)
    _close(want, got)


def test_custom_function_two_inputs_two_outputs():
    """A Function of two inputs with two outputs; unrecorded, it runs
    the forward alone."""
    def fn(pkg):
        class SumProd(pkg.autograd.Function):
            def forward(self, a, b):
                self.save_for_backward(a, b)
                return a + b, a * b

            def backward(self, ds, dp):
                a, b = self.saved_tensors
                return ds + dp * b, ds + dp * a

        a, b = _arr(pkg, [1.0, 2.0]), _arr(pkg, [3.0, -4.0])
        plain = SumProd()(a, b)
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            s, p = SumProd()(a, b)
            (s * 2 + p * 3).sum().backward()
        return [plain[0], plain[1], s, p, a.grad, b.grad]
    want, got = _both(fn)
    _close(want, got)


@pytest.mark.parametrize("single", [True, False])
def test_grad_head_grads_and_many_variables(single):
    """Head gradients, two heads, several variables (one a single
    array, not in a list), ``retain_graph`` for a second call."""
    def fn(pkg):
        a, b = _arr(pkg, [1.0, -2.0, 3.0]), _arr(pkg, [0.5, 0.25, 2.0])
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            y1 = a * b
            y2 = pkg.nd.exp(a) + b * b
        hg = [_arr(pkg, [1.0, 2.0, 3.0]), _arr(pkg, [-1.0, 0.5, 1.0])]
        if single:
            ga = pkg.autograd.grad([y1, y2], a, head_grads=hg,
                                   retain_graph=True)
            gb = pkg.autograd.grad([y1, y2], b, head_grads=hg)
            return [ga, gb]
        return pkg.autograd.grad([y1, y2], [a, b], head_grads=hg)
    want, got = _both(fn)
    _close(want, got)


def test_grad_refuses_unmarked_variables_and_untaped_heads():
    x = _arr(P, [1.0])
    with pytest.raises(P.MXNetError, match="marked"):
        P.autograd.grad(x * 2, [x])
    x.attach_grad()
    with pytest.raises(P.MXNetError, match="tape"):
        P.autograd.grad(x * 2, [x])


def test_second_derivative_through_a_kernel_node_raises():
    """Flash attention's node (the kernels on the card, their plain
    versions here) and ``nd.Custom``'s are differentiable once: a
    gradient of their gradient raises."""
    from mxnet_tpu_torch.kernels.flash_attention import flash_attention
    rng = np.random.RandomState(0)
    q, k, v = [torch.tensor(rng.randn(1, 8, 2, 16).astype(np.float32),
                            requires_grad=True) for _ in range(3)]
    out = flash_attention(q, k, v)
    (g,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|"
                       "does not require grad"):
        torch.autograd.grad(g.sum(), q)

    class Square(P.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @P.operator.register("port_grad_square")
    class SquareProp(P.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Square()

    x = _arr(P, [1.0, 3.0])
    x.attach_grad()
    with P.autograd.record():
        y = P.nd.Custom(x, op_type="port_grad_square")
        (dx,) = P.autograd.grad(y.sum(), [x], create_graph=True)
        np.testing.assert_allclose(dx.asnumpy(), [2.0, 6.0])
        with pytest.raises(RuntimeError):
            P.autograd.grad(dx.sum(), [x])


def _grad_block(pkg):
    class GradOfSquare(pkg.gluon.HybridBlock):
        """Returns d(sum(w * x^2))/dx, taken inside the forward."""

        def hybrid_forward(self, F, x):
            x.attach_grad()
            with pkg.autograd.record():
                y = (x * x * 3).sum()
            return pkg.autograd.grad(y, [x])[0] + 1
    return GradOfSquare()


@pytest.mark.parametrize("hybridize", [False, True])
def test_grad_inside_a_hybridized_block(hybridize):
    """The reference's traced call (and the port's entry) takes the
    gradient inside the forward, on the first call and on later ones."""
    def fn(pkg):
        block = _grad_block(pkg)
        block.hybridize(hybridize)
        return [block(_arr(pkg, [1.0, -2.0])), block(_arr(pkg, [0.5, 4.0]))]
    want, got = _both(fn)
    _close(want, got)
    np.testing.assert_allclose(got[1], [4.0, 25.0])


@pytest.mark.cuda
def test_grad_inside_a_captured_block_on_the_card(cuda_device):
    """The same block hybridized on the card: its forward, gradient
    included, is a replayed CUDA graph that gives what the op-by-op
    call gives, for new inputs too."""
    block = _grad_block(P)
    block.hybridize()
    for v in ([1.0, -2.0], [0.5, 4.0], [3.0, 3.0]):
        x = P.nd.array(np.float32(v), ctx=P.gpu(0))
        np.testing.assert_allclose(block(x).asnumpy(),
                                   6 * np.float32(v) + 1, rtol=1e-6)
