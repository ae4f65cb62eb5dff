"""The port's control flow (``mxnet_tpu_torch/ndarray/contrib.py``:
``foreach``, ``while_loop``, ``cond``) against the reference's
(``mxnet_tpu/ndarray/contrib.py``), on the CPU.

The six tests of ``tests/test_control_flow.py`` run in both packages
from the same numpy inputs: outputs, final states and, where a test
differentiates, gradients within 1e-6 + 1e-5 x |ref| (the bodies' sums
and tanh in each package's own order; measured worst: 0.07 of the limit,
4.8e-7 absolute).  Each
construct also runs inside a hybridized block (the block's ``_CachedOp``
entry: on the card a CUDA graph, on the CPU the same body run eagerly)
equal to the block run op by op, twice with new inputs, and
``while_loop``'s count of steps taken equals the reference's.  The
``cuda`` tests (skipped without a card) replay each construct's
captured block against the same block run op by op, bit for bit, and
check that ``cond`` reads nothing back to the host.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

TOL = dict(rtol=1e-5, atol=1e-6)


def arr(mx, a, ctx=None):
    a = np.asarray(a, np.float32)
    return mx.nd.array(a, ctx=ctx or P.cpu()) if mx is P else mx.nd.array(a)


def zeros(mx, shape, ctx=None):
    return arr(mx, np.zeros(shape), ctx)


def both(fn):
    """``fn(mx)`` in the reference and in the port, as numpy trees."""
    def to_np(x):
        if isinstance(x, (list, tuple)):
            return [to_np(v) for v in x]
        return x.asnumpy() if hasattr(x, "asnumpy") else x
    return to_np(fn(R)), to_np(fn(P))


def assert_same(r, p):
    if isinstance(r, list):
        assert len(r) == len(p)
        for a, b in zip(r, p):
            assert_same(a, b)
        return
    np.testing.assert_allclose(p, r, **TOL)


def cumsum(mx):
    def body(x, state):
        new = state + x
        return new, new
    data = arr(mx, np.arange(12).reshape(4, 3))
    return list(mx.nd.contrib.foreach(body, data, zeros(mx, (3,))))


def test_foreach_cumsum():
    r, p = both(cumsum)
    assert_same(r, p)
    expect = np.cumsum(np.arange(12).reshape(4, 3), axis=0)
    np.testing.assert_array_equal(p[0], expect)
    np.testing.assert_array_equal(p[1], expect[-1])


def test_foreach_multiple_states_and_grad():
    x_np = np.random.RandomState(0).rand(5, 4).astype(np.float32) + 0.5

    def run(mx):
        def body(x, states):
            s1, s2 = states
            ns1 = s1 * x
            ns2 = s2 + x
            return ns1 + ns2, [ns1, ns2]
        data = arr(mx, x_np)
        data.attach_grad()
        with mx.autograd.record():
            outs, final = mx.nd.contrib.foreach(
                body, data, [arr(mx, np.ones(4)), zeros(mx, (4,))])
            loss = outs.sum()
        loss.backward()
        return [outs, final, data.grad]

    r, p = both(run)
    assert_same(r, p)
    assert np.all(np.isfinite(p[2]))


def test_foreach_rnn_like_matches_unrolled():
    rng = np.random.RandomState(1)
    W_np = (rng.randn(8, 8) * 0.1).astype(np.float32)
    xs = rng.randn(6, 2, 8).astype(np.float32)

    def run(mx):
        W = arr(mx, W_np)

        def body(x, h):
            new_h = mx.nd.tanh(mx.nd.dot(x, W) + h)
            return new_h, new_h
        return list(mx.nd.contrib.foreach(body, arr(mx, xs),
                                          zeros(mx, (2, 8))))

    r, p = both(run)
    assert_same(r, p)
    h = np.zeros((2, 8), np.float32)
    for t in range(6):
        h = np.tanh(xs[t] @ W_np + h)
    np.testing.assert_allclose(p[1], h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p[0][-1], h, rtol=1e-5, atol=1e-5)


def counting(mx):
    def cond(i, s):
        return i < 5

    def func(i, s):
        return i, (i + 1, s + i)
    outs, (i_f, s_f) = mx.nd.contrib.while_loop(
        cond, func, [zeros(mx, (1,)), zeros(mx, (1,))], max_iterations=8)
    return [outs, i_f, s_f]


def test_while_loop():
    r, p = both(counting)
    assert_same(r, p)
    outs, i_f, s_f = p
    assert float(i_f[0]) == 5 and float(s_f[0]) == 0 + 1 + 2 + 3 + 4
    assert outs.shape[0] == 8 and outs[5:].sum() == 0


def test_while_loop_counts_the_steps_taken():
    """The masked loop's count of steps taken (the reference computes it
    inside its op, ``contrib.py:169``) and the gradient through the
    loop vars, as the reference's."""
    from mxnet_tpu_torch.ndarray.contrib import _while_loop

    def run(mx):
        x = arr(mx, [0.5, 1.5])
        x.attach_grad()
        with mx.autograd.record():
            outs, (v, s) = mx.nd.contrib.while_loop(
                lambda v, s: s.sum() < 20.0,
                lambda v, s: (v * s, (v * 1.5, s + v * v)),
                [x, x * 2], max_iterations=6)
            loss = outs.sum() + v.sum() + s.sum()
        loss.backward()
        return [outs, v, s, x.grad]

    r, p = both(run)
    assert_same(r, p)
    x = arr(P, [0.5, 1.5])
    taken = _while_loop(lambda v, s: s.sum() < 20.0,
                        lambda v, s: ([], (v * 1.5, s + v * v)), [x, x * 2],
                        6)[3]
    steps = sum(1 for row in r[0] if np.any(row != 0))
    assert int(taken) == steps == 3


def test_cond():
    def run(mx):
        x, y = arr(mx, [2.0]), arr(mx, [3.0])
        return [mx.nd.contrib.cond(x < y, lambda a, b: a + b,
                                   lambda a, b: a - b, [x, y]),
                mx.nd.contrib.cond(x > y, lambda a, b: a + b,
                                   lambda a, b: a - b, [x, y])]

    r, p = both(run)
    assert_same(r, p)
    assert float(p[0][0]) == 5.0 and float(p[1][0]) == -1.0


@pytest.mark.parametrize("take_then", [True, False])
def test_cond_gradients_match_lax_cond(take_then):
    """Both branches run and ``where`` selects: the gradient reaches the
    inputs only through the branch taken, as ``lax.cond``'s."""
    def run(mx):
        x, y = arr(mx, [2.0, -1.0]), arr(mx, [3.0, 0.5])
        x.attach_grad()
        y.attach_grad()
        pred = arr(mx, [1.0 if take_then else 0.0])
        with mx.autograd.record():
            out = mx.nd.contrib.cond(pred, lambda a, b: [a * b, a + b],
                                     lambda a, b: [a * a, b * 3], [x, y])
            loss = (out[0] * out[1]).sum()
        loss.backward()
        return [out, x.grad, y.grad]

    r, p = both(run)
    assert_same(r, p)


def scanner(mx):
    class Scanner(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            outs, final = mx.nd.contrib.foreach(
                lambda xt, s: (s + xt, s + xt), x,
                mx.nd.zeros((x.shape[1],)))
            return final
    return Scanner()


def test_foreach_in_hybridized_block():
    def run(mx):
        net = scanner(mx)
        net.initialize()
        net.hybridize()
        return [net(arr(mx, np.ones((3, 4)))),
                net(arr(mx, np.ones((3, 4)) * 2))]

    r, p = both(run)
    assert_same(r, p)
    np.testing.assert_allclose(p[0], np.full((4,), 3.0))
    np.testing.assert_allclose(p[1], np.full((4,), 6.0))


class Loops(P.gluon.HybridBlock):
    """All three constructs in one block: a foreach over the rows, a
    while loop bounded at 6 steps and a cond on the data's sign."""

    def hybrid_forward(self, F, x):
        outs, h = P.nd.contrib.foreach(
            lambda xt, s: (F.tanh(xt + s), F.tanh(xt + s)), x,
            F.zeros_like(x[0]))
        w_outs, (v, s) = P.nd.contrib.while_loop(
            lambda v, s: s.sum() < 4.0,
            lambda v, s: (v * 2, (v * 1.1, s + F.abs(v))), [h, h * 0],
            max_iterations=6)
        c = P.nd.contrib.cond(x.sum() > 0, lambda a: a * 3,
                              lambda a: a - 1, [v])
        return outs, w_outs, s, c


def loops_run(net, xs, ctx, recording):
    """The block's outputs and the input gradient for each input."""
    res = []
    for x_np in xs:
        x = arr(P, x_np, ctx)
        x.attach_grad()
        with P.autograd.record() if recording else P.autograd.pause():
            outs = net(x)
            loss = sum((o * o).sum() for o in outs)
        if recording:
            loss.backward()
        res.append([o.asnumpy() for o in outs]
                   + ([x.grad.asnumpy()] if recording else []))
    return res


LOOP_INPUTS = [np.random.RandomState(s).randn(4, 3).astype(np.float32)
               * (1 if s % 2 else -1) for s in range(3)]


@pytest.mark.parametrize("recording", [False, True])
def test_constructs_hybridized_equal_eager(recording):
    eager = loops_run(Loops(), LOOP_INPUTS, P.cpu(), recording)
    net = Loops()
    net.hybridize()
    hyb = loops_run(net, LOOP_INPUTS, P.cpu(), recording)
    for a, b in zip(eager, hyb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("recording", [False, True])
def test_card_replay_equals_eager(recording, cuda_device):
    """On the card the hybridized block's forward (and, recording, its
    backward) replay CUDA graphs: bit for bit the block run op by op,
    and within the CPU test's limits of the CPU."""
    ctx = P.gpu(0)
    eager = loops_run(Loops(), LOOP_INPUTS, ctx, recording)
    net = Loops()
    net.hybridize()
    hyb = loops_run(net, LOOP_INPUTS, ctx, recording)
    cpu = loops_run(Loops(), LOOP_INPUTS, P.cpu(), recording)
    for a, b, c in zip(eager, hyb, cpu):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_allclose(x, z, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cond_reads_nothing_back_on_the_card(cuda_device):
    x = arr(P, [2.0], P.gpu(0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = P.nd.contrib.cond(x > 1, lambda a: a * 3, lambda a: a - 1,
                                [x])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(out.asscalar()) == 6.0
