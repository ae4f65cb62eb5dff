"""The port's fused ``RNN`` op (``mxnet_tpu_torch/ops/rnn_op.py``) and
``_rnn_nostate`` against the reference's (``mxnet_tpu/ops/rnn_op.py``).

Each of 4 modes x {1, 2} layers x {uni-, bidirectional}, with initial
states (``RNN``) and without (``_rnn_nostate``), goes through the
reference's op function (``jax.vjp`` under ``jax.jit``) and the port's
``nd`` op (``mx.cpu()``, torch autograd) from the same numpy inputs:
every output (sequence, h_N, c_N) within 1e-6 + 1e-5 x |ref| and the
gradients of the data, the flat parameters and the states, with one
random head gradient for each output, within 4e-6 + 4e-5 x |ref| (the
``transc`` family of ``_torch_port.TOL`` and its gradient limit;
measured worst over the 32 cases: 0.26 of the limit, 6.7e-6 absolute in
a gradient).  ``OP_SPECS["rnn_op"]`` runs through the shared op checks
(reference's ``nd``, finite differences, aliases), which the coverage
test and the card sweep read.

Dropout (between layers only, in training): at ``p = 0`` in training
and at ``p > 0`` outside it the port equals the reference; at ``p > 0``
in training a one-layer op is unchanged and a two-layer one equals its
first layer, the mask drawn from the same generator, then its second
layer, bit for bit.  ``mx.sym.RNN`` binds and runs through each
package's executor (forward and backward) on the case of
``tests/test_onnx_rnn.py``.  The ``cuda`` tests (skipped without a
card) run the op on the card against the CPU, forward and backward.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
import _torch_port as T
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
CASES = [(m, L, bi, st) for m in MODES for L in (1, 2) for bi in (False, True)
         for st in (True, False)]
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=4e-5, atol=4e-6)
SPECS = T.OP_SPECS["rnn_op"]
FD = [s for s in SPECS if T.fd_case(s)]


def case_id(c):
    m, L, bi, st = c
    return "%s-L%d-%s-%s" % (m, L, "bi" if bi else "uni",
                             "states" if st else "nostate")


def inputs(mode, L, bi, with_states, seed=0):
    """(arrays, attrs, head gradients) of one case."""
    Tn, N, I, H = T.RNN_SHAPE
    D = 2 if bi else 1
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(Tn, N, I).astype(np.float32),
              rng.uniform(-0.6, 0.6, T.rnn_param_size(mode, L, I, H, bi))
              .astype(np.float32)]
    if with_states:
        arrays += [rng.randn(L * D, N, H).astype(np.float32)
                   for _ in range(2 if mode == "lstm" else 1)]
    n_out = 3 if mode == "lstm" else 2
    heads = [rng.randn(*s).astype(np.float32)
             for s in [(Tn, N, H * D), (L * D, N, H), (L * D, N, H)][:n_out]]
    attrs = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bi)
    return arrays, attrs, heads


def reference_vjp(arrays, attrs, heads, with_states):
    """The reference's op function: (outputs, gradients of arrays)."""
    import jax
    from mxnet_tpu.ops import rnn_op

    def f(*xs):
        if with_states:
            return rnn_op.rnn(None, *xs, **attrs)
        return rnn_op.rnn_nostate(None, *xs, **attrs)

    @jax.jit
    def both(xs, hs):
        outs, vjp = jax.vjp(f, *xs)
        return outs, vjp(tuple(hs))

    outs, grads = both(arrays, heads)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def port_vjp(arrays, attrs, heads, with_states, ctx=None, **extra):
    """The port's ``nd`` op under autograd: (outputs, gradients)."""
    ctx = ctx or P.cpu()
    xs = [P.nd.array(a, ctx=ctx) for a in arrays]
    for x in xs:
        x.attach_grad()
    fn = P.nd.RNN if with_states else P.nd._rnn_nostate
    with P.autograd.record():
        outs = fn(*xs, **attrs, **extra)
    P.autograd.backward(list(outs), [P.nd.array(h, ctx=ctx) for h in heads])
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_outputs_and_gradients_match_the_reference(case):
    mode, L, bi, st = case
    arrays, attrs, heads = inputs(mode, L, bi, st)
    r_outs, r_grads = reference_vjp(arrays, attrs, heads, st)
    p_outs, p_grads = port_vjp(arrays, attrs, heads, st)
    assert len(p_outs) == len(r_outs) == (3 if mode == "lstm" else 2)
    for k, (p, r) in enumerate(zip(p_outs, r_outs)):
        assert p.shape == r.shape, (k, p.shape, r.shape)
        np.testing.assert_allclose(p, r, err_msg="output %d" % k,
                                   **OUT_TOL)
    for k, (p, r) in enumerate(zip(p_grads, r_grads)):
        np.testing.assert_allclose(p, r, err_msg="gradient %d" % k,
                                   **GRAD_TOL)


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_op_spec_against_reference(spec):
    T.check_against_reference(spec)


@pytest.mark.parametrize("spec", FD, ids=repr)
def test_gradient_against_finite_differences(spec):
    T.check_finite_differences(spec)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("L", [1, 2])
def test_param_size_matches_the_reference(mode, L, bi):
    from mxnet_tpu.ops.rnn_op import rnn_param_size as ref_size
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    for I, H in ((4, 6), (650, 650), (3, 1)):
        assert rnn_param_size(mode, L, I, H, bi) == ref_size(mode, L, I, H,
                                                             bi)


def test_dropout_off_equals_the_reference():
    """``p = 0`` in training, and ``p = 0.5`` outside it: the
    reference's result."""
    arrays, attrs, heads = inputs("lstm", 2, True, True, seed=3)
    r_outs, r_grads = reference_vjp(arrays, attrs, heads, True)
    for p, training in ((0.0, True), (0.5, False)):
        xs = [P.nd.array(a, ctx=P.cpu()) for a in arrays]
        with P.autograd.record(train_mode=training):
            outs = P.nd.RNN(*xs, p=p, **attrs)
        for o, r in zip(outs, r_outs):
            np.testing.assert_allclose(o.asnumpy(), r, **OUT_TOL)
        p_outs, p_grads = port_vjp(arrays, attrs, heads, True, p=p,
                                   _training=training)
        for g, r in zip(p_grads, r_grads):
            np.testing.assert_allclose(g, r, **GRAD_TOL)


def _op(xs, gen, **attrs):
    from mxnet_tpu_torch.ops.rnn_op import rnn
    return rnn(gen, *[torch.from_numpy(a) for a in xs], **attrs)


def test_dropout_applies_between_layers_only():
    """In training at ``p = 0.5``: one layer is unchanged; two layers are
    layer 1, the keep mask drawn from the same generator with scaling
    ``1 / (1 - p)``, then layer 2, bit for bit."""
    Tn, N, I, H = T.RNN_SHAPE
    p = 0.5
    arrays, attrs, _ = inputs("gru", 1, True, True, seed=4)
    plain = _op(arrays, None, **attrs)
    dropped = _op(arrays, torch.Generator().manual_seed(1), p=p,
                  _training=True, **attrs)
    for a, b in zip(plain, dropped):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    arrays, attrs, _ = inputs("lstm", 2, True, True, seed=5)
    x, w, h, c = arrays
    D, n1 = 2, T.rnn_param_size("lstm", 1, I, H, True)
    n2 = T.rnn_param_size("lstm", 1, 2 * H, H, True)
    wt, bias_off = 4 * H * (I + H) * D, 4 * H * (I + H) * D + 4 * H * (
        2 * H + H) * D
    # each layer's own flat vector: its weights, then its biases
    w1 = np.concatenate([w[:wt], w[bias_off:bias_off + 8 * H * D]])
    w2 = np.concatenate([w[wt:bias_off], w[bias_off + 8 * H * D:]])
    assert w1.size == n1 and w2.size == n2
    one = dict(attrs, num_layers=1)
    first = _op([x, w1, h[:2], c[:2]], None, **one)
    keep = torch.rand(first[0].shape,
                      generator=torch.Generator().manual_seed(7)) < 1 - p
    y1 = torch.where(keep, first[0] / (1 - p), 0.0)
    second = _op([y1.numpy(), w2, h[2:], c[2:]], None, **one)
    got = _op(arrays, torch.Generator().manual_seed(7), p=p, _training=True,
              **attrs)
    want = [second[0]] + [torch.cat([a, b])
                          for a, b in zip(first[1:], second[1:])]
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, rtol=0, atol=0)


def _onnx_case(mx, mode, L, bi):
    """tests/test_onnx_rnn.py's ``_rnn_case``, in package ``mx``."""
    x = mx.sym.Variable("data")
    p = mx.sym.Variable("rnn_params")
    args = [x, p, mx.sym.Variable("state")]
    if mode == "lstm":
        args.append(mx.sym.Variable("state_cell"))
    out = mx.sym.RNN(*args, state_size=6, num_layers=L, mode=mode,
                     bidirectional=bi, state_outputs=True, name="rnn0")
    return out[0]


@pytest.mark.parametrize("mode,L,bi", [("lstm", 2, True), ("gru", 1, False),
                                       ("rnn_tanh", 2, False)])
def test_symbol_rnn_through_the_executor(mode, L, bi):
    Tn, N, I, H = 5, 3, 4, 6
    D = 2 if bi else 1
    rng = np.random.RandomState(0)
    values = {"data": rng.rand(Tn, N, I).astype(np.float32),
              "rnn_params": ((rng.rand(T.rnn_param_size(mode, L, I, H, bi))
                              - 0.5) * 0.4).astype(np.float32),
              "state": 0.1 * rng.randn(L * D, N, H).astype(np.float32)}
    if mode == "lstm":
        values["state_cell"] = 0.1 * rng.randn(L * D, N, H).astype(
            np.float32)
    head = rng.randn(Tn, N, H * D).astype(np.float32)
    res = []
    for mx in (R, P):
        y = _onnx_case(mx, mode, L, bi)
        assert y.list_arguments() == list(values)
        kw = {"ctx": mx.cpu()} if mx is P else {}
        args = {k: mx.nd.array(v, **kw) for k, v in values.items()}
        ex = y.bind(mx.cpu(), args, grad_req="write")
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(mx.nd.array(head, **kw))
        res.append((out, {k: g.asnumpy() for k, g in ex.grad_dict.items()}))
    (r_out, r_grads), (p_out, p_grads) = res
    np.testing.assert_allclose(p_out, r_out, **OUT_TOL)
    assert set(p_grads) == set(r_grads)
    for k in r_grads:
        np.testing.assert_allclose(p_grads[k], r_grads[k], err_msg=k,
                                   **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_card_against_cpu(case, cuda_device):
    """The op on the card against the CPU, TF32 off (cuBLAS's sums in
    another order): outputs and gradients within the CPU test's
    limits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mode, L, bi, st = case
    arrays, attrs, heads = inputs(mode, L, bi, st)
    c_outs, c_grads = port_vjp(arrays, attrs, heads, st)
    g_outs, g_grads = port_vjp(arrays, attrs, heads, st, ctx=P.gpu(0))
    for g, c in zip(g_outs + g_grads, c_outs + c_grads):
        np.testing.assert_allclose(g, c, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_op_spec_card_against_cpu(spec, cuda_device):
    T.check_on_card(spec)
