"""The port's bound ``Executor`` and its new ops (``SoftmaxOutput``,
``Embedding``, ``Dropout``, the unary and power ops) against the
reference's, on the CPU.

Both executors get the same numpy arguments.  Tolerances (f32): outputs
and gradients within 1e-6 + 1e-5 x |reference| (the reference jit-
compiles its graph, so XLA may fuse and reorder f32 sums; the port runs
op by op); ``SoftmaxOutput``'s gradient, one parametrised test over
``normalization``, ``use_ignore``, ``multi_output``, ``preserve_shape``
and ``smooth_alpha``, within 1e-7 + 1e-6 x |reference| (one softmax and
a few elementwise ops).  Dropout's keep mask cannot follow the
reference's ``jax.random`` stream: its graphs are held at ``p = 0``,
and at ``p = 0.5`` by the keep rate (within 0.02 of 0.5 over 40 000
values) and the ``1 / keep`` scaling (exact).

The ``cuda`` test (skipped without a card) holds an executor replaying
its CUDA graphs bit for bit against the same executor with ``_eager``
over three SGD-momentum update steps, the arguments written in place
between steps, reading outputs before ``backward`` on the second step.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P

from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

TOL = dict(rtol=1e-5, atol=1e-6)


def _nd(mx, a, ctx=None):
    ctx = ctx or mx.cpu()
    return mx.nd.array(a, ctx=ctx) if mx is P else mx.nd.array(a)


def bind_both(build, values, grad_req="write", aux=None):
    """``build(mx)``'s symbol bound in each package to the same numpy
    ``values`` (and ``aux``)."""
    out = []
    for mx in (R, P):
        with mx.name.NameManager():
            sym = build(mx)
        args = {k: _nd(mx, v) for k, v in values.items()}
        auxs = None if aux is None else {k: _nd(mx, v)
                                         for k, v in aux.items()}
        out.append(sym.bind(mx.cpu(), args, grad_req=grad_req,
                            aux_states=auxs))
    return out


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=5, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax", normalization="batch")


def mlp_values(seed=0, batch=6):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(batch, 8).astype(np.float32),
            "fc1_weight": (0.3 * rng.randn(16, 8)).astype(np.float32),
            "fc1_bias": (0.1 * rng.randn(16)).astype(np.float32),
            "fc2_weight": (0.3 * rng.randn(5, 16)).astype(np.float32),
            "fc2_bias": (0.1 * rng.randn(5)).astype(np.float32),
            "softmax_label": rng.randint(0, 5, batch).astype(np.float32)}


def test_forward_backward_match_the_reference():
    re, pe = bind_both(mlp, mlp_values())
    for e in (re, pe):
        e.forward(is_train=True)
        e.backward()
    close(pe.outputs[0].asnumpy(), re.outputs[0].asnumpy())
    assert sorted(pe.grad_dict) == sorted(re.grad_dict)
    for k in re.grad_dict:
        close(pe.grad_dict[k].asnumpy(), re.grad_dict[k].asnumpy())
    # inference forward
    ri, pi = (e.forward(is_train=False)[0].asnumpy() for e in (re, pe))
    close(pi, ri)


def test_head_gradient_seed_and_out_grads():
    """A loss head gets ones by default; explicit ``out_grads`` scale
    the gradient of a plain graph (the reference's vjp seed)."""
    def build(mx):
        x = mx.sym.Variable("x")
        w = mx.sym.Variable("w")
        return mx.sym.sum(x * w) + mx.sym.exp(w)

    rng = np.random.RandomState(1)
    vals = {"x": rng.randn(3, 4).astype(np.float32),
            "w": rng.randn(3, 4).astype(np.float32)}
    og = rng.randn(3, 4).astype(np.float32)
    for out_grads in (None, og):
        re, pe = bind_both(build, vals)
        re.forward(is_train=True)
        pe.forward(is_train=True)
        re.backward(None if out_grads is None else [R.nd.array(og)])
        pe.backward(None if out_grads is None
                    else [P.nd.array(og, ctx=P.cpu())])
        for k in ("x", "w"):
            close(pe.grad_dict[k].asnumpy(), re.grad_dict[k].asnumpy())


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    def build(mx):
        return mx.sym.sum(mx.sym.Variable("data") * mx.sym.Variable("w"))

    vals = {"data": np.arange(6, dtype=np.float32).reshape(2, 3),
            "w": np.ones((2, 3), np.float32)}
    reqs = {"data": "null", "w": req}
    re, pe = bind_both(build, vals, grad_req=reqs)
    for _ in range(2):
        for e in (re, pe):
            e.forward(is_train=True)
            e.backward()
    assert sorted(pe.grad_dict) == sorted(re.grad_dict)
    assert "data" not in pe.grad_dict
    if req != "null":
        close(pe.grad_dict["w"].asnumpy(), re.grad_dict["w"].asnumpy())
        want = vals["data"] * (2 if req == "add" else 1)
        close(pe.grad_dict["w"].asnumpy(), want)
    else:
        assert "w" not in pe.grad_dict


def _bn(mx):
    return mx.sym.BatchNorm(mx.sym.Variable("data"), name="bn0",
                            momentum=0.5)


def test_batchnorm_aux_moves_in_training_only():
    rng = np.random.RandomState(2)
    x = (rng.randn(16, 4) * 3 + 1).astype(np.float32)
    vals = {"data": x, "bn0_gamma": np.ones(4, np.float32),
            "bn0_beta": np.zeros(4, np.float32)}
    aux = {"bn0_moving_mean": np.zeros(4, np.float32),
           "bn0_moving_var": np.ones(4, np.float32)}
    re, pe = bind_both(_bn, vals, aux=aux)
    for e in (re, pe):
        e.forward(is_train=True)
        e.backward()
    for k in aux:
        close(pe.aux_dict[k].asnumpy(), re.aux_dict[k].asnumpy())
    mm = pe.aux_dict["bn0_moving_mean"].asnumpy()
    close(mm, 0.5 * x.mean(0), rtol=1e-5, atol=1e-6)
    before = {k: pe.aux_dict[k].asnumpy() for k in aux}
    pe.forward(is_train=False)
    for k in aux:
        np.testing.assert_array_equal(pe.aux_dict[k].asnumpy(), before[k])
    # simple_bind allocates what the graph needs on the given context
    exe = _bn(P).simple_bind(ctx=P.cpu(), data=(16, 4))
    assert exe.aux_dict["bn0_moving_var"].shape == (4,)
    assert exe.arg_dict["bn0_gamma"].context == P.cpu()


def test_lazy_outputs_before_backward():
    """Reading outputs after ``forward(is_train=True)`` runs the training
    forward, which moves the aux states; ``backward`` starts again from
    the aux states as they were at ``forward``: the aux states move
    exactly once, to the reference's values."""
    rng = np.random.RandomState(3)
    vals = {"data": (rng.randn(8, 4) + 2).astype(np.float32),
            "bn0_gamma": np.ones(4, np.float32),
            "bn0_beta": np.zeros(4, np.float32)}
    aux = {"bn0_moving_mean": np.zeros(4, np.float32),
           "bn0_moving_var": np.ones(4, np.float32)}
    re, pe = bind_both(lambda mx: mx.sym.sum(_bn(mx)), vals, aux=aux)
    outs = {}
    for name, e in (("ref", re), ("port", pe)):
        lazy = e.forward(is_train=True)
        outs[name] = lazy[0].asnumpy()          # forces the forward
        e.backward()
    close(outs["port"], outs["ref"])
    for k in aux:
        close(pe.aux_dict[k].asnumpy(), re.aux_dict[k].asnumpy())
    close(pe.aux_dict["bn0_moving_mean"].asnumpy(),
          0.5 * vals["data"].mean(0))
    close(pe.grad_dict["data"].asnumpy(), re.grad_dict["data"].asnumpy())
    with pytest.raises(P.MXNetError, match="before forward"):
        pe.backward()


def test_copy_params_from_reshape_and_group2ctx():
    re, pe = bind_both(mlp, mlp_values())
    new = mlp_values(seed=5)
    params = {k: v for k, v in new.items() if "fc" in k}
    re.copy_params_from({k: R.nd.array(v) for k, v in params.items()})
    pe.copy_params_from({k: P.nd.array(v, ctx=P.cpu())
                         for k, v in params.items()})
    with pytest.raises(P.MXNetError, match="unknown parameter"):
        pe.copy_params_from({"nope": np.zeros(1)})
    close(pe.forward()[0].asnumpy(), re.forward()[0].asnumpy())
    pe.reshape(data=(3, 8), softmax_label=(3,))
    re.reshape(data=(3, 8), softmax_label=(3,))
    assert pe.arg_dict["data"].shape == (3, 8)
    v = mlp_values(seed=6, batch=3)
    feeds = {"data": v["data"], "softmax_label": v["softmax_label"]}
    got = pe.forward(**{k: P.nd.array(a, ctx=P.cpu())
                        for k, a in feeds.items()})[0].asnumpy()
    want = re.forward(**{k: R.nd.array(a)
                         for k, a in feeds.items()})[0].asnumpy()
    close(got, want)
    # group2ctx (manual placement) runs the walk op by op
    with P.name.NameManager():
        with P.AttrScope(ctx_group="dev1"):
            sym = mlp(P)
    args = {k: P.nd.array(a, ctx=P.cpu()) for k, a in mlp_values().items()}
    exe = sym.bind(P.cpu(), args, group2ctx={"dev1": P.cpu()})
    exe.forward(is_train=True)
    exe.backward()
    close(exe.outputs[0].asnumpy(), bind_both(mlp, mlp_values())[0]
          .forward()[0].asnumpy())


def test_default_context_is_the_card():
    sym = mlp(P)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sym.simple_bind(data=(2, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.mod.Module(sym)
    with pytest.raises(NotImplementedError, match="A.7"):
        P.mod.Module(sym, context=[P.cpu(), P.cpu()])


SOFTMAX_CASES = [
    dict(normalization=n, use_ignore=u, multi_output=m,
         preserve_shape=ps, smooth_alpha=a, grad_scale=g)
    for n, u, m, ps, a, g in [
        ("null", False, False, False, 0.0, 1.0),
        ("batch", False, False, False, 0.0, 2.0),
        ("valid", False, False, False, 0.0, 1.0),
        ("valid", True, False, False, 0.0, 1.0),
        ("null", True, False, False, 0.1, 0.5),
        ("batch", False, True, False, 0.0, 1.0),
        ("valid", True, True, False, 0.0, 1.0),
        ("valid", False, False, True, 0.0, 1.0),
        ("valid", True, False, True, 0.2, 1.0),
    ]]


@pytest.mark.parametrize("kw", SOFTMAX_CASES,
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_softmax_output_gradient(kw):
    """The fused gradient ``(p - onehot) * scale`` of every option,
    including labels at ``ignore_label`` (-1), against the reference's
    custom VJP; the head gradient is ignored."""
    rng = np.random.RandomState(4)
    if kw["multi_output"]:
        shape, lshape = (4, 5, 3), (4, 3)
    elif kw["preserve_shape"]:
        shape, lshape = (4, 3, 5), (4, 3)
    else:
        shape, lshape = (6, 5), (6,)
    x = rng.randn(*shape).astype(np.float32)
    label = rng.randint(0, 5, lshape).astype(np.float32)
    label.reshape(-1)[::4] = -1.0
    og = rng.randn(*shape).astype(np.float32)

    def build(mx):
        return mx.sym.SoftmaxOutput(mx.sym.Variable("x"), name="softmax",
                                    **kw)

    re, pe = bind_both(build, {"x": x, "softmax_label": label},
                       grad_req={"x": "write"})
    re.forward(is_train=True)
    re.backward([R.nd.array(og)])
    pe.forward(is_train=True)
    pe.backward([P.nd.array(og, ctx=P.cpu())])
    close(pe.outputs[0].asnumpy(), re.outputs[0].asnumpy(),
          rtol=1e-6, atol=1e-7)
    close(pe.grad_dict["x"].asnumpy(), re.grad_dict["x"].asnumpy(),
          rtol=1e-6, atol=1e-7)


def test_embedding_and_unary_ops_match():
    def build(mx):
        emb = mx.sym.Embedding(mx.sym.Variable("idx"), input_dim=7,
                               output_dim=3, name="emb")
        y = mx.sym.relu(emb) + mx.sym.sigmoid(emb) * mx.sym.tanh(emb)
        y = y + mx.sym.sqrt(mx.sym.abs(emb) + 1) + mx.sym.log(
            mx.sym.exp(emb) + 1) + emb ** 2
        return mx.sym.sum(y)

    rng = np.random.RandomState(5)
    vals = {"idx": rng.randint(0, 7, (4, 5)).astype(np.float32),
            "emb_weight": rng.randn(7, 3).astype(np.float32)}
    re, pe = bind_both(build, vals, grad_req={"emb_weight": "write"})
    for e in (re, pe):
        e.forward(is_train=True)
        e.backward()
    close(pe.outputs[0].asnumpy(), re.outputs[0].asnumpy())
    close(pe.grad_dict["emb_weight"].asnumpy(),
          re.grad_dict["emb_weight"].asnumpy())


def test_dropout():
    def build(mx, p):
        return mx.sym.Dropout(mx.sym.Variable("x"), p=p, name="drop")

    x = np.random.RandomState(6).rand(200, 200).astype(np.float32) + 1
    # p = 0: the identity in both packages, training or not
    re, pe = bind_both(lambda mx: build(mx, 0.0), {"x": x})
    for e in (re, pe):
        e.forward(is_train=True)
        e.backward()
    np.testing.assert_array_equal(pe.outputs[0].asnumpy(), x)
    np.testing.assert_array_equal(pe.grad_dict["x"].asnumpy(),
                                  re.grad_dict["x"].asnumpy())
    # p = 0.5: the keep rate and the 1/keep scaling; the gradient is the
    # same mask scaled; inference is the identity
    with P.name.NameManager():
        exe = build(P, 0.5).bind(P.cpu(), {"x": P.nd.array(x, ctx=P.cpu())})
    exe.forward(is_train=True)
    exe.backward()
    out = exe.outputs[0].asnumpy()
    kept = out != 0
    assert abs(kept.mean() - 0.5) < 0.02
    np.testing.assert_array_equal(out[kept], x[kept] * 2.0)
    np.testing.assert_array_equal(exe.grad_dict["x"].asnumpy(),
                                  kept * np.float32(2.0))
    np.testing.assert_array_equal(exe.forward()[0].asnumpy(), x)
    # a second step draws a new mask from the node's generator
    exe.forward(is_train=True)
    exe.backward()
    assert not np.array_equal(exe.outputs[0].asnumpy() != 0, kept)
    # imperative nd.Dropout draws from torch's default generator
    with P.autograd.train_mode():
        y = P.nd.Dropout(P.nd.array(x, ctx=P.cpu()), p=0.5).asnumpy()
    assert abs((y != 0).mean() - 0.5) < 0.02


@pytest.mark.cuda
def test_captured_executor_equals_eager(cuda_device):
    """Three SGD-momentum steps through an executor replaying its CUDA
    graphs against the same steps with ``_eager``, from the same state:
    outputs, arguments, gradients and aux states bit for bit.  The
    second step reads the outputs before ``backward`` (the training
    forward, then the fused step from the kept aux states); the data is
    written in place before each step."""
    ctx = P.gpu(0)
    rng = np.random.RandomState(7)
    vals = {"fc2_weight": (0.3 * rng.randn(5, 8)).astype(np.float32),
            "fc2_bias": (0.1 * rng.randn(5)).astype(np.float32),
            "softmax_label": rng.randint(0, 5, 6).astype(np.float32)}
    feeds = [rng.randn(6, 8).astype(np.float32) for _ in range(3)]

    def build(mx):
        return mx.sym.SoftmaxOutput(
            mx.sym.BatchNorm(mx.sym.FullyConnected(
                mx.sym.Variable("data"), num_hidden=5, name="fc2"),
                name="bn"), name="softmax", normalization="batch")

    runs = []
    for eager in (True, False):
        with P.name.NameManager():
            sym = build(P)
        exe = sym.simple_bind(ctx=ctx, data=(6, 8))
        for k in ("fc2_weight", "fc2_bias", "softmax_label"):
            exe.arg_dict[k]._set_data(torch.from_numpy(vals[k]).to(
                cuda_device))
        exe.arg_dict["bn_gamma"]._data.fill_(1.0)
        exe.aux_dict["bn_moving_var"]._data.fill_(1.0)
        exe._eager = eager
        opt = P.optimizer.SGD(learning_rate=0.1, momentum=0.9)
        states = {k: opt.create_state(i, exe.arg_dict[k])
                  for i, k in enumerate(exe.arg_names)
                  if k in exe.grad_dict}
        outs = []
        for step, x in enumerate(feeds):
            lazy = exe.forward(is_train=True,
                               data=P.nd.array(x, ctx=ctx))
            if step == 1:
                outs.append(lazy[0].asnumpy())
            exe.backward()
            outs.append(exe.outputs[0].asnumpy())
            for i, k in enumerate(exe.arg_names):
                if k in states and k != "data":
                    opt.update(i, exe.arg_dict[k], exe.grad_dict[k],
                               states[k])
        runs.append((outs, [a.asnumpy() for d in (
            exe.arg_dict, exe.grad_dict, exe.aux_dict)
            for a in d.values()]))
        if not eager:
            assert len(exe._programs) == 2      # fwd_bwd and train
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        np.testing.assert_array_equal(a, b)
