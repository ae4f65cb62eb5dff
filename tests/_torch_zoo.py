"""Shared parity check of a vision-zoo family: the port's net against
the reference's, weights carried across by structural name.

``family_parity`` builds the net in both packages with Dropout rates
set to 0, initializes the reference with Xavier (shapes resolved by
one predict-mode forward) and writes its weights into the port's, then
holds, on the same seeded batch: the predict-mode outputs, the
train-mode outputs (BatchNorm on batch statistics) and, after one
``gluon.Trainer`` SGD step (lr 0.01, momentum 0.9, wd 1e-4) on the
softmax cross-entropy of those outputs, every parameter and running
statistic.  Outputs must agree within ``1e-5 * max|ref|``; the state
after the step within 1e-6, as ``test_torch_gluon.py`` holds ResNet-18
after its first step (f32 summation order).

The reference runs hybridized (one XLA program each for its forward
and backward): op by op, its tape's backward took 40-190 s a family on
the CPU.  Where a family stacks 50 or more BatchNorms and the batch is
one or two images (MobileNet v2, Inception v3), f32 rounding in the
train-mode BatchNorms grows past those limits in both packages: on
``mobilenetv2_0.25`` at 128 x 128, batch 2, the reference's train-mode
outputs lay 3.4e-5 and the port's 1.6e-5 from a float64 run of the port
on the same weights (max|out| 1.5), and the first conv's gradient
(max 61) 1.1e-2 and 2.4e-3 of its scale from it.  Those families hold
their train-mode outputs at ``1e-4 * max|ref|`` and take the step with
BatchNorm on its running statistics (``step_train=False``), where the
backward is well conditioned and the 1e-6 limit holds.  A running
statistic is 0.9 of its old value and 0.1 of a batch statistic, so it
is held at the state's limit plus ``train_tol`` of that batch part.  Imports no JAX
at the top: the reference is imported inside the call.
"""
import numpy as np

LR, MOMENTUM, WD = 0.01, 0.9, 1e-4
CLASSES = 10


def no_dropout(net):
    """Set every Dropout rate of ``net`` to 0 (``Block.apply``)."""
    def zero(block):
        if type(block).__name__ == "Dropout":
            block._rate = 0.0
    return net.apply(zero)


def _state(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


def family_parity(make, batch, size, seed=0, train_tol=1e-5,
                  step_train=True, state_tol=1e-6):
    """``make(pkg)`` builds the family's net in package ``pkg``; the
    batch is ``(batch, 3, size, size)`` uniform in [0, 1) with labels
    in ``range(CLASSES)``.  ``train_tol`` is the train-mode outputs'
    limit (a fraction of ``max|ref|``); ``step_train=False`` takes the
    SGD step with BatchNorm on its running statistics, after a separate
    train-mode forward; ``state_tol`` is the absolute limit on the
    state after the step.  Returns the port's net."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import set_block_params

    rng = np.random.RandomState(seed)
    x = rng.rand(batch, 3, size, size).astype(np.float32)
    y = rng.randint(0, CLASSES, batch).astype(np.float32)
    np.random.seed(seed)
    ref = no_dropout(make(jmx))
    ref.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    ref.hybridize()             # one XLA program: the eager tape is slow
    want_pred = ref(jmx.nd.array(x)).asnumpy()
    net = no_dropout(make(mx))
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    set_block_params(net, _state(ref), ctx=mx.cpu())
    got_pred = net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    assert got_pred.shape == want_pred.shape == (batch, CLASSES)
    _close(got_pred, want_pred, "predict-mode output")

    start = _state(ref)
    outs = []
    for pkg, block, ctx in ((jmx, ref, jmx.cpu()), (mx, net, mx.cpu())):
        X, Y = pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx)
        if not step_train:
            with pkg.autograd.train_mode():
                outs.append(block(X).asnumpy())
        trainer = pkg.gluon.Trainer(block.collect_params(), "sgd", {
            "learning_rate": LR, "momentum": MOMENTUM, "wd": WD})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record(train_mode=step_train):
            out = block(X)
            loss = loss_fn(out, Y)
        loss.backward()
        trainer.step(batch)
        if step_train:
            outs.append(out.asnumpy())
    _close(outs[1], outs[0], "train-mode output", train_tol)
    want, got = _state(ref), _state(net)
    assert sorted(got) == sorted(want)
    for k in want:
        atol = state_tol
        if k.endswith(("running_mean", "running_var")):
            # 0.9 of the old value plus 0.1 of a batch statistic, whose
            # error is bounded like the train-mode outputs'
            atol += train_tol * np.abs(want[k] - 0.9 * start[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    return net

def predict_parity(make, batch, size, seed=0):
    """Only the predict-mode outputs of ``family_parity``, the reference
    op by op (for a family too deep for its full check here)."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import set_block_params

    x = np.random.RandomState(seed).rand(batch, 3, size, size) \
        .astype(np.float32)
    np.random.seed(seed)
    ref = make(jmx)
    ref.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    want = ref(jmx.nd.array(x)).asnumpy()
    net = make(mx)
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    set_block_params(net, _state(ref), ctx=mx.cpu())
    got = net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    assert got.shape == want.shape == (batch, CLASSES)
    _close(got, want, "predict-mode output")


def _rnd(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# Every layer of ``gluon/nn/conv_layers.py`` the port gained in this
# slice, with in != out channels, groups > 1, strides, dilations,
# output_padding, ceil_mode and count_include_pad=False among the
# cases: name -> (make(pkg), input, CARD_TOL family on the card).
CONV_CASES = {
    "Conv1D": (lambda pkg: pkg.gluon.nn.Conv1D(
        6, 3, strides=2, padding=1, dilation=2, groups=2),
        _rnd(2, 4, 11), "reduce"),
    "Conv1D_relu": (lambda pkg: pkg.gluon.nn.Conv1D(
        5, 2, activation="relu", in_channels=3), _rnd(2, 3, 9), "reduce"),
    "Conv3D": (lambda pkg: pkg.gluon.nn.Conv3D(
        4, (2, 3, 3), strides=(1, 2, 1), padding=(0, 1, 1), groups=2),
        _rnd(2, 6, 4, 6, 5), "reduce"),
    "Conv1DTranspose": (lambda pkg: pkg.gluon.nn.Conv1DTranspose(
        6, 3, strides=2, padding=1, output_padding=1, groups=2),
        _rnd(2, 4, 7), "reduce"),
    "Conv2DTranspose": (lambda pkg: pkg.gluon.nn.Conv2DTranspose(
        6, (3, 2), strides=(2, 3), padding=(1, 0), output_padding=(1, 2),
        groups=3), _rnd(2, 3, 4, 5), "reduce"),
    "Conv2DTranspose_dilate": (lambda pkg: pkg.gluon.nn.Conv2DTranspose(
        4, 3, strides=2, dilation=2, use_bias=False, in_channels=2),
        _rnd(2, 2, 5, 4), "reduce"),
    "Conv3DTranspose": (lambda pkg: pkg.gluon.nn.Conv3DTranspose(
        4, 2, strides=2, output_padding=1, groups=2),
        _rnd(1, 6, 3, 4, 3), "reduce"),
    "MaxPool1D": (lambda pkg: pkg.gluon.nn.MaxPool1D(3, 2, 1,
                                                     ceil_mode=True),
                  _rnd(2, 3, 10), "exact"),
    "MaxPool3D": (lambda pkg: pkg.gluon.nn.MaxPool3D(ceil_mode=True),
                  _rnd(2, 2, 5, 4, 3), "exact"),
    "AvgPool1D": (lambda pkg: pkg.gluon.nn.AvgPool1D(
        3, 2, 1, count_include_pad=False), _rnd(2, 3, 10), "arith"),
    "AvgPool2D": (lambda pkg: pkg.gluon.nn.AvgPool2D(), _rnd(2, 3, 6, 4),
                  "arith"),
    "AvgPool2D_ceil": (lambda pkg: pkg.gluon.nn.AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False),
        _rnd(2, 3, 8, 7), "arith"),
    "AvgPool3D": (lambda pkg: pkg.gluon.nn.AvgPool3D(3, 2, 1),
                  _rnd(1, 2, 5, 6, 5), "arith"),
    "GlobalMaxPool1D": (lambda pkg: pkg.gluon.nn.GlobalMaxPool1D(),
                        _rnd(2, 3, 7), "exact"),
    "GlobalMaxPool2D": (lambda pkg: pkg.gluon.nn.GlobalMaxPool2D(),
                        _rnd(2, 3, 5, 4), "exact"),
    "GlobalMaxPool3D": (lambda pkg: pkg.gluon.nn.GlobalMaxPool3D(),
                        _rnd(2, 3, 3, 4, 2), "exact"),
    "GlobalAvgPool1D": (lambda pkg: pkg.gluon.nn.GlobalAvgPool1D(),
                        _rnd(2, 3, 7), "reduce"),
    "GlobalAvgPool3D": (lambda pkg: pkg.gluon.nn.GlobalAvgPool3D(),
                        _rnd(2, 3, 3, 4, 2), "reduce"),
    "ReflectionPad2D": (lambda pkg: pkg.gluon.nn.ReflectionPad2D(2),
                        _rnd(2, 3, 5, 6), "exact"),
    "ReflectionPad2D_tuple": (lambda pkg: pkg.gluon.nn.ReflectionPad2D(
        (0, 0, 0, 0, 1, 2, 2, 1)), _rnd(1, 2, 4, 5), "exact"),
}


def run_block(pkg, block, x, ctx, head_seed=9):
    """(output, input gradient, parameter gradients) of ``block(x)``
    under autograd, for a seeded head gradient."""
    X = pkg.nd.array(x, ctx=ctx)
    X.attach_grad()
    with pkg.autograd.record():
        out = block(X)
        head = np.random.RandomState(head_seed).randn(*out.shape)
        loss = (out * pkg.nd.array(head.astype(np.float32), ctx=ctx)).sum()
    loss.backward()
    return ([out.asnumpy(), X.grad.asnumpy()]
            + [p.grad().asnumpy() for p in block.collect_params().values()
               if p.grad_req != "null"])
