"""Port parity: Gluon (blocks, parameters, Trainer, losses) and the ResNet
model zoo of ``mxnet_tpu_torch`` against ``mxnet_tpu``.

Weights cross between the packages by structural name
(``features.0.weight``, from ``_collect_params_with_prefix``), never by
the global counter names, which differ in one process.

Tolerances.  Forward in predict mode: 1e-5 of the output scale (f32
summation order).  The 3-step Trainer run (learning rate 0.01, momentum
0.9, the thumbnail ResNet-18) is held where f32 summation order puts
it: on the CPU the two packages' per-sample losses differed by at most
1e-6, and their parameters and running statistics by at most 2.4e-7
after the first step and 1.9e-6 after the third (against updates of
5e-2 to 1e-1), so the limits are 1e-5 on the losses, 1e-6 on the state
after the first step and 1e-5 after the third.  The two update routes
of the port, fed the same gradients, are held bit for bit."""
import numpy as np
import pytest
import torch

B, SIZE, CLASSES = 4, 32, 10


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 3, SIZE, SIZE).astype(np.float32),
            rng.randint(0, CLASSES, B).astype(np.float32))


def _nets(**kw):
    """A reference resnet18_v1 (Xavier, shapes resolved by one forward)
    and a port twin carrying its weights across by structural name."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import set_block_params
    x, _ = _batch()
    np.random.seed(3)
    jnet = jmx.gluon.model_zoo.vision.resnet18_v1(classes=CLASSES, **kw)
    jnet.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    jnet(jmx.nd.array(x))
    arrays = {k: v.data().asnumpy()
              for k, v in jnet._collect_params_with_prefix().items()}
    tnet = mx.gluon.model_zoo.vision.resnet18_v1(classes=CLASSES, **kw)
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    set_block_params(tnet, arrays, ctx=mx.cpu())
    return jnet, tnet


def _params(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def test_resnet50_structure_matches_reference():
    """resnet50_v1's structural names, declared shapes, grad_req and
    lr/wd multipliers equal the reference's; after one forward every
    shape is known and the model holds ResNet-50 v1's weights as the
    reference builds it (bias on the bottleneck's 1x1 body convs)."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    ref = jmx.gluon.model_zoo.vision.resnet50_v1()._collect_params_with_prefix()
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1")
    got = net._collect_params_with_prefix()
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert (got[k].grad_req, got[k].lr_mult, got[k].wd_mult) == \
            (ref[k].grad_req, ref[k].lr_mult, ref[k].wd_mult), k
    net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    net(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32), ctx=mx.cpu()))
    trainable = [p for p in got.values() if p.grad_req != "null"]
    assert len(trainable) == 193
    # torchvision's ResNet-50 count, 25,557,032, plus the 18,880 biases
    # of the bottlenecks' 1x1 body convs (3x320 + 4x640 + 6x1280 + 3x2560)
    assert sum(int(np.prod(p.shape)) for p in trainable) == 25_575_912
    s2d = mx.gluon.model_zoo.vision.resnet50_v1(stem_s2d=True)
    assert s2d._collect_params_with_prefix()["features.0.conv.weight"] \
        .shape == (64, 12, 4, 4)


def test_forward_matches_reference():
    """Weights carried across; predict-mode forward of resnet18_v1 at
    32 x 32 (7x7/s2 stem, max pool) equal within f32 summation order."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    jnet, tnet = _nets()
    x, _ = _batch()
    want = jnet(jmx.nd.array(x)).asnumpy()
    got = tnet(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    assert got.shape == (B, CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=1e-5)


def _train(pkg, net, ctx, steps, lr=0.01):
    """Trainer steps on the fixed batch: (per-sample losses of each
    step, the parameters after the first step)."""
    x, y = _batch()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": lr, "momentum": 0.9})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx)
    losses, first = [], None
    for _ in range(steps):
        with pkg.autograd.record():
            L = loss_fn(net(X), Y)
        L.backward()
        trainer.step(B)
        losses.append(L.asnumpy())
        if first is None:
            first = _params(net)
    return losses, first


def test_trainer_steps_match_reference():
    """Three Trainer steps (SGD, momentum 0.9) on the thumbnail
    resnet18_v1: per-sample losses, parameters and BatchNorm running
    statistics after the first and the third step against the
    reference's (tolerances in the module docstring)."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    jnet, tnet = _nets(thumbnail=True)
    jl, jfirst = _train(jmx, jnet, jmx.cpu(), 3)
    tl, tfirst = _train(mx, tnet, mx.cpu(), 3)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert np.mean(tl[-1]) < np.mean(tl[0])
    for (jp, tp), atol in (((jfirst, tfirst), 1e-6),
                           ((_params(jnet), _params(tnet)), 1e-5)):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("wd,clip", [(0.0, None), (1e-4, 0.5)])
def test_multi_sgd_route_equals_trainer_route(wd, clip):
    """On one step's gradients and from the same state:
    ``nd.multi_sgd_mom_update`` over the whole group with the Trainer's
    own lrs, wds and rescale_grad gives the Trainer's weights and
    momenta bit for bit; the same for ``multi_sgd_update`` against the
    per-tensor ``sgd_update`` (momentum 0)."""
    import mxnet_tpu_torch as mx
    ctx = mx.cpu()
    np.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet18_v1(classes=CLASSES,
                                                thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    x, y = _batch()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        L = loss_fn(net(mx.nd.array(x, ctx=ctx)), mx.nd.array(y, ctx=ctx))
    L.backward()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    start = [p.data().copy() for p in params]
    for momentum in (0.9, 0.0):
        opt = {"learning_rate": 0.1, "momentum": momentum, "wd": wd}
        if clip is not None:
            opt["clip_gradient"] = clip
        for p, w in zip(params, start):
            p.set_data(w)
        trainer = mx.gluon.Trainer(params, "sgd", opt)
        trainer.step(B)
        want_w = [p.data().asnumpy() for p in params]
        want_m = [trainer._updater.states[i].asnumpy()
                  for i in range(len(params))] if momentum else []
        o = trainer.optimizer
        lrs = [o._get_lr(i) for i in range(len(params))]
        wds = [o._get_wd(i) for i in range(len(params))]
        kw = dict(lrs=lrs, wds=wds, rescale_grad=o.rescale_grad,
                  num_weights=len(params))
        if clip is not None:
            kw["clip_gradient"] = clip
        ws = [w.copy() for w in start]
        data, moms = [], []
        for w, p in zip(ws, params):
            data += [w, p.grad()]
            if momentum:
                moms.append(mx.nd.zeros(w.shape, ctx=ctx))
                data.append(moms[-1])
        if momentum:
            mx.nd.multi_sgd_mom_update(*data, out=ws, momentum=momentum,
                                       **kw)
        else:
            mx.nd.multi_sgd_update(*data, out=ws, **kw)
        for a, b in zip(want_w + want_m,
                        [w.asnumpy() for w in ws]
                        + [m.asnumpy() for m in moms]):
            assert np.array_equal(a + 0.0, b + 0.0)


def test_params_files_cross_between_packages(tmp_path):
    """The reference net's ``save_parameters`` file loads into the port's
    net through ``load_parameters`` (and back), running statistics
    included; the forwards then agree."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    jnet, _ = _nets()
    f = str(tmp_path / "ref.params")
    jnet.save_parameters(f)
    net = mx.gluon.model_zoo.vision.resnet18_v1(classes=CLASSES)
    net.load_parameters(f, ctx=mx.cpu())
    want = _params(jnet)
    for k, v in _params(net).items():
        np.testing.assert_array_equal(v, want[k])
    x, _ = _batch()
    np.testing.assert_allclose(net(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
                               jnet(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-5, atol=1e-5)
    f2 = str(tmp_path / "port.params")
    net.save_parameters(f2)
    back = jmx.gluon.model_zoo.vision.resnet18_v1(classes=CLASSES)
    back.load_parameters(f2, ctx=jmx.cpu())
    for k, v in _params(back).items():
        np.testing.assert_array_equal(v, want[k])


def test_set_block_params_refuses_mismatches():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import set_block_params
    net = mx.gluon.nn.Dense(3, in_units=2)
    net.initialize(ctx=mx.cpu())
    ok = {"weight": np.ones((3, 2), np.float32),
          "bias": np.zeros(3, np.float32)}
    set_block_params(net, ok)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), 1.0)
    with pytest.raises(ValueError, match="missing"):
        set_block_params(net, {"weight": ok["weight"]})
    with pytest.raises(ValueError, match="extra"):
        set_block_params(net, dict(ok, other=ok["bias"]))
    with pytest.raises(ValueError, match="shape"):
        set_block_params(net, dict(ok, weight=np.ones((2, 3), np.float32)))


def test_gluon_basics():
    """Name scopes and prefixes, deferred init, grad_req, zero_grad,
    hybridize (a cached entry per signature; on the CPU it runs the
    forward eagerly, tests/test_torch_compiled_steps.py), and the seeded
    Xavier draw that matches the reference's numpy stream."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    ctx = mx.cpu()
    nets = []
    for pkg in (jmx, mx):
        net = pkg.gluon.nn.HybridSequential(prefix="model_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(4, activation="relu"),
                    pkg.gluon.nn.Dense(2, in_units=4))
        np.random.seed(11)
        net.initialize(pkg.initializer.Xavier(),
                       ctx=pkg.cpu())
        nets.append(net)
    jnet, net = nets
    assert list(net.collect_params()) == list(jnet.collect_params())
    assert list(net.collect_params()) == [
        "model_dense0_weight", "model_dense0_bias", "model_dense1_weight",
        "model_dense1_bias"]
    with pytest.raises(mx.gluon.DeferredInitializationError):
        net[0].weight.data()
    net.hybridize()
    np.random.seed(12)
    x = np.random.randn(3, 5).astype(np.float32)
    np.random.seed(13)        # the deferred weight draws at the forward
    jout = jnet(jmx.nd.array(x)).asnumpy()
    np.random.seed(13)
    out = net(mx.nd.array(x, ctx=ctx))
    np.testing.assert_array_equal(net[0].weight.data().asnumpy(),
                                  jnet[0].weight.data().asnumpy())
    np.testing.assert_allclose(out.asnumpy(), jout, rtol=1e-5, atol=1e-6)
    with mx.autograd.record():
        y = net(mx.nd.array(x, ctx=ctx)).sum()
    y.backward()
    assert np.abs(net[1].weight.grad().asnumpy()).sum() > 0
    net.collect_params().zero_grad()
    assert np.abs(net[1].weight.grad().asnumpy()).sum() == 0
    net[1].bias.grad_req = "null"
    with pytest.raises(mx.MXNetError, match="grad_req='null'"):
        net[1].bias.grad()
    assert not isinstance(torch.zeros(1), mx.nd.NDArray)
