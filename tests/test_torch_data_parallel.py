"""Port parity: ``mxnet_tpu_torch.parallel`` (``make_mesh``,
``DataParallelTrainer`` and its optimizer rules) against
``mxnet_tpu.parallel``.

The reference runs on a one-device mesh, ``make_mesh({"dp": 1},
devices=jax.devices()[:1])``; the port on ``devices=[cpu]``.  Weights
cross by structural name (``convert.set_block_params``).

Tolerances.
* Optimizer rules against the reference trainer's optax chain, run op by
  op (unjitted, so no fused multiply-add), one and three updates:
  ``sgd`` with and without momentum and with ``wd`` bit for bit;
  ``grad_clip``, ``adam``, ``adamw`` and ``lamb`` within rtol 1e-6,
  atol 1e-7 (norms and ``pow`` round in another order).
* ``DataParallelTrainer`` in f32 (SGD lr 0.01, momentum 0.9) on a
  Conv -> BatchNorm -> relu -> pool -> Dense net and on ResNet-18 v1 with
  the space-to-depth stem (64 x 64, batch 4): per-step losses within
  rtol 1e-5, atol 1e-6; parameters and running statistics after
  ``sync_back()`` following 3 steps within rtol 1e-4, atol 1e-5 (XLA
  compiles the reference's step; torch runs the port's op by op, so f32
  sums round in another order).  At 32 x 32 the last stage's BatchNorm
  normalises 4 values per channel, which multiplies those rounding
  differences by about 100 a step (measured: 4e-6, 1e-3, 1e-1 relative
  in the losses), so the ResNet runs at 64 x 64.
* With ``amp=True``: every op that both packages invoke in one forward
  gets the same float input dtypes after the cast hook; the step-1 loss
  within 1e-2 relative and the 3-step losses within 2e-2 (bf16
  convolutions and matmuls round differently in XLA and in torch).
* Within the port, ``run_steps`` equals K ``step()`` calls bit for bit.

``cuda`` tests (skipped without a card; on the card run with
``--noconftest``, as the README says) hold the captured ``run_steps``
bit for bit against ``_eager = True`` from the same state, in both data
modes, check that a new batch shape captures a second graph, and that
parameters initialised on the CPU train on the card and come back at
``sync_back()``.
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401

CPU = torch.device("cpu")


def _small_net(pkg, classes=3):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Dense(classes))
    return net


def _resnet(pkg):
    return pkg.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                  stem_s2d=True)


def _batch(seed, shape, classes):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32) * 2 + 1,
            rng.randint(0, classes, shape[0]).astype(np.float32))


def _twins(build, x):
    """A reference net (Xavier, shapes resolved by one forward) and the
    port's twin carrying its weights."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import set_block_params
    np.random.seed(3)
    jnet = build(jmx)
    jnet.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    jnet(jmx.nd.array(x))
    arrays = _values(jnet)
    tnet = build(mx)
    set_block_params(tnet, arrays, ctx=mx.cpu())
    return jnet, tnet


def _values(net):
    return {k: v.data().asnumpy()
            for k, v in net._collect_params_with_prefix().items()}


def _jax_mesh():
    import jax
    from mxnet_tpu.parallel import make_mesh
    return make_mesh({"dp": 1}, devices=jax.devices()[:1])


def _port_mesh():
    from mxnet_tpu_torch.parallel import make_mesh
    return make_mesh({"dp": -1}, devices=[CPU])


def _trainers(jnet, tnet, optimizer="sgd", params=None, **kw):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu.parallel import DataParallelTrainer as JDPT
    from mxnet_tpu_torch.parallel import DataParallelTrainer as TDPT
    params = params or {"learning_rate": 0.01, "momentum": 0.9}
    jt = JDPT(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
              dict(params), mesh=_jax_mesh(), **kw)
    tt = TDPT(tnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
              dict(params), mesh=_port_mesh(), **kw)
    return jt, tt


# ------------------------------------------------------------------- mesh --
def test_make_mesh():
    """Twin of tests/test_parallel.py::test_make_mesh on one device: the
    -1 axis, a named shape, and the reference's errors word for word."""
    import jax
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu.parallel import make_mesh as jmake
    from mxnet_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"dp": -1}, devices=[CPU])
    assert mesh.shape == {"dp": 1} and mesh.size == 1
    assert make_mesh({"dp": 1, "tp": 1}, devices=[CPU]).shape == \
        {"dp": 1, "tp": 1}
    assert make_mesh(devices=[CPU]).axis_names == ("dp",)
    one = jax.devices()[:1]
    for shape in ({"dp": 3}, {"dp": -1, "tp": -1}, {"dp": -1, "tp": 2}):
        with pytest.raises(jmx.MXNetError) as want:
            jmake(shape, devices=one)
        with pytest.raises(mx.MXNetError) as got:
            make_mesh(shape, devices=[CPU])
        assert str(got.value) == str(want.value)


def test_mesh_entry_points_need_the_card_or_one_device():
    """With no devices given the mesh is the visible CUDA devices (never
    quietly the CPU); a trainer over more than one device, shard_map and
    the unported parallel modules raise NotImplementedError."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.default_mesh()
    two = parallel.make_mesh({"dp": -1}, devices=[CPU, CPU])
    assert two.shape == {"dp": 2}
    net = _small_net(mx)
    with pytest.raises(NotImplementedError, match="2 devices"):
        parallel.DataParallelTrainer(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), mesh=two)
    with pytest.raises(NotImplementedError):
        parallel.shard_map_compat(None, mesh=two, in_specs=(),
                                  out_specs=())
    with pytest.raises(NotImplementedError):
        parallel.ring_attention
    with pytest.raises(NotImplementedError):
        parallel.mesh.zero1_sharding
    assert parallel.live_axis(two, "dp") == "dp"
    assert parallel.live_axis(_port_mesh(), "dp") is None
    with parallel.mesh_scope(two):
        assert parallel.current_mesh() is two
    assert parallel.current_mesh() is None


# ------------------------------------------------------- optimizer rules --
RULES = [
    ("sgd", {"learning_rate": 0.05}, None, True),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, None, True),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}, None,
     True),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 0.5, False),
    ("adam", {"learning_rate": 1e-2}, None, False),
    ("adamw", {"learning_rate": 1e-2, "wd": 1e-2}, None, False),
    ("adamw", {"learning_rate": 1e-2}, None, False),
    ("lamb", {"learning_rate": 1e-2, "wd": 1e-2}, None, False),
    ("lamb", {"learning_rate": 1e-2}, 1.0, False),
]


@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("opt,params,clip,exact", RULES)
def test_rules_match_optax(opt, params, clip, exact, updates):
    """The port's rule against the reference trainer's optax chain
    (``DataParallelTrainer.tx``), one and three updates on the same
    parameters and gradients; the last tensor of the parameters is all
    zeros (lamb's trust ratio is 1 there)."""
    import jax.numpy as jnp
    import mxnet_tpu as jmx
    import optax
    from mxnet_tpu.parallel import DataParallelTrainer as JDPT
    from mxnet_tpu_torch.parallel._optim import make_rule
    rng = np.random.RandomState(7)
    shapes = [(4, 3, 3, 3), (4,), (5, 4), (3,)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    p0[-1][:] = 0.0
    grads = [[(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]
             for _ in range(updates)]
    tx = JDPT(jmx.gluon.nn.Dense(1), None, opt, dict(params),
              mesh=_jax_mesh(), grad_clip=clip).tx
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    rule = make_rule(opt, dict(params), clip)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tstate = rule.init(tp)
    for g in grads:
        u, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, u)
        rule.apply([torch.from_numpy(x) for x in g], tstate, tp)
    for got, want in zip(tp, jp):
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- the trainer --
@pytest.mark.parametrize("build,shape", [
    (_small_net, (8, 4, 6, 6)), (_resnet, (4, 3, 64, 64))],
    ids=["conv_bn", "resnet18_s2d"])
def test_trainer_matches_reference_f32(build, shape):
    """Three steps (SGD lr 0.01, momentum 0.9, f32): two ``step()`` calls
    and one ``run_steps(steps=1)``, losses and then the parameters and
    running statistics after ``sync_back()`` against the reference's
    (tolerances in the module docstring); the Parameters unchanged
    before ``sync_back()``."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    classes = 10 if build is _resnet else 3
    x, y = _batch(0, shape, classes)
    jnet, tnet = _twins(build, x)
    before = _values(tnet)
    jt, tt = _trainers(jnet, tnet)
    want, got = [], []
    for _ in range(2):
        want.append(float(jt.step(jmx.nd.array(x),
                                  jmx.nd.array(y)).asnumpy()))
        got.append(float(tt.step(mx.nd.array(x, ctx=mx.cpu()),
                                 mx.nd.array(y, ctx=mx.cpu())).asnumpy()))
    want += list(jt.run_steps(jmx.nd.array(x), jmx.nd.array(y),
                              steps=1).asnumpy())
    got += list(tt.run_steps(x, y, steps=1).asnumpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for k, v in _values(tnet).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    jt.sync_back()
    tt.sync_back()
    want_p = _values(jnet)
    for k, v in _values(tnet).items():
        np.testing.assert_allclose(v, want_p[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        if "running" in k:
            assert np.abs(v - before[k]).max() > 1e-4, k


def _recording(monkeypatch, module, log):
    """Wrap ``module._make_hook`` so the hooks it makes log (op name,
    float input dtypes after the cast)."""
    orig = module._make_hook

    def make(target):
        hook = orig(target)

        def rec(op, arrays):
            out = hook(op, arrays)
            log.append((op.name, tuple(
                str(a.dtype).replace("torch.", "") for a in out
                if hasattr(a, "dtype") and "float" in str(a.dtype))))
            return out
        return rec

    monkeypatch.setattr(module, "_make_hook", make)


@pytest.mark.parametrize("build,shape,lr", [
    (_small_net, (16, 4, 8, 8), 0.1), (_resnet, (8, 3, 64, 64), 1e-4)],
    ids=["conv_bn", "resnet18_s2d"])
def test_trainer_amp_matches_reference(monkeypatch, build, shape, lr):
    """``amp=True``: the float input dtypes of every op that both
    packages invoke in the first step's forward (on ResNet-18 with the
    space-to-depth stem: conv, FC, BatchNorm, Activation, Pooling, the
    residual add, pad, space-to-depth and the loss's ops) equal the
    reference's, op for op; the losses of 3 steps within the bf16
    limits; the hook off again after each step; the parameters stay
    float32.  The learning rates keep the loss away from 0 over the 3
    steps: where it collapses (0.05 after 2 steps at lr 0.01 on the
    ResNet), a relative bound measures the bf16 rounding of two
    convolution libraries, not the port."""
    import mxnet_tpu as jmx
    import mxnet_tpu.contrib.amp.amp as jamp
    import mxnet_tpu_torch.contrib.amp.amp as tamp
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    classes = 10 if build is _resnet else 3
    x, y = _batch(1, shape, classes)
    jnet, tnet = _twins(build, x)
    jlog, tlog = [], []
    _recording(monkeypatch, jamp, jlog)
    _recording(monkeypatch, tamp, tlog)
    jt, tt = _trainers(jnet, tnet, amp=True,
                       params={"learning_rate": lr, "momentum": 0.9})
    want = [float(jt.step(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())]
    got = [float(tt.step(x, y).asnumpy())]
    assert treg._CAST_HOOK is None and jreg._CAST_HOOK is None
    common = {n for n, _ in jlog} & {n for n, _ in tlog}
    assert {"Convolution", "FullyConnected", "BatchNorm", "Activation",
            "Pooling", "log_softmax", "pick", "mean"} <= common
    if build is _resnet:
        assert {"broadcast_add", "pad", "space_to_depth"} <= common
    assert [e for e in tlog if e[0] in common] == \
        [e for e in jlog if e[0] in common]
    assert all(set(d) == {"bfloat16"} for n, d in tlog
               if n in ("Convolution", "FullyConnected"))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-2)
    want += list(jt.run_steps(jmx.nd.array(x), jmx.nd.array(y),
                              steps=2).asnumpy())
    got += list(tt.run_steps(x, y, steps=2).asnumpy())
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert all(t.dtype == torch.float32 for t in tt._params)


@pytest.mark.parametrize("amp", [False, True])
def test_run_steps_matches_python_loop(amp):
    """Twin of tests/test_parallel.py::test_run_steps_matches_python_loop,
    held within the port bit for bit: K ``step()`` calls over a
    superbatch against one ``run_steps`` (superbatch mode), and 3 steps
    on one batch against ``run_steps(steps=3)`` (reuse mode)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    np.random.seed(1)
    K, B = 4, 16
    Xs = np.random.randn(K, B, 6).astype("float32")
    Ys = np.einsum("kbi,io->kbo", Xs,
                   np.random.randn(6, 1).astype("float32"))

    def build():
        net = nn.Dense(1, use_bias=False, in_units=6)
        net.initialize(mx.initializer.Zero(), ctx=mx.cpu())
        return net

    def make(net):
        return DataParallelTrainer(net, gluon.loss.L2Loss(), "sgd",
                                   {"learning_rate": 0.05},
                                   mesh=_port_mesh(), amp=amp)

    with mx.cpu():
        net_ref = build()
        tr_ref = make(net_ref)
        ref_losses = [float(tr_ref.step(nd.array(Xs[k]),
                                        nd.array(Ys[k])).asnumpy())
                      for k in range(K)]
        tr_ref.sync_back()
        net_sb = build()
        tr_sb = make(net_sb)
        losses = tr_sb.run_steps(nd.array(Xs), nd.array(Ys)).asnumpy()
        tr_sb.sync_back()
        assert losses.shape == (K,)
        np.testing.assert_array_equal(losses, np.float32(ref_losses))
        np.testing.assert_array_equal(net_sb.weight.data().asnumpy(),
                                      net_ref.weight.data().asnumpy())
        net_r1, net_r2 = build(), build()
        tr1, tr2 = make(net_r1), make(net_r2)
        for _ in range(3):
            tr1.step(nd.array(Xs[0]), nd.array(Ys[0]))
        losses2 = tr2.run_steps(nd.array(Xs[0]), nd.array(Ys[0]),
                                steps=3).asnumpy()
        tr1.sync_back()
        tr2.sync_back()
        assert losses2.shape == (3,)
        np.testing.assert_array_equal(net_r1.weight.data().asnumpy(),
                                      net_r2.weight.data().asnumpy())
        tr2.sync()
        with pytest.raises(mx.MXNetError, match="leading dims"):
            tr2.run_steps(nd.array(Xs), nd.array(Ys[:2]))


def test_data_parallel_bn_stats_update():
    """Twin of tests/test_parallel.py::test_data_parallel_bn_stats_update:
    BatchNorm's running mean moves through the trainer's state, and
    reaches the Parameter at ``sync_back()`` only."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    np.random.seed(0)
    X = np.random.randn(16, 4, 5, 5).astype("float32") * 2 + 1
    Y = np.random.randint(0, 2, (16,))
    with mx.cpu():
        net = _small_net(mx, classes=2)
        net.initialize(mx.initializer.Xavier())
        net(nd.array(X))
        bn = [b for b in net._children.values()
              if isinstance(b, nn.BatchNorm)][0]
        before = bn.running_mean.data().asnumpy().copy()
        tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1},
                                 mesh=_port_mesh())
        for _ in range(4):
            tr.step(nd.array(X), nd.array(Y))
        np.testing.assert_array_equal(bn.running_mean.data().asnumpy(),
                                      before)
        tr.sync_back()
    after = bn.running_mean.data().asnumpy()
    assert np.abs(after - before).max() > 1e-4


def test_data_parallel_amp_learns():
    """Twin of tests/test_parallel.py::test_data_parallel_amp_learns:
    ``amp=True`` (bf16 compute, f32 masters) still converges."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    np.random.seed(0)
    X = np.random.randn(32, 10).astype("float32")
    W = np.random.randn(10, 3).astype("float32")
    Y = (X @ W).argmax(1)
    with mx.cpu():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(32, activation="relu"), nn.Dense(3))
        net.initialize(mx.initializer.Xavier())
        tr = DataParallelTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.5},
                                 mesh=_port_mesh(), amp=True)
        losses = [float(tr.step(nd.array(X), nd.array(Y)).asnumpy())
                  for _ in range(12)]
    assert losses[-1] < losses[0] * 0.5, losses


# -------------------------------------------------------------- the card --
def _card_trainer(mx, dev, amp):
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    from mxnet_tpu_torch.convert import set_block_params
    np.random.seed(4)
    src = _resnet(mx)
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    src(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32), ctx=mx.cpu()))
    net = _resnet(mx)
    set_block_params(net, _values(src), ctx=mx.gpu(0))
    return DataParallelTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               "sgd", {"learning_rate": 0.1,
                                       "momentum": 0.9},
                               mesh=make_mesh({"dp": -1}), amp=amp)


@pytest.fixture
def deterministic_cudnn():
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_run_steps_captured_equals_eager(cuda_device, deterministic_cudnn,
                                         amp):
    """ResNet-18 v1 with the space-to-depth stem (32 x 32, batch 4) on
    the card: ``run_steps`` replayed as a CUDA graph against
    ``_eager = True`` from the same weights, bit for bit in the losses,
    the parameters, the momentum traces and the running statistics; 3
    steps in reuse mode, then 2 in superbatch mode; then a batch of
    another shape captures a second graph."""
    import mxnet_tpu_torch as mx
    x, y = _batch(2, (4, 3, 32, 32), 10)
    rng = np.random.RandomState(3)
    xs = rng.randn(2, 4, 3, 32, 32).astype(np.float32)
    ys = rng.randint(0, 10, (2, 4)).astype(np.float32)
    runs = []
    for eager in (True, False):
        tr = _card_trainer(mx, cuda_device, amp)
        tr._eager = eager
        losses = [tr.run_steps(x, y, steps=3).asnumpy(),
                  tr.run_steps(xs, ys).asnumpy()]
        runs.append((losses, [t.cpu().numpy()
                              for t in tr._state_tensors()]))
        if not eager:
            assert len(tr._graphs) == 1
            tr.step(x[:2], y[:2])
            assert len(tr._graphs) == 2
    (want_l, want_s), (got_l, got_s) = runs
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_s, want_s):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cpu_params_move_to_the_card(cuda_device, deterministic_cudnn):
    """Parameters initialised on the CPU: the trainer takes its copy on
    the mesh's device (the card), trains there, and ``sync_back()``
    writes the values into the CPU Parameters; a run on the CPU mesh
    from the same weights gives the same first loss within f32
    rounding (TF32 off)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    x, y = _batch(5, (8, 4, 6, 6), 3)
    losses = []
    for devices in (None, [CPU]):
        np.random.seed(6)
        net = _small_net(mx)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(x, ctx=mx.cpu()))
        before = _values(net)
        tr = DataParallelTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                 "sgd", {"learning_rate": 0.1},
                                 mesh=make_mesh({"dp": -1}, devices=devices))
        losses.append(tr.run_steps(x, y, steps=2).asnumpy())
        assert all(t.device == tr.device for t in tr._state_tensors())
        tr.sync_back()
        after = _values(net)
        assert all(p.data().context == mx.cpu()
                   for p in net.collect_params().values())
        assert any(np.abs(after[k] - before[k]).max() > 0 for k in before)
    np.testing.assert_allclose(losses[0][0], losses[1][0], rtol=1e-5)
