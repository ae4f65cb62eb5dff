"""The port's optimizer family (``mxnet_tpu_torch/optimizer/``), LR
schedulers (``lr_scheduler.py``), initializers and ``Trainer`` states
against the reference's, on the CPU.

* Every optimizer of the reference's registry takes 5 updates of three
  weights from the same gradients in both packages, with ``wd``,
  ``clip_gradient``, ``rescale_grad``, an ``lr_mult`` by index and a
  ``wd_mult`` by name (``param_idx2name``), through ``Updater``; the
  reference runs its ops under ``jax.disable_jit()`` (its jit lets
  XLA:CPU contract multiply-adds into FMAs).  Weights and states agree
  bit for bit after every update, but for LAMB and LARS, whose norms
  are sums in another order (``nd.norm`` in LAMB's trust ratio, the
  host-read norms in LARS's rate): those agree within rtol 1e-6, atol
  1e-7.  ``multi_precision`` runs the same on float16 weights for sgd,
  nag, adam and lamb (the float16 weights, float32 masters and
  states).
* Each scheduler's ``lr`` for updates 0-200 is equal in both packages.
* Each initializer draws the same numbers after ``np.random.seed``.
* ``Trainer.save_states`` of the reference (the optimizer pickled with
  it) loads into the port, which resumes as the reference does; the
  port's states-only bytes load into the reference's ``Updater``; a
  port Trainer saved after 3 Adam steps and loaded into a fresh one
  takes the next 3 steps bit for bit as an uninterrupted run.
* A Gluon ResNet-18 v1 at 64 x 64 trains 3 steps with Adam under a
  ``CosineScheduler`` (with warmup) in both packages.  Adam moves
  every weight by about ``lr`` (1e-3) whatever its gradient's size, so
  a gradient element that is f32 rounding noise in both packages (a
  weight whose true gradient is about 0) moves by different amounts
  in each: measured, 2986 of the 11.2M parameters part by more than
  1e-6 after the first step (at most 5.9e-4) and 50852 after the
  third (at most 1.1e-3), the rest agree as SGD's do.  So the
  parameters and running statistics are held as in
  ``tests/test_torch_gluon.py``'s SGD case (1e-6 after the first step,
  1e-5 after the third) for all but 1% of the elements, and every
  element within 2 x lr a step; the per-sample losses within 1e-5 of
  (1 + |loss|) (they reach 6.6 at the third step and part by 1.1e-5
  there).

The ``cuda`` test runs ``chip_smoke.py``'s optimizer-family check for
Adam: a thumbnail ResNet-18 3 steps on the card and on the CPU.
"""
import pickle

import numpy as np
import pytest

import _torch_port as T
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

import mxnet_tpu_torch as P

SHAPES = [(4, 3), (5,), (2, 2, 3)]
COMMON = dict(learning_rate=0.05, wd=0.01, clip_gradient=0.5,
              rescale_grad=0.7)
# (registry name, its options); every name of the reference's registry
CASES = [
    ("sgd", {}), ("sgd", dict(momentum=0.9)), ("nag", dict(momentum=0.9)),
    ("adam", {}), ("adagrad", {}), ("rmsprop", {}),
    ("rmsprop", dict(centered=True, clip_weights=1.0)), ("ftrl", {}),
    ("signum", {}), ("signum", dict(momentum=0.0)),
    ("lamb", dict(lower_bound=0.1, upper_bound=10.0)),
    ("lars", dict(momentum=0.9)), ("adadelta", {}), ("adamax", {}),
    ("nadam", {}), ("test", {}),
]
NORMS = {"lamb": (1e-6, 1e-7), "lars": (1e-6, 1e-7)}


def _arrays(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(dtype) for s in SHAPES]


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (list, tuple)):
        return [a for s in state for a in _flat(s)]
    return [state.asnumpy()]


def _run(pkg, name, opts, dtype, steps=5):
    """``steps`` updates of the three weights; every weight and state
    after each."""
    kw = {"ctx": P.cpu()} if pkg is P else {}
    opt = pkg.optimizer.create(
        name, param_idx2name={i: "w%d" % i for i in range(3)},
        **dict(COMMON, **opts))
    opt.set_lr_mult({0: 0.5})
    opt.set_wd_mult({"w2": 2.0})
    upd = pkg.optimizer.get_updater(opt)
    ws = [pkg.nd.array(a, dtype=dtype, **kw) for a in _arrays(0, dtype)]
    out = []
    for step in range(steps):
        gs = [pkg.nd.array(a, dtype=dtype, **kw)
              for a in _arrays(100 + step, dtype)]
        for i, (w, g) in enumerate(zip(ws, gs)):
            upd(i, g, w)
        out.append([w.asnumpy() for w in ws]
                   + [a for i in range(3) for a in _flat(upd.states[i])])
    return out


def _check_updates(name, opts, dtype, multi_precision=False):
    import jax
    if multi_precision:
        opts = dict(opts, multi_precision=True)
    got = _run(P, name, opts, dtype)
    with jax.disable_jit():
        want = _run(R, name, opts, dtype)
    rtol, atol = NORMS.get(name, (0.0, 0.0))
    for step, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (name, step)
        for k, (a, b) in enumerate(zip(g, w)):
            assert a.dtype == b.dtype, (name, step, k)
            T.assert_close(a, b, (rtol, atol), "%s step %d array %d"
                           % (name, step, k))


@pytest.mark.parametrize("name,opts", CASES,
                         ids=["%s%s" % (n, "".join("-%s" % k for k in o))
                              for n, o in CASES])
def test_optimizer_updates_match_reference(name, opts):
    _check_updates(name, opts, np.float32)


@pytest.mark.parametrize("name,opts", [
    ("sgd", dict(momentum=0.9)), ("sgd", {}), ("nag", dict(momentum=0.9)),
    ("adam", {}), ("lamb", {})], ids=["sgd-momentum", "sgd", "nag", "adam",
                                       "lamb"])
def test_multi_precision_matches_reference(name, opts):
    _check_updates(name, opts, np.float16, multi_precision=True)


def test_registry_and_base_surface():
    """Every reference registry name creates the same class name; the
    base class's surface behaves as the reference's."""
    from mxnet_tpu.optimizer import optimizer as ref_opt
    names = sorted(ref_opt._REG._entries)
    assert names == sorted(P.optimizer.optimizer._REG._entries)
    for n in names:
        assert type(P.optimizer.create(n)).__name__ == \
            type(R.optimizer.create(n)).__name__
    opt = P.optimizer.Optimizer.create_optimizer("sgd", learning_rate=0.1)
    opt.set_learning_rate(0.2)
    assert opt.learning_rate == 0.2
    sched = P.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = P.optimizer.create("adam", learning_rate=0.1, lr_scheduler=sched)
    with pytest.raises(P.MXNetError, match="already been defined"):
        opt.set_learning_rate(0.3)
    assert P.optimizer.create(opt) is opt


SCHEDULERS = [
    ("FactorScheduler", dict(step=7, factor=0.7, stop_factor_lr=1e-3)),
    ("FactorScheduler", dict(step=10, factor=0.5, warmup_steps=15,
                             warmup_begin_lr=0.001)),
    ("MultiFactorScheduler", dict(step=[20, 50, 120], factor=0.3)),
    ("MultiFactorScheduler", dict(step=[30, 90], factor=0.5,
                                  warmup_steps=10, warmup_mode="constant",
                                  warmup_begin_lr=0.002)),
    ("PolyScheduler", dict(max_update=150, pwr=2, final_lr=1e-4)),
    ("PolyScheduler", dict(max_update=120, pwr=1, warmup_steps=20)),
    ("CosineScheduler", dict(max_update=180, final_lr=1e-4)),
    ("CosineScheduler", dict(max_update=40, base_lr=1e-3,
                             warmup_steps=5)),
]


@pytest.mark.parametrize("cls,kw", SCHEDULERS,
                         ids=["%s-%d" % (c, i)
                              for i, (c, _) in enumerate(SCHEDULERS)])
def test_scheduler_matches_reference(cls, kw):
    kw = dict({"base_lr": 0.05}, **kw)
    a = getattr(P.lr_scheduler, cls)(**kw)
    b = getattr(R.lr_scheduler, cls)(**kw)
    assert [a(n) for n in range(201)] == [b(n) for n in range(201)]


INITS = [
    ("Uniform", dict(scale=0.3), (4, 5), "fc_weight"),
    ("Normal", dict(sigma=0.2), (4, 5), "fc_weight"),
    ("Xavier", dict(rnd_type="gaussian", factor_type="in", magnitude=2),
     (6, 3, 3, 3), "conv_weight"),
    ("MSRAPrelu", {}, (6, 3, 3, 3), "conv_weight"),
    ("Orthogonal", {}, (4, 6), "fc_weight"),
    ("Orthogonal", dict(scale=1.0, rand_type="normal"), (6, 2, 2),
     "fc_weight"),
    ("Bilinear", {}, (2, 1, 4, 4), "up_weight"),
    ("LSTMBias", dict(forget_bias=2.0), (16,), "lstm_i2h_bias"),
    ("Constant", dict(value=0.5), (3, 2), "x_weight"),
    ("Xavier", {}, (3,), "bn_gamma"),
]


@pytest.mark.parametrize("cls,kw,shape,name", INITS,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(INITS)])
def test_initializer_matches_reference(cls, kw, shape, name):
    out = []
    for pkg in (P, R):
        np.random.seed(11)
        arr = pkg.nd.zeros(shape, **({"ctx": P.cpu()} if pkg is P else {}))
        getattr(pkg.initializer, cls)(**kw)(
            pkg.initializer.InitDesc(name), arr)
        out.append(arr.asnumpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_mixed_initializer_matches_reference():
    out = []
    for pkg in (P, R):
        np.random.seed(5)
        mixed = pkg.initializer.Mixed(
            [".*bias", ".*"], [pkg.initializer.Constant(0.25),
                               pkg.initializer.Uniform(0.1)])
        kw = {"ctx": P.cpu()} if pkg is P else {}
        arrs = [pkg.nd.zeros(s, **kw) for s in ((3,), (2, 4))]
        mixed("fc_bias", arrs[0])
        mixed("fc_weight", arrs[1])
        out.append([a.asnumpy() for a in arrs])
        with pytest.raises(Exception, match="did not match"):
            pkg.initializer.Mixed(["a"], [pkg.initializer.Zero()])(
                "b", arrs[0])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def _dense(pkg, weights, ctx):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, in_units=6, activation="relu"),
            pkg.gluon.nn.Dense(3, in_units=8))
    net.initialize(pkg.initializer.Zero(), ctx=ctx)
    for (k, v), a in zip(sorted(net._collect_params_with_prefix().items()),
                         weights):
        v.set_data(pkg.nd.array(a, ctx=ctx))
    return net


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) * 0.3
            for s in ((8,), (8, 6), (3,), (3, 8))]


def _steps(pkg, net, trainer, ctx, seeds):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for s in seeds:
        rng = np.random.RandomState(s)
        x = pkg.nd.array(rng.randn(5, 6).astype(np.float32), ctx=ctx)
        y = pkg.nd.array(rng.randint(0, 3, 5).astype(np.float32), ctx=ctx)
        with pkg.autograd.record():
            L = loss_fn(net(x), y)
        L.backward()
        trainer.step(5)
        losses.append(L.asnumpy())
    return losses


def _adam(pkg, net):
    sched = pkg.lr_scheduler.CosineScheduler(max_update=20, base_lr=0.05,
                                             warmup_steps=2)
    return pkg.gluon.Trainer(net.collect_params(), "adam",
                             {"learning_rate": 0.05, "wd": 1e-3,
                              "lr_scheduler": sched})


def _net_params(net):
    return [v.data().asnumpy() for _, v in
            sorted(net._collect_params_with_prefix().items())]


def test_reference_states_load_into_the_port(tmp_path):
    """The reference's ``save_states`` file (its optimizer pickled with
    its Parameters) loads into a port Trainer without the reference's
    classes; from the reference's weights the port then takes the step
    the reference takes (within the f32 rounding of the reference's
    jitted ops, 1e-6)."""
    rnet = _dense(R, _weights(), R.cpu())
    rtr = _adam(R, rnet)
    _steps(R, rnet, rtr, R.cpu(), [1, 2])
    f = str(tmp_path / "ref.states")
    rtr.save_states(f)
    pnet = _dense(P, _net_params(rnet), P.cpu())
    ptr = P.gluon.Trainer(pnet.collect_params(), "sgd",
                          {"learning_rate": 0.5})
    ptr.load_states(f)
    opt = ptr.optimizer
    assert type(opt) is P.optimizer.Adam
    assert type(opt.lr_scheduler) is P.lr_scheduler.CosineScheduler
    assert opt.num_update == 2 and opt.param_dict[0] is \
        list(pnet.collect_params().values())[0]
    _steps(R, rnet, rtr, R.cpu(), [3])
    _steps(P, pnet, ptr, P.cpu(), [3])
    for a, b in zip(_net_params(pnet), _net_params(rnet)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_port_states_load_into_the_reference():
    """The port's states-only bytes (``Updater.get_states()``) set the
    reference's ``Updater`` to the same arrays."""
    pnet = _dense(P, _weights(), P.cpu())
    ptr = _adam(P, pnet)
    _steps(P, pnet, ptr, P.cpu(), [1, 2])
    blob = ptr._updater.get_states()
    upd = R.optimizer.get_updater(R.optimizer.create("adam"))
    upd.set_states(blob)
    assert sorted(upd.states) == sorted(ptr._updater.states)
    for i, st in ptr._updater.states.items():
        for a, b in zip(_flat(st), _flat(upd.states[i])):
            np.testing.assert_array_equal(a, b)
    assert isinstance(pickle.loads(blob), dict)


def test_save_load_resumes_bit_for_bit(tmp_path):
    """3 Adam steps, ``save_states``, a fresh Trainer (over the same
    Parameters) ``load_states``, 3 more steps: bit for bit the
    uninterrupted 6 steps."""
    net = _dense(P, _weights(), P.cpu())
    tr = _adam(P, net)
    full = _steps(P, net, tr, P.cpu(), range(1, 7))
    want = _net_params(net)
    net = _dense(P, _weights(), P.cpu())
    tr = _adam(P, net)
    part = _steps(P, net, tr, P.cpu(), range(1, 4))
    f = str(tmp_path / "port.states")
    tr.save_states(f)
    tr2 = P.gluon.Trainer(net.collect_params(), "adam")
    tr2.load_states(f)
    part += _steps(P, net, tr2, P.cpu(), range(4, 7))
    for a, b in zip(part, full):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_net_params(net), want):
        np.testing.assert_array_equal(a, b)


def _resnet_pair():
    from mxnet_tpu_torch.convert import set_block_params
    x = np.random.RandomState(0).randn(4, 3, 64, 64).astype(np.float32)
    np.random.seed(3)
    rnet = R.gluon.model_zoo.vision.resnet18_v1(classes=10)
    rnet.initialize(R.initializer.Xavier(), ctx=R.cpu())
    rnet(R.nd.array(x))
    arrays = {k: v.data().asnumpy()
              for k, v in rnet._collect_params_with_prefix().items()}
    pnet = P.gluon.model_zoo.vision.resnet18_v1(classes=10)
    pnet.initialize(P.init.Xavier(), ctx=P.cpu())
    set_block_params(pnet, arrays, ctx=P.cpu())
    return rnet, pnet


def _resnet_train(pkg, net, ctx, steps=3):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)
    sched = pkg.lr_scheduler.CosineScheduler(max_update=10, base_lr=1e-3,
                                             warmup_steps=1)
    tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-3, "wd": 1e-4,
                            "lr_scheduler": sched})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx)
    losses, states = [], []
    for _ in range(steps):
        with pkg.autograd.record():
            L = loss_fn(net(X), Y)
        L.backward()
        tr.step(4)
        losses.append(L.asnumpy())
        states.append({k: v.data().asnumpy() for k, v in
                       net._collect_params_with_prefix().items()})
    return losses, states, tr.learning_rate


def test_resnet18_adam_cosine_matches_reference():
    rnet, pnet = _resnet_pair()
    rl, rs, rlr = _resnet_train(R, rnet, R.cpu())
    pl, ps, plr = _resnet_train(P, pnet, P.cpu())
    assert plr == rlr
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert np.mean(pl[-1]) < np.mean(pl[0])
    for step, atol in ((0, 1e-6), (2, 1e-5)):
        assert sorted(ps[step]) == sorted(rs[step])
        over = total = 0
        for k in rs[step]:
            d = np.abs(ps[step][k] - rs[step][k])
            assert d.max() <= 2 * 1e-3 * (step + 1), (k, d.max())
            over += int((d > atol).sum())
            total += d.size
        assert over <= 0.01 * total, (step, over, total)


@pytest.mark.cuda
def test_adam_card_against_cpu(cuda_device):
    import chip_smoke
    failures = []
    chip_smoke.check_optimizer_family(P, failures, names=("adam",),
                                      multi_precision=("adam",))
    assert not failures, failures
