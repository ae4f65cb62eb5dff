"""The port's compiled steps: the serving step, the BERT/GPT train step
and ``hybridize()``'s ``_CachedOp``, each captured as a CUDA graph on the
card and run eagerly through the same signature and static-buffer code
on the CPU (``mxnet_tpu_torch/_graphs.py``).

CPU tests (against the reference where it has the same function):
* a hybridized Conv2D -> BatchNorm -> relu -> Dense net against the
  reference's hybridized twin over two rounds of record -> backward ->
  ``Trainer.step`` (SGD, momentum 0.9): outputs within 1e-5 of their
  largest magnitude, gradients within 1e-6 + 1e-5 of each tensor's
  largest gradient (the conv bias feeds BatchNorm, so its gradient is
  zero in exact arithmetic and holds only rounding noise, 3e-7),
  parameters and running statistics within 1e-6 (f32 summation order:
  XLA jit-compiles the reference's forward, torch runs the port's op
  by op);
* the signature cache, deferred initialization without a running-stat
  move, the parameter bindings restored;
* the engine through its static staging buffer, token-identical to the
  reference's ``generate`` (f32 greedy);
* the BERT train step over two batch shapes (one entry each) against
  the reference's step, at ``tests/test_torch_train.py``'s tolerances;
* the launch accounting, through a fake counter, and the train step's
  warm-up snapshot, which must leave no trace.

``cuda`` tests (skipped without a card) hold each captured step bit for
bit against the same step run eagerly on the card, from the same
state: the engine's tokens (f32 and bf16 pools, int8 KV), 3 BERT and 3
GPT steps with dropout (losses, parameters, AdamW state, the
generator's state after them), a second batch shape, and a hybridized
thumbnail ResNet-18 (outputs, gradients, running statistics; cuDNN in
deterministic mode, TF32 off); and the kernel launch counters per
replay.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import configs, cuda_device, numpy_params, to_port  # noqa

CLASSES, B = 10, 4


# ------------------------------------------------------------- accounting --
class _Fake:
    launches = 0


def test_launch_accounting_replays_the_capture_change():
    """``recorded_launches`` returns how a run moved each counter and
    puts the counter back; ``LaunchCounts.add`` applies the change
    once per replay; ``kept_launches`` undoes a warm-up's launches."""
    from mxnet_tpu_torch._graphs import kept_launches, recorded_launches
    fake = _Fake()
    fake.launches = 5
    counters = [(fake, "launches")]

    def body():
        fake.launches += 3
        return "out"

    out, launches = recorded_launches(body, counters)
    assert out == "out" and fake.launches == 5
    assert launches.changes == [(fake, "launches", 3)]
    launches.add()
    launches.add()
    assert fake.launches == 11
    with kept_launches(counters):
        body()
    assert fake.launches == 11
    _, none = recorded_launches(lambda: None, counters)
    assert none.changes == []


def test_kernel_counters_cover_every_wrapper():
    """Every wrapper's counters are in the kernels' registry, which the
    capture reads; an ``rtc.CudaKernel`` joins it when it is made and
    leaves it when it is freed."""
    import gc
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.kernels import fused_conv as FC
    from mxnet_tpu_torch.kernels._counters import registered
    from mxnet_tpu_torch.kernels import fused_optimizer as FO
    from mxnet_tpu_torch.kernels import nms as NMS
    from mxnet_tpu_torch.kernels import paged_attention as PA
    k = rtc.CudaKernel(None, "k", rtc.parse_signature("float *x"))
    got = registered()
    for holder, attr in [(FA.flash_fwd, "launches"),
                         (FA.flash_bwd_dq, "launches"),
                         (FA.flash_bwd_dkv, "launches"),
                         (PA.paged_attention, "launches"),
                         (FC.conv3x3_fused, "launches"),
                         (FO.fused_multi_sgd, "sgd_launches"),
                         (FO.fused_multi_sgd, "sgd_mom_launches"),
                         (NMS.nms_keep, "launches"),
                         (k, "launches")]:
        assert any(h is holder and a == attr for h, a in got)

    def kernels():
        return sum(isinstance(h, rtc.CudaKernel)
                   for h, _ in registered())

    n = kernels()
    del k, got, holder
    gc.collect()
    assert kernels() == n - 1


def test_registered_counter_counts_under_replay():
    """A counter registered where its wrapper is defined is counted by
    the capture with no list to edit: ``recorded_launches`` with the
    default counters takes its change, each replay adds it again."""
    from mxnet_tpu_torch._graphs import recorded_launches
    from mxnet_tpu_torch.kernels._counters import register
    fake = register(_Fake(), "launches")
    assert fake.launches == 0

    def body():
        fake.launches += 2

    _, launches = recorded_launches(body)
    assert fake.launches == 0
    assert [(h, a, d) for h, a, d in launches.changes
            if h is fake] == [(fake, "launches", 2)]
    for _ in range(3):
        launches.add()
    assert fake.launches == 6


# -------------------------------------------------------------- hybridize --
def _gluon_pair():
    """The reference's and the port's Conv2D -> BatchNorm -> relu ->
    Dense, with the reference's weights and re-drawn BatchNorm
    statistics, gains and biases in both."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import set_block_params
    nets = []
    for pkg in (jmx, mx):
        net = pkg.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3),
                    pkg.gluon.nn.BatchNorm(in_channels=8),
                    pkg.gluon.nn.Activation("relu"),
                    pkg.gluon.nn.Dense(CLASSES, in_units=8 * 8 * 8))
        nets.append(net)
    jnet, tnet = nets
    np.random.seed(4)
    jnet.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    rng = np.random.RandomState(5)
    arrays = {}
    for k, p in jnet._collect_params_with_prefix().items():
        v = p.data().asnumpy()
        if k.startswith("1."):
            v = (rng.rand(*v.shape) + 0.5 if k.endswith(("gamma", "var"))
                 else rng.randn(*v.shape) * 0.1).astype(np.float32)
            p.set_data(jmx.nd.array(v))
        arrays[k] = v
    tnet.initialize(mx.init.Xavier(), ctx=mx.cpu())
    set_block_params(tnet, arrays, ctx=mx.cpu())
    return jnet, tnet


def _gluon_rounds(pkg, net, ctx, rounds=2):
    """Record -> backward -> Trainer.step ``rounds`` times on one batch:
    per round the output, every gradient and, after the update, every
    parameter (running statistics included), as numpy."""
    rng = np.random.RandomState(6)
    x = pkg.nd.array(rng.randn(B, 3, 8, 8).astype(np.float32), ctx=ctx)
    y = pkg.nd.array(rng.randint(0, CLASSES, B).astype(np.float32),
                     ctx=ctx)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    params = net._collect_params_with_prefix()
    out = []
    for _ in range(rounds):
        with pkg.autograd.record():
            z = net(x)
            L = loss_fn(z, y)
        L.backward()
        grads = {k: p.grad().asnumpy() for k, p in params.items()
                 if p.grad_req != "null"}
        trainer.step(B)
        out.append((z.asnumpy(), grads,
                    {k: p.data().asnumpy() for k, p in params.items()}))
    return out


def test_hybridized_net_matches_reference_hybridized():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    jnet, tnet = _gluon_pair()
    jnet.hybridize()
    tnet.hybridize()
    want = _gluon_rounds(jmx, jnet, jmx.cpu())
    got = _gluon_rounds(mx, tnet, mx.cpu())
    for (z, g, p), (jz, jg, jp) in zip(got, want):
        np.testing.assert_allclose(z, jz, rtol=0,
                                   atol=1e-5 * np.abs(jz).max())
        assert sorted(g) == sorted(jg)
        for k in jg:
            tol = 1e-6 + 1e-5 * np.abs(jg[k]).max()
            np.testing.assert_allclose(g[k], jg[k], rtol=0, atol=tol,
                                       err_msg=k)
        for k in jp:
            np.testing.assert_allclose(p[k], jp[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    # the statistics moved, once a round
    assert not np.allclose(got[0][2]["1.running_mean"],
                           got[1][2]["1.running_mean"])
    assert len(tnet._cached_ops) == 1


def test_hybridize_signature_cache():
    """One entry per (shape, training, recording) signature, reused on a
    repeat call; ``hybridize()`` drops them and ``hybridize(False)``
    runs the block op by op (the same values)."""
    import mxnet_tpu_torch as mx
    _, net = _gluon_pair()
    ctx = mx.cpu()
    x4 = mx.nd.array(np.ones((4, 3, 8, 8), np.float32), ctx=ctx)
    x2 = mx.nd.array(np.ones((2, 3, 8, 8), np.float32), ctx=ctx)
    want = net(x4).asnumpy()
    net.hybridize()
    got = net(x4).asnumpy()
    np.testing.assert_array_equal(got, want)
    (entry,) = net._cached_ops.entries.values()
    net(x4)
    assert list(net._cached_ops.entries.values()) == [entry]
    net(x2)
    with mx.autograd.train_mode():
        net(x4)
    with mx.autograd.record():
        net(x4)
    assert len(net._cached_ops) == 4
    sigs = list(net._cached_ops.entries)
    assert [s[1:3] for s in sigs] == [(False, False), (False, False),
                                      (True, False), (True, True)]
    # each child ran inside its parent's entry, not through its own
    assert all(c._cached_ops is None for c in net._children.values())
    net.hybridize()
    assert net._cached_ops is None
    now = net(x4).asnumpy()          # the statistics moved twice above
    net.hybridize(False)
    np.testing.assert_array_equal(net(x4).asnumpy(), now)


def test_hybridize_resolves_deferred_init_without_moving_stats():
    """Shapes left to the first call: the probe that resolves them
    moves no running statistic, so a training call moves them exactly
    once, as the same call on an eager twin does."""
    import mxnet_tpu_torch as mx
    ctx = mx.cpu()
    outs = []
    for hybrid in (False, True):
        net = mx.gluon.nn.HybridSequential(prefix="d_")
        with net.name_scope():
            net.add(mx.gluon.nn.Conv2D(4, 3), mx.gluon.nn.BatchNorm(),
                    mx.gluon.nn.Dense(3))
        np.random.seed(7)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        if hybrid:
            net.hybridize()
        x = mx.nd.array(np.random.RandomState(8).randn(2, 2, 6, 6)
                        .astype(np.float32), ctx=ctx)
        with mx.autograd.train_mode():
            y = net(x)
        outs.append((y.asnumpy(), net[1].running_mean.data().asnumpy(),
                     net[1].running_var.data().asnumpy()))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert np.abs(outs[1][1]).sum() > 0


def test_shape_resolve_scope_writes_nothing_back():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.registry import shape_resolve_scope
    ctx = mx.cpu()
    x = mx.nd.array(np.arange(8, dtype=np.float32).reshape(4, 2), ctx=ctx)
    mean, var = mx.nd.zeros((2,), ctx=ctx), mx.nd.ones((2,), ctx=ctx)
    g, b = mx.nd.ones((2,), ctx=ctx), mx.nd.zeros((2,), ctx=ctx)
    with mx.autograd.train_mode(), shape_resolve_scope():
        mx.nd.BatchNorm(x, g, b, mean, var)
    assert mean.asnumpy().sum() == 0 and var.asnumpy().sum() == 2
    with mx.autograd.train_mode():
        mx.nd.BatchNorm(x, g, b, mean, var)
    assert mean.asnumpy().sum() != 0


def test_hybridize_restores_parameter_bindings():
    """Building and running an entry rebinds each parameter to an
    NDArray over its tensor and puts the binding back: the same
    NDArray objects, the same tensors, the gradient hooks in place."""
    import mxnet_tpu_torch as mx
    _, net = _gluon_pair()
    params = list(net.collect_params().values())
    before = [(p._data, p.data(), p.data()._data) for p in params]
    net.hybridize()
    x = mx.nd.array(np.ones((4, 3, 8, 8), np.float32), ctx=mx.cpu())
    with mx.autograd.record():
        L = net(x).sum()
    L.backward()
    for p, (d, arr, t) in zip(params, before):
        assert p._data is d and p.data() is arr and p.data()._data is t
    assert np.abs(net[0].weight.grad().asnumpy()).sum() > 0


def _twice_in_one_record(mx, net, ctx, rounds=2, split=False):
    """Per round: the block called on two batches inside one record
    scope, a predict-mode call between those forwards and the backward
    of both losses, then ``Trainer.step``; the outputs, every gradient
    and, after the update, every parameter (running statistics
    included).  ``split``: each loss's backward on its own, into
    ``grad_req="add"`` buffers zeroed each round, so each parameter's
    gradient is the sum of the two calls' gradients, each complete."""
    rng = np.random.RandomState(9)
    xs = [mx.nd.array(rng.randn(B, 3, 8, 8).astype(np.float32), ctx=ctx)
          for _ in range(3)]
    ys = [mx.nd.array(rng.randint(0, CLASSES, B).astype(np.float32),
                      ctx=ctx) for _ in range(2)]
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = net._collect_params_with_prefix()
    if split:
        for p in params.values():
            if p.grad_req != "null":
                p.grad_req = "add"
    out = []
    for _ in range(rounds):
        if split:
            net.collect_params().zero_grad()
        with mx.autograd.record():
            z1, z2 = net(xs[0]), net(xs[1])
            losses = [loss_fn(z1, ys[0]), loss_fn(z2, ys[1])]
            if not split:
                losses = [losses[0] + losses[1]]
            with mx.autograd.pause():
                zp = net(xs[2])
        for L in losses:
            L.backward()
        grads = {k: p.grad().asnumpy() for k, p in params.items()
                 if p.grad_req != "null"}
        trainer.step(B)
        out.append(([z.asnumpy() for z in (z1, z2, zp)], grads,
                     {k: p.data().asnumpy() for k, p in params.items()}))
    return out


def _same_rounds(got, want):
    for (z, g, p), (wz, wg, wp) in zip(got, want):
        for a, b in zip(z, wz):
            np.testing.assert_array_equal(a, b)
        assert sorted(g) == sorted(wg)
        for k in wg:
            np.testing.assert_array_equal(g[k], wg[k], err_msg=k)
        for k in wp:
            np.testing.assert_array_equal(p[k], wp[k], err_msg=k)


def test_hybridize_one_replica_per_pending_forward():
    """A recorded call takes a replica of its entry that owes no
    backward: the same block called twice before one backward uses two
    (each keeps its own saved activations on the card), the next round
    reuses them, and a forward whose outputs are dropped without a
    backward frees its replica.  The values equal the block run op by
    op (bit for bit on the CPU, where both run the same ops)."""
    import gc
    import mxnet_tpu_torch as mx
    runs = []
    for hybrid in (False, True):
        _, net = _gluon_pair()
        net.hybridize(hybrid)
        runs.append(_twice_in_one_record(mx, net, mx.cpu()))
    _same_rounds(runs[1], runs[0])
    entries = [e for e in net._cached_ops.entries.values() if e.recording]
    assert len(entries) == 1 and len(entries[0].replicas) == 2
    x = mx.nd.array(np.ones((B, 3, 8, 8), np.float32), ctx=mx.cpu())
    with mx.autograd.record():
        z = net(x)
    assert [r.busy() for r in entries[0].replicas] == [True, False]
    del z
    gc.collect()
    assert not any(r.busy() for r in entries[0].replicas)


def test_hybridize_rebuilds_after_reset_ctx():
    """``reset_ctx`` gives each parameter new arrays (the reference's
    ``Parameter.reset_ctx``): the entry bound to the old tensors is
    built again over the new ones, with the same values out."""
    import mxnet_tpu_torch as mx
    _, net = _gluon_pair()
    net.hybridize()
    x = mx.nd.array(np.ones((B, 3, 8, 8), np.float32), ctx=mx.cpu())
    before = net(x).asnumpy()
    (entry,) = net._cached_ops.entries.values()
    old = net[0].weight.data()._data
    net.collect_params().reset_ctx(mx.cpu())
    assert net[0].weight.data()._data is not old
    np.testing.assert_array_equal(net[0].weight.data().asnumpy(),
                                  old.detach().numpy())
    np.testing.assert_array_equal(net(x).asnumpy(), before)
    (rebuilt,) = net._cached_ops.entries.values()
    assert rebuilt is not entry
    assert rebuilt.bound[0] is net[0].weight.data()._data
    with mx.autograd.record():
        L = net(x).sum()
    L.backward()
    assert np.abs(net[0].weight.grad().asnumpy()).sum() > 0


# ---------------------------------------------------------------- serving --
def test_engine_static_staging_token_identical():
    """The engine stages every step into its one static buffer and runs
    it through its (CPU: eager) program: f32 greedy tokens identical to
    the reference's ``generate``; the op-by-op switch gives the same."""
    import jax.numpy as jnp
    from mxnet_tpu.models import gpt
    from mxnet_tpu_torch.serving import ServingEngine
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, 12)
    rng = np.random.RandomState(2)
    shapes = [(5, 6), (3, 9), (8, 4), (2, 7)]
    prompts = [rng.randint(1, 90, P) for P, _ in shapes]
    runs = []
    for eager in (False, True):
        eng = ServingEngine(to_port(tree), tcfg, num_slots=2, page_size=4,
                            prefill_chunk=5, device="cpu")
        eng._eager = eager
        rids = [eng.submit(p, n) for p, (_, n) in zip(prompts, shapes)]
        outs = eng.run()
        runs.append([outs[r] for r in rids])
        assert len(eng._graphs) == (0 if eager else 1)
        assert eng._dev.dtype == torch.int32
    for p, (_, n), got, same in zip(prompts, shapes, *runs):
        want = np.asarray(gpt.generate(tree, jcfg, jnp.asarray(p)[None],
                                       n))[0]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(same, want)


# ------------------------------------------------------------------ train --
def test_train_step_signatures_match_reference():
    """The BERT step through its static batch buffers, alternating two
    batch shapes (one entry each), against the reference's step:
    losses 1e-5, parameters 5e-6 (``tests/test_torch_train.py``)."""
    import jax
    import jax.numpy as jnp
    import optax
    from mxnet_tpu.kernels import flash_attention as JFA
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.convert import to_numpy
    from mxnet_tpu_torch.models import transformer as T
    base = dict(d_model=128, n_heads=2, d_ff=256, vocab_size=256,
                max_len=128, dtype="float32", dropout=0.0, remat=False,
                use_flash=False)
    jcfg = JT.bert_tiny(**base)
    tcfg = T.TransformerConfig(**dataclasses.asdict(jcfg))
    tree = numpy_params(jcfg, 1)
    rng = np.random.RandomState(3)
    batches = []
    for L in (64, 32):
        tokens = rng.randint(1, 256, (2, L)).astype(np.int32)
        labels = np.where(rng.rand(2, L) < 0.2, tokens, -100) \
            .astype(np.int32)
        batches.append(dict(tokens=tokens, labels=labels))
    tx = optax.adamw(1e-4, weight_decay=0.01, b1=0.9, b2=0.999, eps=1e-6)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = (params, tx.init(params))
    _, jstep = JT.make_train_step(jcfg)
    init_state, step = T.make_train_step(tcfg, device="cpu")
    state = init_state(params=to_port(tree))
    old = JFA._INTERPRET
    JFA._INTERPRET = True
    try:
        for i, batch in enumerate(batches * 2):
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            jstate, jl = jstep(jstate, jb, jax.random.PRNGKey(i))
            state, tl = step(state, batch, None)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                       atol=1e-5)
    finally:
        JFA._INTERPRET = old
    assert len(step._graphs) == 2
    got = jax.tree_util.tree_leaves(to_numpy(state[0]))
    want = jax.tree_util.tree_leaves(jax.device_get(jstate[0]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-6)


def test_warm_up_snapshot_leaves_no_trace():
    """What a captured step's warm-up runs inside: an eager step moves
    the parameters, creates the AdamW state and advances the generator;
    ``_restored`` puts back all three (the new AdamW state zeroed, its
    initial value), so the next step equals a first step."""
    from mxnet_tpu_torch.convert import tree_leaves
    from mxnet_tpu_torch.models import transformer as T
    cfg = T.bert_tiny(dtype="float32", dropout=0.1, remat=False,
                      use_flash=False)
    init_state, step = T.make_train_step(cfg, device="cpu")
    rng = np.random.RandomState(4)
    tokens = rng.randint(1, 1024, (2, 16))
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(np.where(rng.rand(2, 16) < 0.3,
                                                 tokens, -100))}
    runs = []
    for warm in (False, True):
        params, opt = init_state(seed=0)
        gen = torch.Generator().manual_seed(5)
        leaves = tree_leaves(params)
        if warm:
            with T._restored(leaves, opt, gen):
                step._eager_step(params, opt, batch, gen)
            assert all(float(v.abs().sum()) == 0 for p in leaves
                       for v in opt.state[p].values())
        _, loss = step((params, opt), batch, gen)
        runs.append((float(loss), [p.detach().clone() for p in leaves],
                     gen.get_state()))
    (l0, p0, g0), (l1, p1, g1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(g0, g1)


# ------------------------------------------------------------ on the card --
def _engine_tokens(params, cfg, dev, eager, kv_int8=False):
    from mxnet_tpu_torch.serving import ServingEngine
    eng = ServingEngine(params, cfg, num_slots=3, page_size=8,
                        prefill_chunk=6, kv_int8=kv_int8, device=dev)
    eng._eager = eager
    rng = np.random.RandomState(1)
    rids = [eng.submit(rng.randint(1, 200, P), n)
            for P, n in [(5, 9), (12, 4), (3, 15), (9, 7), (20, 5)]]
    outs = eng.run()
    return [outs[r] for r in rids], eng


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv_int8", [("float32", False),
                                           ("bfloat16", False),
                                           ("bfloat16", True)])
def test_engine_captured_equals_eager(cuda_device, dtype, kv_int8):
    """Token for token, the captured engine step against the same step
    run op by op on the card; the paged kernel counted once a layer a
    step under replay; the warm-up wrote only scratch page 0."""
    from mxnet_tpu_torch.kernels import paged_attention as PA
    from mxnet_tpu_torch.models import gpt as G
    cfg = G.gpt_tiny(d_model=128, n_heads=2, vocab_size=256, max_len=64,
                     dtype=dtype, dropout=0.0)
    params = G.init_params(3, cfg, device=cuda_device)
    want, _ = _engine_tokens(params, cfg, cuda_device, True, kv_int8)
    PA.paged_attention.launches = 0
    got, eng = _engine_tokens(params, cfg, cuda_device, False, kv_int8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(eng._graphs) == 1
    assert PA.paged_attention.launches == \
        eng.stats["steps"] * cfg.n_layers


def _train_runs(gpt, dev, eager, steps=3, shapes=(64,), remat=False):
    """``steps`` steps per batch shape from one seed: losses, then the
    parameters, the AdamW state and the generator state after them.
    ``remat``: False, True (the "nothing" policy) or "dots"."""
    from mxnet_tpu_torch.convert import tree_leaves
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.models import transformer as T
    kw = dict(d_model=128, n_heads=2, d_ff=256, vocab_size=256,
              max_len=128, dropout=0.1, remat=bool(remat),
              remat_policy="dots" if remat == "dots" else "nothing")
    if gpt:
        init_state, step = G.make_train_step(G.gpt_tiny(**kw), device=dev)
    else:
        init_state, step = T.make_train_step(T.bert_tiny(**kw), device=dev)
    step._eager = eager
    state = init_state(seed=2)
    gen = torch.Generator(device=dev).manual_seed(9)
    rng = np.random.RandomState(4)
    losses = []
    for L in shapes:
        tokens = rng.randint(1, 256, (2, L))
        mask = np.ones((2, L), bool)
        mask[1, L - 9:] = False
        batch = {"tokens": tokens, "mask": mask}
        if not gpt:
            batch["labels"] = np.where(rng.rand(2, L) < 0.2, tokens, -100)
        for _ in range(steps):
            state, loss = step(state, batch, gen)
            losses.append(loss)
    params, opt = state
    leaves = tree_leaves(params)
    return (torch.stack(losses).cpu(), [p.detach().cpu() for p in leaves],
            [v.cpu() for p in leaves for v in opt.state[p].values()],
            gen.get_state(), step)


@pytest.mark.cuda
@pytest.mark.parametrize("gpt,remat", [(False, False), (True, False),
                                       (False, True), (False, "dots"),
                                       (True, "dots")])
def test_train_steps_captured_equal_eager(cuda_device, gpt, remat):
    """3 steps with dropout 0.1 (bf16, flash kernels), then 3 at a
    second batch shape, captured against eager from one seed: losses,
    parameters, AdamW state and the generator's state bit for bit (so
    replay k drew eager step k's dropout, and the warm-ups drew
    nothing); one graph per shape; each flash kernel counted once a
    layer a step (the remat recompute adds one forward a layer, under
    the "nothing" and the "dots" policy alike)."""
    from mxnet_tpu_torch.kernels import flash_attention as FA
    want = _train_runs(gpt, cuda_device, True, shapes=(64, 32),
                       remat=remat)
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        getattr(FA, k).launches = 0
    got = _train_runs(gpt, cuda_device, False, shapes=(64, 32),
                      remat=remat)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(a, b)
    assert torch.equal(got[3], want[3])
    assert len(got[4]._graphs) == 2
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        per_layer = 2 if remat and k == "flash_fwd" else 1
        assert getattr(FA, k).launches == 6 * 2 * per_layer, k


def _card_resnet(mx, ctx, hybrid, arrays):
    """A thumbnail ResNet-18 on ``ctx`` with the weights ``arrays``."""
    from mxnet_tpu_torch.convert import set_block_params
    net = mx.gluon.model_zoo.vision.resnet18_v1(classes=CLASSES,
                                                thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    set_block_params(net, arrays, ctx=ctx)
    net.hybridize(hybrid)
    return net


def _resnet_arrays(mx):
    """Seeded weights of a thumbnail ResNet-18, by structural name."""
    np.random.seed(3)
    ref = mx.gluon.model_zoo.vision.resnet18_v1(classes=CLASSES,
                                                thumbnail=True)
    ref.initialize(mx.init.Xavier(), ctx=mx.cpu())
    ref(mx.nd.array(np.zeros((1, 3, 8, 8), np.float32), ctx=mx.cpu()))
    return {k: v.data().asnumpy()
            for k, v in ref._collect_params_with_prefix().items()}


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
def test_hybridized_resnet_captured_equals_eager(cuda_device,
                                                 deterministic_cudnn):
    """A hybridized thumbnail ResNet-18 on the card against the same net
    op by op (``hybridize(False)``), from the same weights: two rounds
    of record -> backward -> Trainer.step and a predict-mode call, bit
    for bit in outputs, gradients, parameters and running statistics."""
    import mxnet_tpu_torch as mx
    ctx = mx.gpu(0)
    arrays = _resnet_arrays(mx)
    runs = []
    for hybrid in (False, True):
        net = _card_resnet(mx, ctx, hybrid, arrays)
        got = _gluon_rounds(mx, net, ctx)
        x = mx.nd.array(np.ones((B, 3, 8, 8), np.float32), ctx=ctx)
        runs.append((got, net(x).asnumpy()))
    (want, want_p), (got, got_p) = runs
    np.testing.assert_array_equal(got_p, want_p)
    for (z, g, p), (wz, wg, wp) in zip(got, want):
        np.testing.assert_array_equal(z, wz)
        for k in wg:
            np.testing.assert_array_equal(g[k], wg[k], err_msg=k)
        for k in wp:
            np.testing.assert_array_equal(p[k], wp[k], err_msg=k)


@pytest.mark.cuda
def test_train_step_takes_a_new_state(cuda_device):
    """One step driven with state A, then a fresh state B, then A again:
    each change of state drops the cached graphs (and their pool) and
    captures again; the losses equal the same sequence run op by op."""
    from mxnet_tpu_torch.models import transformer as T
    cfg = T.bert_tiny(d_model=128, n_heads=2, d_ff=256, vocab_size=256,
                      dropout=0.0, remat=False)
    rng = np.random.RandomState(6)
    tokens = rng.randint(1, 256, (2, 32))
    batch = {"tokens": tokens,
             "labels": np.where(rng.rand(2, 32) < 0.3, tokens, -100)}
    runs = []
    for eager in (True, False):
        init_state, step = T.make_train_step(cfg, device=cuda_device)
        step._eager = eager
        a, b = init_state(seed=1), init_state(seed=2)
        runs.append(torch.stack([step(s, batch, None)[1]
                                 for s in (a, a, b, a)]).cpu())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_hybridized_block_twice_in_one_record(cuda_device,
                                              deterministic_cudnn):
    """``L = loss(net(x1)) + loss(net(x2))`` with a predict-mode call of
    the same net before the backward (a GAN discriminator on real and
    fake batches): on the card the two recorded calls replay two
    replicas, each with its own saved activations and memory pool.
    Outputs, gradients, parameters and running statistics, over two
    rounds, bit for bit against the net run op by op with each loss's
    backward on its own, its gradients summed per parameter: a
    replica's backward graph returns its call's whole gradient, so a
    parameter used twice in one call (BatchNorm's gamma, in the scale
    and the shift) has its two uses summed before the two calls are
    (one backward of the sum op by op adds the four uses in another
    order, 1-2 ulp apart).  A backward that read the other call's
    activations would differ by far more."""
    import mxnet_tpu_torch as mx
    arrays = _resnet_arrays(mx)
    ctx = mx.gpu(0)
    runs = []
    for hybrid in (False, True):
        net = _card_resnet(mx, ctx, hybrid, arrays)
        runs.append(_twice_in_one_record(mx, net, ctx, split=not hybrid))
    _same_rounds(runs[1], runs[0])
    (entry,) = [e for e in net._cached_ops.entries.values()
                if e.recording]
    assert len(entry.replicas) == 2
    assert all(r.graphed is not None for r in entry.replicas)


@pytest.mark.cuda
def test_hybridize_follows_reset_ctx_to_the_card(cuda_device,
                                                 deterministic_cudnn):
    """A hybridized block called on the CPU, then moved to the card with
    ``reset_ctx`` and no new ``hybridize()``: the card's entries are
    captured (a forward graph, a recorded replica), not run op by op,
    and equal the same net op by op on the card."""
    import mxnet_tpu_torch as mx
    arrays = _resnet_arrays(mx)
    x = np.random.RandomState(2).randn(B, 3, 8, 8).astype(np.float32)
    y = mx.nd.array(np.arange(B, dtype=np.float32), ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs = []
    for hybrid in (False, True):
        net = _card_resnet(mx, mx.cpu(), hybrid, arrays)
        net(mx.nd.array(x, ctx=mx.cpu()))
        net.collect_params().reset_ctx(mx.gpu(0))
        xg = mx.nd.array(x, ctx=mx.gpu(0))
        z = net(xg).asnumpy()
        with mx.autograd.record():
            L = loss_fn(net(xg), y)
        L.backward()
        runs.append((z, net.features[0].weight.grad().asnumpy()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    card = [e for e in net._cached_ops.entries.values()
            if e.device.type == "cuda"]
    assert len(card) == 2
    for e in card:
        if e.recording:
            assert e.replicas and e.replicas[0].graphed is not None
        else:
            assert e.program.graph is not None


def _stream_mismatch_warnings():
    """In this process (torch warns of an accumulator's stream once per
    process): an eager backward whose loss stays referenced, then
    ``hybridize()`` and two recorded rounds; prints how many warnings
    of a gradient accumulator on another stream torch gave."""
    import warnings
    import mxnet_tpu_torch as mx
    ctx = mx.gpu(0)
    net = _card_resnet(mx, ctx, False, _resnet_arrays(mx))
    x = mx.nd.array(np.ones((B, 3, 8, 8), np.float32), ctx=ctx)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with mx.autograd.record():
            kept = net(x).sum()
        kept.backward()
        net.hybridize()
        _gluon_rounds(mx, net, ctx)
    print(sum("AccumulateGrad" in str(w.message) for w in seen))


@pytest.mark.cuda
def test_hybridize_captures_after_eager_backward(cuda_device,
                                                 deterministic_cudnn):
    """An eager backward, then ``hybridize()`` while its loss (and so its
    autograd graph, with the parameters' gradient accumulators made on
    the default stream) is still referenced: the capture succeeds and
    the rounds equal the net op by op, bit for bit; and, in a fresh
    process, torch warns of no accumulator on another stream, in the
    capture or the replays."""
    import os
    import subprocess
    import sys
    import mxnet_tpu_torch as mx
    arrays = _resnet_arrays(mx)
    ctx = mx.gpu(0)
    runs = []
    for hybrid in (False, True):
        net = _card_resnet(mx, ctx, False, arrays)
        x = mx.nd.array(np.ones((B, 3, 8, 8), np.float32), ctx=ctx)
        with mx.autograd.record():
            kept = net(x).sum()
        kept.backward()
        net.hybridize(hybrid)
        runs.append(_gluon_rounds(mx, net, ctx))
        del kept
    _same_rounds([([z], g, p) for z, g, p in runs[1]],
                 [([z], g, p) for z, g, p in runs[0]])
    here = os.path.dirname(os.path.abspath(__file__))
    got = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path[:0] = [%r, %r]; "
         "import test_torch_compiled_steps as T; "
         "T._stream_mismatch_warnings()" % (os.path.dirname(here), here)],
        capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.split()[-1] == "0", got.stdout
