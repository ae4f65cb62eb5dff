"""The port's in-process stores (``mxnet_tpu_torch/kvstore/``), 2-bit
compression (``parallel/compression.py``) and the Gluon ``Trainer`` over
several contexts against the reference's, on the CPU.

The port's ``cpu(i)`` contexts stand for the reference's ``tpu(i)``
(virtual CPU devices here).  Each case feeds both packages the same
numpy values:

* the ``local``/``device`` sums run left to right in both, and a stacked
  ``ici`` sum adds its rows in order in both (XLA:CPU's reduce over the
  stacked axis and torch's ``sum(dim=0)``): bit for bit;
* updates on the store run the reference with ``jax_disable_jit``
  (XLA:CPU contracts a jitted update into FMAs): bit for bit in f32;
* the 2-bit codec is numpy in both: payload bytes and residuals bit
  for bit;
* a Trainer run (Dense, BatchNorm over 16 samples a context, Dense)
  does forward and backward in each package's own ops (matmul sums in
  their own orders): weights and gradients within rtol 1e-5, atol 1e-6
  (measured: weights 1.2e-7 apart at most after 3 steps, first
  gradients 3.3e-7).

The first Trainer case is the fault the port had: every CPU array
reported ``cpu(0)``, so a ``[cpu(0), cpu(1)]`` model ran both halves of
the batch on ``cpu(0)``'s weights and ``cpu(1)``'s gradient stayed 0.
The ``cuda`` cases hold the stores on the card (values on ``gpu(0)`` and
the host) to a torch sum.
"""
import contextlib
import os
import tempfile

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

RTOL, ATOL = 1e-5, 1e-6


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _same(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


@contextlib.contextmanager
def _unjitted():
    import jax
    jax.config.update("jax_disable_jit", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_jit", False)


def _pkg(name):
    """(package, its context maker standing for device i)."""
    return (R, R.tpu) if name == "ref" else (P, P.cpu)


def _port(case, *args):
    """``case`` run on the port with ``cpu()`` as the default context."""
    with P.cpu():
        return case(*args, "port")


def _vals(n, shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


# --- local / device ------------------------------------------------------
def case_device_store(kind, which):
    mx, dev = _pkg(which)
    kv = mx.kv.create(kind)
    vals = _vals(3, (5, 4), 0)
    kv.init("w", mx.nd.zeros((5, 4), ctx=dev(0)))
    kv.push("w", [mx.nd.array(v, ctx=dev(i)) for i, v in enumerate(vals)])
    outs = [mx.nd.zeros((5, 4), ctx=dev(i)) for i in (0, 1)]
    kv.pull("w", out=outs)
    res = {"push_pull_%d" % i: o.asnumpy() for i, o in enumerate(outs)}
    kv.pushpull("w", [mx.nd.array(v, ctx=dev(2 - i))
                      for i, v in enumerate(vals[:2])], out=outs[1])
    res["pushpull"] = outs[1].asnumpy()
    b = mx.nd.zeros((3,), ctx=dev(1))
    kv.broadcast("b", mx.nd.array(vals[2][0, :3], ctx=dev(0)), out=b)
    res["broadcast"] = b.asnumpy()
    res["ctx"] = str(b.context)
    with pytest.raises(mx.MXNetError, match="not initialized"):
        kv.push("nope", mx.nd.ones((2,)))
    return res


@pytest.mark.parametrize("kind", ["local", "device", "nccl"])
def test_device_store_matches_reference(kind):
    got, want = _port(case_device_store, kind), case_device_store(kind, "ref")
    for k in want:
        if k == "ctx":
            assert got[k] == want[k].replace("tpu", "cpu")
        else:
            _same(got[k], want[k])
    kv = P.kv.create(kind)
    assert kv.type == ("device" if kind == "nccl" else kind)
    assert (kv.rank, kv.num_workers) == (0, 1)


def test_kvstore_multi_device_contexts():
    """``tests/test_parallel.py``'s four-device reduce."""
    kv = P.kvstore.create("device")
    vals = [P.nd.ones((4,), ctx=P.cpu(i)) * (i + 1) for i in range(4)]
    kv.init("w", P.nd.zeros((4,), ctx=P.cpu()))
    kv.push("w", vals)
    out = P.nd.zeros((4,), ctx=P.cpu())
    kv.pull("w", out=out)
    assert np.allclose(out.asnumpy(), 1 + 2 + 3 + 4)


def test_server_side_sgd_bit_for_bit():
    """``set_optimizer``: the store runs SGD (momentum, wd) on the sum of
    two contexts' values, three rounds; the states save and load."""
    def run(which, path):
        mx, dev = _pkg(which)
        kv = mx.kv.create("device")
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                          wd=1e-3, rescale_grad=0.5))
        w0, = _vals(1, (6, 3), 1)
        kv.init(3, mx.nd.array(w0, ctx=dev(0)))
        out = mx.nd.zeros((6, 3), ctx=dev(0))
        for step in range(3):
            g = _vals(2, (6, 3), 10 + step)
            kv.push(3, [mx.nd.array(v, ctx=dev(i)) for i, v in enumerate(g)])
        kv.pull(3, out=out)
        kv.save_optimizer_states(path)
        kv.load_optimizer_states(path)
        return out.asnumpy(), kv._updater.states[3].asnumpy()

    with tempfile.TemporaryDirectory() as d:
        got = run("port", os.path.join(d, "p.states"))
        with _unjitted():
            want = run("ref", os.path.join(d, "r.states"))
    _same(got[0], want[0])
    _same(got[1], want[1])


# --- row_sparse (tests/test_sparse.py's kvstore cases) --------------------
def case_sparse(which):
    mx, _ = _pkg(which)
    sp, nd = mx.nd.sparse, mx.nd
    res = {}
    store = mx.kv.create("local")
    shape = (8, 2)
    store.init("w", nd.zeros(shape))
    g1 = sp.row_sparse_array((np.ones((2, 2), np.float32), [0, 3]),
                             shape=shape)
    g2 = sp.row_sparse_array((np.full((2, 2), 0.25, np.float32), [3, 6]),
                             shape=shape)
    store.push("w", [g1, g2])
    out = sp.zeros("row_sparse", shape)
    store.row_sparse_pull("w", out=out, row_ids=nd.array([0, 3]))
    res["pull_rows"] = (out.stype, sorted(np.asarray(
        out.indices.asnumpy()).tolist()), out.asnumpy())
    dense = nd.zeros(shape)
    store.pull("w", out=dense)
    res["dense_pull"] = dense.asnumpy()

    store = mx.kv.create("local")           # no aliasing of the push
    store.init("w", sp.zeros("row_sparse", (4, 3)))
    g = sp.row_sparse_array((np.ones((1, 3), np.float32), [1]),
                            shape=(4, 3))
    store.push("w", g)
    g._set_data(g._data * 99)
    out = nd.zeros((4, 3))
    store.pull("w", out=out)
    res["no_alias"] = out.asnumpy()

    store = mx.kv.create("local")           # dense store keeps zero rows
    w = np.zeros((5, 2), np.float32)
    w[3] = 7.0
    store.init("w", nd.array(w))
    out = sp.zeros("row_sparse", (5, 2))
    store.row_sparse_pull("w", out=out, row_ids=nd.array([1, 3]))
    res["dense_store_rows"] = (sorted(np.asarray(
        out.indices.asnumpy()).tolist()), out.asnumpy())
    store.row_sparse_pull("w", out=out, row_ids=[4, 1])
    res["list_row_ids"] = sorted(np.asarray(out.indices.asnumpy()).tolist())

    store = mx.kv.create("local")           # lazy SGD on a sparse weight
    store.init("w", sp.row_sparse_array(
        (np.ones((4, 3), np.float32), np.arange(4, dtype=np.int32)),
        shape=(4, 3)))
    store.set_optimizer(mx.optimizer.SGD(learning_rate=0.1))
    store.push("w", sp.row_sparse_array(
        (np.ones((1, 3), np.float32), np.array([1], np.int32)),
        shape=(4, 3)))
    out = sp.zeros("row_sparse", (4, 3))
    store.row_sparse_pull("w", out=out, row_ids=nd.array([1, 2]))
    res["server_lazy_sgd"] = out.asnumpy()

    store = mx.kv.create("local")
    store.init("c", sp.zeros("csr", (4, 3)))
    with pytest.raises(mx.MXNetError):
        store.push("c", sp.row_sparse_array(
            (np.ones((1, 3), np.float32), np.array([1], np.int32)),
            shape=(4, 3)))
    return res


def test_row_sparse_push_and_pull_match_reference():
    got, want = _port(case_sparse), case_sparse("ref")
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, tuple):
            assert g[:-1] == w[:-1], k
            g, w = g[-1], w[-1]
        if isinstance(w, list):
            assert g == w, k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)


# --- ici -------------------------------------------------------------------
def case_ici_bucketing(which):
    mx, dev = _pkg(which)
    rng = np.random.RandomState(1)
    keys = ["a", "b", "c", "d"]
    raw = {k: [rng.randn(64).astype("float32") for _ in range(3)]
           for k in keys}
    res = {}
    for bucket in (4 << 20, 0, 600):         # 600 B: two keys a bucket
        kv = mx.kv.create("ici")
        kv.bucket_bytes = bucket
        for k in keys:
            kv.init(k, mx.nd.zeros((64,)))
        kv.push(keys, [[mx.nd.array(v, ctx=dev(i))
                        for i, v in enumerate(raw[k])] for k in keys])
        outs = {}
        for k in keys:
            o = mx.nd.zeros((64,))
            kv.pull(k, out=o)
            outs[k] = o.asnumpy()
        res[bucket] = (outs, kv.stats()["collectives"])
    return res


def test_ici_bucketing_bit_identical_and_counts_collectives():
    got, want = _port(case_ici_bucketing), case_ici_bucketing("ref")
    assert [got[b][1] for b in got] == [1, 4, 2]
    assert [want[b][1] for b in want] == [1, 4, 2]
    for b in want:
        for k in want[b][0]:
            _same(got[b][0][k], got[4 << 20][0][k])
            _same(got[b][0][k], want[b][0][k])


def case_ici_semantics(which):
    mx, dev = _pkg(which)
    res = {}
    kv = mx.kv.create("ici")
    assert kv.type == "ici"
    v4 = _vals(4, (4,), 2)
    kv.init("w", mx.nd.zeros((4,)))
    kv.push("w", [mx.nd.array(v, ctx=dev(i)) for i, v in enumerate(v4)])
    o1 = mx.nd.zeros((4,), ctx=dev(2))
    kv.pull("w", out=o1)
    res["four"] = o1.asnumpy()
    res["stats"] = kv.stats()["collectives"]
    g = _vals(2, (4096,), 3)
    kv.init("g", mx.nd.zeros((4096,)))
    kv.push("g", [mx.nd.array(v, ctx=dev(i)) for i, v in enumerate(g)])
    out = mx.nd.zeros((4096,))
    kv.pull("g", out=out)
    res["dp2"] = out.asnumpy()
    # one context: no collective; a shared context sums locally first
    kv = mx.kv.create("ici")
    kv.init("w", mx.nd.zeros((2,)))
    kv.push("w", mx.nd.array(v4[0][:2], ctx=dev(0)))
    res["single_stats"] = kv.stats()["collectives"]
    kv.push("w", [mx.nd.array(v[:2], ctx=dev(i)) for i, v in
                  zip((0, 0, 1), v4[1:])])
    kv.pull("w", out=(o := mx.nd.zeros((2,))))
    res["dup"] = o.asnumpy()
    res["dup_stats"] = kv.stats()["collectives"]
    kv = mx.kv.create("ici")                 # the updater on the store
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
    kv.init("w", mx.nd.ones((4,)))
    kv.push("w", [mx.nd.array(v, ctx=dev(i)) for i, v in enumerate(v4[:2])])
    kv.pull("w", out=(o := mx.nd.zeros((4,))))
    res["sgd"] = o.asnumpy()
    assert mx.kv.create("ici_allreduce").type == "ici"
    kv = mx.kv.create("ici")
    kv.init("w", mx.nd.zeros((4, 2)))
    rs = mx.nd.sparse.row_sparse_array((np.ones((1, 2), np.float32), [0]),
                                       shape=(4, 2))
    errs = []
    for fn in (lambda: kv.push("w", [rs, rs]),
               lambda: kv.row_sparse_pull("w", out=mx.nd.zeros((4, 2)),
                                          row_ids=mx.nd.array([0])),
               lambda: kv.set_gradient_compression({"type": "2bit"}),
               lambda: kv.push("nope", mx.nd.ones((2,)))):
        with pytest.raises(mx.MXNetError) as e:
            fn()
        errs.append(str(e.value))
    res["errors"] = errs
    return res


def test_ici_semantics_and_errors_match_reference():
    got = _port(case_ici_semantics)
    with _unjitted():
        want = case_ici_semantics("ref")
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            _same(got[k], want[k])
        else:
            assert got[k] == want[k], k
    assert (got["stats"], got["single_stats"], got["dup_stats"]) == (1, 0, 1)


def test_bucket_bytes_env(monkeypatch):
    from mxnet_tpu_torch.kvstore.ici import ICIKVStore
    monkeypatch.setenv("MXNET_KV_BUCKET_BYTES", "1234")
    assert ICIKVStore().bucket_bytes == 1234
    monkeypatch.setenv("MXNET_KV_BUCKET_BYTES", "-1")
    with pytest.raises(P.MXNetError, match="non-negative integer"):
        ICIKVStore()


def test_values_on_two_cards_are_refused():
    """One card cannot check a reduce over several: such values raise
    (the tensors here only claim two CUDA devices)."""
    from mxnet_tpu_torch.kvstore.kvstore import one_card

    class Fake:
        def __init__(self, i):
            self.is_cuda, self.device = True, torch.device("cuda", i)

    a, b = P.nd.zeros((1,), ctx=P.cpu()), P.nd.zeros((1,), ctx=P.cpu())
    one_card([a, b])
    a._data, b._data = Fake(0), Fake(1)
    with pytest.raises(NotImplementedError, match="7b"):
        one_card([a, b])


# --- horovod ---------------------------------------------------------------
def case_horovod(which):
    mx, dev = _pkg(which)
    kv = mx.kv.create("horovod")
    v = _vals(2, (4,), 4)
    vals = [mx.nd.array(x, ctx=dev(i)) for i, x in enumerate(v)]
    outs = [mx.nd.zeros((4,), ctx=dev(i)) for i in range(2)]
    kv.pushpull("w", vals, out=outs)
    res = {"pushpull%d" % i: o.asnumpy() for i, o in enumerate(outs)}
    kv.broadcast("w", mx.nd.full((4,), 7.0), out=outs)
    res["broadcast"] = outs[1].asnumpy()
    kv.push("k", vals)
    got = mx.nd.zeros((4,))
    kv.pull("k", out=got)
    res["shim"] = got.asnumpy()
    with pytest.raises(mx.MXNetError, match="without a matching push"):
        kv.pull("k", out=got)
    res["meta"] = (kv.type, kv.rank, kv.num_workers,
                   kv.is_capable("dist_sync"), kv.is_capable("x"))

    @mx.kv.KVStoreBase.register("test_external_%s" % which)
    class _Ext:
        def __init__(self):
            self.type, self.calls = "ext", []

        def pushpull(self, key, value, out=None, priority=0):
            self.calls.append(key)
            return value

    ext = mx.kv.create("test_external_%s" % which)
    ext.pushpull("g", mx.nd.ones((1,)))
    res["external"] = ext.calls
    return res


def test_horovod_store_matches_reference():
    got, want = _port(case_horovod), case_horovod("ref")
    for k in want:
        if isinstance(want[k], np.ndarray):
            _same(got[k], want[k])
        else:
            assert got[k] == want[k], k


def test_horovod_refuses_a_job_of_several_processes(monkeypatch):
    from mxnet_tpu_torch.parallel import multihost
    monkeypatch.setattr(multihost, "_initialized", True)
    monkeypatch.setattr(multihost, "num_hosts", lambda: 2)
    with pytest.raises(P.MXNetError, match="2-process job"):
        P.kv.create("horovod")


# --- 2-bit compression -----------------------------------------------------
def test_two_bit_payload_and_residuals_bit_for_bit():
    from mxnet_tpu.parallel import compression as RC
    from mxnet_tpu_torch.parallel import compression as PC
    rng = np.random.RandomState(0)
    pc, rc = PC.TwoBitCompressor(0.1), RC.TwoBitCompressor(0.1)
    for step in range(4):
        g = (rng.randn(1001) * 0.08).astype(np.float32).reshape(7, 143)
        p, r = pc.compress("k", g), rc.compress("k", g)
        assert p == r and len(p[0]) == 251
        _same(pc._residual["k"], rc._residual["k"])
        _same(pc.decompress(*p[:2]), rc.decompress(*r[:2]))
        _same(PC.decompress(p[0], p[1], 0.1), RC.decompress(*r[:2], 0.1))
    assert PC.create_compressor({"type": "2bit"}).threshold == 0.5
    for bad in ({"type": "1bit"}, {"threshold": 0.5, "x": 1}):
        with pytest.raises(ValueError):
            PC.create_compressor(bad)
    with pytest.raises(ValueError):
        PC.TwoBitCompressor(0)


def test_local_compression_residual_keyed_by_context():
    got = {}
    for which in ("port", "ref"):
        mx, dev = _pkg(which)
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.zeros((8,), ctx=dev(0)))
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        g0 = mx.nd.array(np.full((8,), 0.3, "float32"), ctx=dev(0))
        g1 = mx.nd.array(np.full((8,), -0.2, "float32"), ctx=dev(1))
        kv.push("w", [g0, g1])
        kv.push("w", [g1, g0, g0])
        out = mx.nd.zeros((8,), ctx=dev(0))
        kv.pull("w", out=out)
        got[which] = (out.asnumpy(), {k[1:] for k in kv._compressor._residual})
    _same(got["port"][0], got["ref"][0])
    assert got["port"][1] == {("cpu(0)",), ("cpu(1)",), ("cpu(0)", 1)}
    assert {tuple(x.replace("tpu", "cpu") if isinstance(x, str) else x
                  for x in k) for k in got["ref"][1]} == got["port"][1]


def _linear_problem():
    rng = np.random.RandomState(3)
    X = rng.randn(64, 8).astype("float32")
    wt = rng.randn(8, 1).astype("float32")
    return X, X @ wt


def _compressed_training(mx, dev, compress, steps):
    Xh, yh = _linear_problem()
    kv = mx.kv.create("device")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.05))
    if compress:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.2})
    w = mx.nd.zeros((8, 1), ctx=dev(0))
    kv.init("w", w)
    for _ in range(steps):
        kv.pull("w", out=w)
        wn = w.asnumpy()
        grads = [mx.nd.array(1.0 / 32 * Xh[sl].T @ (Xh[sl] @ wn - yh[sl]),
                             ctx=dev(i))
                 for i, sl in enumerate((slice(0, 32), slice(32, 64)))]
        kv.push("w", grads)
    kv.pull("w", out=w)
    return w.asnumpy()


def test_compressed_training_converges():
    """``test_compressed_training_converges``'s twin: the 2-bit reduce
    of two contexts still trains (error feedback) to within 1% of the
    target's energy, like the plain one; its first 5 steps are bit for
    bit the reference's."""
    Xh, yh = _linear_problem()
    base = float(np.mean(yh ** 2))
    for compress, steps in ((False, 150), (True, 400)):
        w = _compressed_training(P, P.cpu, compress, steps)
        assert float(np.mean((Xh @ w - yh) ** 2)) < 0.01 * base, compress
    got = _compressed_training(P, P.cpu, True, 5)
    with _unjitted():
        want = _compressed_training(R, R.tpu, True, 5)
    _same(got, want)


# --- NDArray contexts and the Trainer over two contexts --------------------
def test_arrays_keep_the_cpu_context_they_were_made_on():
    c1 = P.cpu(1)
    a = P.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=c1)
    assert a.context == c1
    for b in (a + 1, a * a, a.reshape((3, 2)), a[0], a.copy(),
              a.astype("float64"), P.nd.relu(a), a.T):
        assert b.context == c1
    assert P.nd.zeros((2,), ctx=c1).context == c1
    b = a.as_in_context(P.cpu(0))
    assert b.context == P.cpu(0) and b._data is not a._data
    assert a.as_in_context(c1) is a
    parts = P.gluon.utils.split_and_load(np.ones((4, 2), np.float32),
                                         [P.cpu(0), c1])
    assert [p.context for p in parts] == [P.cpu(0), c1]
    a.attach_grad()
    assert a.grad.context == c1


def _trainer_nets(hybrid):
    """A reference net on tpu(0), tpu(1) and a port twin on cpu(0),
    cpu(1) carrying its weights by structural name."""
    from mxnet_tpu_torch.convert import set_block_params

    def build(mx):
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(8, in_units=12),
                    mx.gluon.nn.BatchNorm(in_channels=8),
                    mx.gluon.nn.Activation("relu"),
                    mx.gluon.nn.Dense(3, in_units=8))
        return net

    np.random.seed(7)
    jnet = build(R)
    jnet.initialize(R.initializer.Xavier(), ctx=[R.tpu(0), R.tpu(1)])
    arrays = {k: v.data().asnumpy()
              for k, v in jnet._collect_params_with_prefix().items()}
    tnet = build(P)
    tnet.initialize(P.init.Xavier(), ctx=[P.cpu(0), P.cpu(1)])
    set_block_params(tnet, arrays)
    if hybrid:
        tnet.hybridize()
    return jnet, tnet


def _trainer_run(mx, dev, net, kvstore, uok, steps=3):
    rng = np.random.RandomState(11)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9,
                           "wd": 1e-3}, kvstore=kvstore,
                          update_on_kvstore=uok)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ctxs = [dev(0), dev(1)]
    grads, losses = [], []
    for _ in range(steps):
        X = rng.randn(32, 12).astype(np.float32)
        Y = rng.randint(0, 3, 32).astype(np.float32)
        with mx.autograd.record():
            Ls = [loss_fn(net(mx.nd.array(X[s], ctx=c)),
                          mx.nd.array(Y[s], ctx=c))
                  for c, s in zip(ctxs, (slice(0, 16), slice(16, 32)))]
        for L in Ls:
            L.backward()
        w = net.collect_params()
        first = [p for p in w.values() if p.grad_req != "null"][0]
        grads.append([first.grad(c).asnumpy().copy() for c in ctxs])
        losses.append([L.asnumpy() for L in Ls])
        tr.step(32)
    params = {k: [v.data(c).asnumpy() for c in ctxs]
              for k, v in net._collect_params_with_prefix().items()}
    return params, grads, losses, tr


@pytest.mark.parametrize("kvstore,uok,hybrid", [
    ("device", False, False), ("device", False, True),
    ("ici", False, False), ("device", True, True), ("ici", True, False)])
def test_trainer_over_two_contexts_matches_reference(kvstore, uok, hybrid):
    """``[cpu(0), cpu(1)]`` against the reference's ``[tpu(0), tpu(1)]``
    (its ``update_on_kvstore=False`` run: see the next test): each
    context's gradient of the first step is its own half's, nonzero, and
    the weights of both contexts match after 3 steps."""
    jnet, tnet = _trainer_nets(hybrid)
    got, g_grads, g_losses, tr = _trainer_run(P, P.cpu, tnet, kvstore, uok)
    want, w_grads, w_losses, _ = _trainer_run(R, R.tpu, jnet, kvstore,
                                              False)
    assert tr._kvstore is not None and tr._kvstore.type == kvstore
    g0, g1 = g_grads[0]
    assert np.abs(g1).max() > 0 and np.abs(g0 - g1).max() > 1e-3
    for g, w in zip(g_grads[0], w_grads[0]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.array(g_losses), np.array(w_losses),
                               rtol=RTOL, atol=ATOL)
    assert got.keys() == want.keys()
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    if kvstore == "ici":
        assert tr._kvstore.stats()["collectives"] > 0


def test_update_on_kvstore_is_the_local_update():
    """MXNet's ``update_on_kvstore``: the store runs SGD on the summed
    gradient and every copy pulls the weights, bit for bit the local
    update.  The reference pulls the updated weights into the gradient
    buffers and updates again on them (``mxnet_tpu/gluon/trainer.py:
    121-124``, ``:142-166``): its run moves the weights by far less."""
    runs = {}
    for uok in (False, True):
        _, tnet = _trainer_nets(False)
        runs[uok] = _trainer_run(P, P.cpu, tnet, "device", uok)
    for k, v in runs[False][0].items():
        for g, w in zip(runs[True][0][k], v):
            _same(g, w)
    tr = runs[True][3]
    with pytest.raises(P.MXNetError, match="updated on kvstore"):
        tr.update(8)
    with pytest.raises(P.MXNetError, match="updated on kvstore"):
        tr.allreduce_grads()
    ref = {}
    for uok in (False, True):
        jnet, _ = _trainer_nets(False)
        ref[uok] = _trainer_run(R, R.tpu, jnet, "device", uok)[0]
    k = sorted(ref[False])[-1]
    assert np.abs(ref[True][k][0] - ref[False][k][0]).max() > 1e-3


def test_trainer_states_through_the_store(tmp_path):
    _, tnet = _trainer_nets(False)
    params, _, _, tr = _trainer_run(P, P.cpu, tnet, "device", True,
                                    steps=1)
    path = str(tmp_path / "t.states")
    tr.save_states(path)
    before = {k: v.asnumpy() for k, v in tr._kvstore._updater.states.items()
              if v is not None}
    tr.load_states(path)
    after = tr._kvstore._updater.states
    assert before and all(np.array_equal(v, after[k].asnumpy())
                          for k, v in before.items())
    assert tr.optimizer.param_dict[0] is tr._params[0]


def test_one_context_makes_no_store_and_compression_reaches_it():
    _, tnet = _trainer_nets(False)
    one = P.gluon.nn.Dense(2, in_units=3)
    one.initialize(ctx=P.cpu())
    tr = P.gluon.Trainer(one.collect_params(), "sgd", kvstore="dist_sync")
    tr.allreduce_grads()
    assert tr._kvstore is None
    tr = P.gluon.Trainer(tnet.collect_params(), "sgd",
                         compression_params={"type": "2bit",
                                             "threshold": 0.25})
    tr.allreduce_grads()
    assert tr._kvstore._compressor.threshold == 0.25


# --- on the card -----------------------------------------------------------
@pytest.mark.cuda
def test_stores_on_the_card_equal_a_torch_sum(cuda_device):
    """Contributions on ``gpu(0)`` and ``cpu(0)``: every store's sum,
    pulled onto the card, is ``v0 + v1`` bit for bit; the ``ici`` store
    counts its buckets and no collective."""
    from mxnet_tpu_torch.kvstore.ici import ICIKVStore
    shapes = [(64, 3, 3, 3), (64,), (1000, 2048), (7,)]
    rng = np.random.RandomState(0)
    a = [P.nd.array(rng.randn(*s).astype(np.float32), ctx=P.gpu(0))
         for s in shapes]
    b = [P.nd.array(rng.randn(*s).astype(np.float32), ctx=P.cpu(0))
         for s in shapes]
    want = [x._data + y._data.cuda() for x, y in zip(a, b)]
    keys = list(range(len(shapes)))
    for kv in (P.kv.create("local"), P.kv.create("device"), ICIKVStore(),
               ICIKVStore(0), ICIKVStore(1 << 20)):
        kv.init(keys, [P.nd.zeros(s, ctx=P.gpu(0)) for s in shapes])
        kv.push(keys, [[x, y] for x, y in zip(a, b)])
        outs = [P.nd.zeros(s, ctx=P.gpu(0)) for s in shapes]
        kv.pull(keys, out=outs)
        assert all(torch.equal(o._data, w) for o, w in zip(outs, want))
        if isinstance(kv, ICIKVStore):
            assert kv.stats()["collectives"] == 0
    hv = P.kv.create("horovod")
    for k in keys:
        out = P.nd.zeros(shapes[k], ctx=P.gpu(0))
        hv.pushpull(k, [a[k], b[k]], out=out)
        assert torch.equal(out._data, want[k])
