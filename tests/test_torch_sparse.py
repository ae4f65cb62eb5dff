"""The port's sparse storage (``mxnet_tpu_torch/ndarray/sparse.py``),
``Parameter.grad_stype``, ``Embedding(sparse_grad=True)`` and the
row-lazy optimizer updates against the reference's, on the CPU.

Every case runs in both packages on the same numpy inputs and returns
named numpy results: storage types, shapes and row or column ids must
be equal, values within rtol 1e-6, atol 1e-7 (gathers, scatters and
copies are exact; a ``dot`` sums at most 9 f32 products a row, in index
order in both packages; an update is a few f32 roundings and a
``sqrt``).  The Trainer cases carry the same initial weights into both
packages and hold the weights and optimizer states after each step to
the same limits.

The first case is the fault the port had before it ported the sparse
path: a ``grad_stype="row_sparse"`` parameter's gradient was updated
densely, so weight decay and momentum moved rows that the batch never
touched.

The ``cuda`` cases run the same cases on the card against the CPU
(``index_add_`` sums with atomics there, so a sum may differ in its
last bits: rtol 1e-6, atol 1e-6) and a Trainer step over
``Embedding(sparse_grad=True)`` on the card against the CPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

RTOL, ATOL = 1e-6, 1e-7


def dense_rand(shape, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(*shape).astype(np.float32)
    return d * (rng.rand(*shape) < density)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _rows(x):
    """(stype, shape, row or column ids) of a sparse result."""
    ids = np.asarray(_np(x.indices)).astype(np.int64)
    return (x.stype, tuple(x.shape), ids.tolist())


# --- the cases, written once against either package ----------------------
def case_create_row_sparse(mx, sp):
    data = np.arange(6, dtype=np.float32).reshape(3, 2)
    rsp = sp.row_sparse_array((data, [1, 4, 0]), shape=(6, 2))
    rsp.check_format()
    return {"rsp": (_rows(rsp), rsp.asnumpy()),
            "data": rsp.data.asnumpy()}


def case_cast_both_ways(mx, sp):
    d = dense_rand((8, 3))
    rsp = mx.nd.array(d).tostype("row_sparse")
    back = rsp.tostype("default")
    csr = mx.nd.array(d).tostype("csr")
    csr.check_format()
    return {"rsp": (_rows(rsp), rsp.asnumpy()),
            "back": (back.stype, back.asnumpy()),
            "csr": (_rows(csr), _np(csr.indptr).tolist(), csr.asnumpy()),
            "csr_back": sp.cast_storage(csr, "default").asnumpy()}


def case_retain(mx, sp):
    d = dense_rand((10, 4), density=0.9, seed=1)
    kept = sp.retain(sp.cast_storage(mx.nd.array(d), "row_sparse"),
                     [0, 3, 7])
    return {"kept": (_rows(kept), kept.asnumpy())}


def case_add_n_merges_rows(mx, sp):
    a = sp.row_sparse_array((np.ones((2, 3), np.float32), [0, 2]),
                            shape=(5, 3))
    b = sp.row_sparse_array((2 * np.ones((2, 3), np.float32), [2, 4]),
                            shape=(5, 3))
    s = sp.add_n(a, b)
    d = a - b
    return {"sum": (_rows(s), s.asnumpy()), "diff": (_rows(d), d.asnumpy())}


def case_scalar_mul_div(mx, sp):
    a = sp.row_sparse_array((np.ones((2, 3), np.float32), [1, 3]),
                            shape=(4, 3))
    b, c = a * 2.5, a / 4.0
    return {"mul": (_rows(b), b.asnumpy()), "div": (_rows(c), c.asnumpy())}


def case_csr_scipy_roundtrip(mx, sp):
    d = dense_rand((6, 5), seed=2)
    csr = mx.nd.array(d).tostype("csr")
    m = csr.asscipy()
    again = sp.csr_matrix(m)
    return {"csr": csr.asnumpy(), "scipy": m.toarray(),
            "again": (_rows(again), again.asnumpy()),
            "triplets": sp.csr_matrix(
                ([1., 2., 3.], [0, 2, 1], [0, 2, 2, 3]),
                shape=(3, 3)).asnumpy(),
            "coo": sp.csr_matrix(([1., 5.], ([0, 2], [1, 0])),
                                 shape=(3, 2)).asnumpy()}


def case_csr_row_slice(mx, sp):
    d = dense_rand((8, 4), seed=3)
    csr = sp.csr_matrix(d)
    sub, one = csr[2:5], csr[6]
    return {"sub": (_rows(sub), sub.asnumpy()),
            "one": (_rows(one), one.asnumpy())}


def case_dot_csr_dense(mx, sp):
    d = dense_rand((7, 9), seed=4)
    rhs = np.random.RandomState(5).randn(9, 3).astype(np.float32)
    out = sp.dot(sp.csr_matrix(d), mx.nd.array(rhs))
    return {"out": (out.stype, out.asnumpy())}


def case_dot_csr_T_dense(mx, sp):
    d = dense_rand((7, 9), seed=6)
    rhs = np.random.RandomState(7).randn(7, 4).astype(np.float32)
    out = sp.dot(sp.csr_matrix(d), mx.nd.array(rhs), transpose_a=True)
    return {"out": (_rows(out), out.asnumpy())}


def case_dot_csr_vector(mx, sp):
    d = np.array([[1, 0, 2], [0, 0, 3]], np.float32)
    csr = sp.csr_matrix(d)
    out = sp.dot(csr, mx.nd.array(np.ones(3, np.float32)))
    out_t = sp.dot(csr, mx.nd.array(np.array([1., 1.], np.float32)),
                   transpose_a=True)
    return {"out": (out.shape, out.asnumpy()),
            "out_t": (_rows(out_t), out_t.asnumpy())}


def case_empty_csr_dot_keeps_dtype(mx, sp):
    csr = sp.zeros("csr", (3, 4), dtype="bfloat16")
    out = sp.dot(csr, mx.nd.ones((3, 2), dtype="bfloat16"), transpose_a=True)
    dense = sp.dot(sp.zeros("csr", (3, 4)), mx.nd.ones((4, 2)))
    return {"dtype": "bfloat16" in str(out.dtype),
            "out": (_rows(out), out.asnumpy().astype(np.float32)),
            "dense": dense.asnumpy()}


def case_csr_elemwise(mx, sp):
    a, b = dense_rand((5, 5), seed=8), dense_rand((5, 5), seed=9)
    ca, cb = sp.csr_matrix(a), sp.csr_matrix(b)
    return {"add": (sp.elemwise_add(ca, cb).stype,
                    sp.elemwise_add(ca, cb).asnumpy()),
            "sub": sp.elemwise_sub(ca, cb).asnumpy(),
            "mul": sp.elemwise_mul(ca, cb).asnumpy()}


def _lazy(mx, sp, name, **kw):
    """One update of a (10, 4) weight from a row_sparse gradient of rows
    1 and 5, and the same update from its dense twin."""
    shape, rows = (10, 4), [1, 5]
    w0 = np.random.RandomState(10).randn(*shape).astype(np.float32)
    g = np.random.RandomState(11).randn(2, 4).astype(np.float32)
    out = {}
    for tag, grad in (("lazy", sp.row_sparse_array((g, rows), shape=shape)),
                      ("dense", None)):
        if grad is None:
            dense = np.zeros(shape, np.float32)
            dense[rows] = g
            grad = mx.nd.array(dense)
        opt = mx.optimizer.create(name, learning_rate=0.1, **kw)
        w = mx.nd.array(w0.copy())
        state = opt.create_state(0, w)
        for _ in range(2):
            opt.update(0, w, grad, state)
        out[tag] = w.asnumpy()
        if state is not None:
            out[tag + "_state"] = [s.asnumpy() for s in (
                state if isinstance(state, tuple) else (state,))]
    return out


def case_sgd_lazy(mx, sp):
    return _lazy(mx, sp, "sgd", wd=0.05)


def case_sgd_momentum_lazy(mx, sp):
    return _lazy(mx, sp, "sgd", momentum=0.9, wd=0.05, clip_gradient=0.5)


def case_adam_lazy(mx, sp):
    return _lazy(mx, sp, "adam", wd=0.05, rescale_grad=0.5)


def case_non_lazy_densifies(mx, sp):
    out = {}
    for name in ("sgd", "adam"):
        opt = mx.optimizer.create(name, learning_rate=0.1, lazy_update=False,
                                  wd=0.1)
        w = mx.nd.array(np.random.RandomState(3).randn(4, 3)
                        .astype(np.float32))
        state = opt.create_state(0, w)
        g = sp.row_sparse_array((np.ones((2, 3), np.float32), [0, 2]),
                                shape=(4, 3))
        opt.update(0, w, g, state)
        out[name] = w.asnumpy()
    return out


def case_growing_row_sparse_weight(mx, sp):
    w = sp.row_sparse_array((np.ones((1, 2), np.float32), np.array([0])),
                            shape=(3, 2))
    g = sp.row_sparse_array((np.ones((1, 2), np.float32), np.array([2])),
                            shape=(3, 2))
    sp.sgd_update(w, g, lr=0.5)
    m = sp.zeros("row_sparse", (3, 2))
    w2 = sp.row_sparse_array((np.ones((2, 2), np.float32), [0, 1]),
                             shape=(3, 2))
    sp.sgd_mom_update(w2, g, m, lr=0.5, momentum=0.9, wd=0.1)
    return {"w": (_rows(w), w.asnumpy()), "w2": (_rows(w2), w2.asnumpy()),
            "m": (_rows(m), m.asnumpy())}


def case_tostype_default_copies(mx, sp):
    a = mx.nd.ones((2, 2))
    b = a.tostype("default")
    b += 1
    return {"a": a.asnumpy(), "b": b.asnumpy()}


CASES = {k[5:]: v for k, v in globals().items() if k.startswith("case_")}


def run(case, pkg, ctx=None):
    """``case`` in ``pkg``; the port inside ``with ctx:`` (default: the
    CPU)."""
    if pkg is P:
        with ctx or P.cpu():
            return case(P, P.nd.sparse)
    return case(pkg, pkg.nd.sparse)


def same(got, want, rtol=RTOL, atol=ATOL, path="out"):
    """Nested results: arrays within tolerance, everything else equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            same(got[k], want[k], rtol, atol, "%s.%s" % (path, k))
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            same(a, b, rtol, atol, "%s[%d]" % (path, i))
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


# --- the fault, first -----------------------------------------------------
def _lookup_net(pkg, ctx, w0, grad_stype="row_sparse"):
    """A HybridBlock whose weight is a ``grad_stype``-gradient parameter
    (``row_sparse`` by default), read by the ``Embedding`` op."""
    class Lookup(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.weight = self.params.get("weight", shape=w0.shape,
                                              grad_stype=grad_stype)

        def hybrid_forward(self, F, x, weight):
            return F.Embedding(x, weight, input_dim=w0.shape[0],
                               output_dim=w0.shape[1])

    net = Lookup(prefix="lookup_")
    net.initialize(ctx=ctx)
    if w0.dtype != np.float32:
        net.cast(w0.dtype.name)
    net.weight.set_data(pkg.nd.array(w0, ctx=ctx, dtype=w0.dtype))
    return net


def _train(pkg, ctx, net, batches, opt, opt_kw):
    trainer = pkg.gluon.Trainer(net.collect_params(), opt, opt_kw)
    seen = []
    for ids, coef in batches:
        x = pkg.nd.array(ids, ctx=ctx)
        c = pkg.nd.array(coef, ctx=ctx, dtype=coef.dtype)
        with pkg.autograd.record():
            loss = (net(x) * c).sum()
        loss.backward()
        trainer.step(len(ids))
        seen.append([p.data().asnumpy() for p in
                     net.collect_params().values()])
    return seen, trainer


def test_grad_stype_row_sparse_touches_only_the_gradient_rows():
    """SGD with momentum and weight decay, two steps: rows 0, 3 and 5
    are never looked up and keep their weights in the reference; the
    port applied decay and momentum to them before the sparse path."""
    w0 = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    rng = np.random.RandomState(1)
    batches = [(np.array([1, 2, 2]), rng.randn(3, 3).astype(np.float32)),
               (np.array([4, 1]), rng.randn(2, 3).astype(np.float32))]
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.1}
    want, _ = _train(R, R.cpu(), _lookup_net(R, R.cpu(), w0), batches,
                     "sgd", kw)
    net = _lookup_net(P, P.cpu(), w0)
    got, _ = _train(P, P.cpu(), net, batches, "sgd", kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(w[0][[0, 3, 5]], w0[[0, 3, 5]])
        same(g, w)
    assert net.weight.grad_stype == "row_sparse"


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_the_reference(name):
    same(run(CASES[name], P), run(CASES[name], R))


def test_lazy_rows_untouched_and_dense_rows_moved():
    """The lazy updates leave every row outside the gradient bit for bit
    (weights and states); their dense twins move them (weight decay)."""
    for name in ("sgd_lazy", "sgd_momentum_lazy", "adam_lazy"):
        out = run(CASES[name], P)
        w0 = np.random.RandomState(10).randn(10, 4).astype(np.float32)
        rest = [r for r in range(10) if r not in (1, 5)]
        np.testing.assert_array_equal(out["lazy"][rest], w0[rest])
        assert np.abs(out["dense"][rest] - w0[rest]).max() > 0
        assert np.abs(out["lazy"][[1, 5]] - w0[[1, 5]]).min() > 0
        for s in out.get("lazy_state", []):
            assert not s[rest].any()


def test_looked_up_row_with_zero_gradient_stays_untouched():
    """Row 2 is looked up but its output is multiplied by 0: its
    gradient is exactly 0, so it is not a row of the row_sparse
    gradient (the reference's rule: the nonzero rows) and Adam leaves
    its weight and both moments alone."""
    w0 = np.random.RandomState(2).randn(6, 3).astype(np.float32)
    coef = np.ones((3, 3), np.float32)
    coef[1] = 0.0
    batches = [(np.array([1, 2, 4]), coef)]
    kw = {"learning_rate": 0.01, "wd": 0.01}
    want, rt = _train(R, R.cpu(), _lookup_net(R, R.cpu(), w0), batches,
                      "adam", kw)
    got, pt = _train(P, P.cpu(), _lookup_net(P, P.cpu(), w0), batches,
                     "adam", kw)
    same(got, want)
    w = got[0][0]
    np.testing.assert_array_equal(w[[0, 2, 3, 5]], w0[[0, 2, 3, 5]])
    assert np.abs(w[[1, 4]] - w0[[1, 4]]).min() > 0
    mean, var = pt._updater.states[0]
    assert not mean.asnumpy()[[0, 2, 3, 5]].any()
    assert not var.asnumpy()[[0, 2, 3, 5]].any()


# Optimizers with no row-lazy branch: a row_sparse gradient reaches
# their ops in its dense form (MXNet's storage fallback), so they update
# exactly as with a dense gradient.  (name, kwargs, weight dtype)
DENSE_FALLBACK = [
    ("sgd", {"momentum": 0.9, "lazy_update": False}, np.float32),
    ("sgd", {"momentum": 0.9, "multi_precision": True}, np.float16),
    ("sgd", {"multi_precision": True}, np.float16),
    ("nag", {"momentum": 0.9}, np.float32),
    ("rmsprop", {}, np.float32),
    ("rmsprop", {"centered": True}, np.float32),
    ("adagrad", {}, np.float32),
    ("ftrl", {}, np.float32),
    ("signum", {}, np.float32),
    ("lamb", {}, np.float32),
    ("lars", {"momentum": 0.9}, np.float32),
    ("adadelta", {}, np.float32),
    ("adamax", {}, np.float32),
    ("nadam", {}, np.float32),
    ("adam", {"lazy_update": False}, np.float32),
]


@pytest.mark.parametrize(
    "opt,kw,dtype", DENSE_FALLBACK,
    ids=["%s-%s-%s" % (o, "-".join(sorted(k)) or "plain", np.dtype(d).name)
         for o, k, d in DENSE_FALLBACK])
def test_row_sparse_gradient_falls_back_to_dense_update(opt, kw, dtype):
    """Three Trainer steps over a ``row_sparse``-gradient lookup equal
    the same steps over a dense-gradient one, bit for bit; the second
    batch is one id, so its gradient has a single row (a compact block
    of shape (1, D), which must not broadcast onto the table)."""
    w0 = np.random.RandomState(6).randn(7, 3).astype(dtype)
    rng = np.random.RandomState(7)
    batches = [(np.array([1, 4, 4]), rng.randn(3, 3).astype(dtype)),
               (np.array([5]), rng.randn(1, 3).astype(dtype)),
               (np.array([0, 4]), rng.randn(2, 3).astype(dtype))]
    kw = dict(kw, learning_rate=0.05, wd=0.01)
    runs = [_train(P, P.cpu(), _lookup_net(P, P.cpu(), w0, stype),
                   batches, opt, kw)[0]
            for stype in ("row_sparse", "default")]
    for g, w in zip(*runs):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[0].dtype == dtype
    assert np.abs(runs[0][1][0][5] - runs[0][0][0][5]).max() > 0


def test_adam_multi_precision_over_row_sparse_stays_lazy():
    """A float16 table under ``multi_precision``: the gradient reaches
    the float32 master copy as row_sparse, so rows outside it keep
    their weights bit for bit, and the touched rows follow the float32
    lazy run to float16's precision."""
    w0 = np.random.RandomState(8).randn(7, 3).astype(np.float32)
    rng = np.random.RandomState(9)
    batches = [(np.array([1, 4]), rng.randn(2, 3).astype(np.float32)),
               (np.array([4]), rng.randn(1, 3).astype(np.float32))]
    kw = {"learning_rate": 0.05, "wd": 0.01}
    want, _ = _train(P, P.cpu(), _lookup_net(P, P.cpu(), w0), batches,
                     "adam", kw)
    half = [(i, c.astype(np.float16)) for i, c in batches]
    got, _ = _train(P, P.cpu(),
                    _lookup_net(P, P.cpu(), w0.astype(np.float16)), half,
                    "adam", dict(kw, multi_precision=True))
    rest = [0, 2, 3, 5, 6]
    np.testing.assert_array_equal(got[-1][0][rest],
                                  w0.astype(np.float16)[rest])
    np.testing.assert_allclose(got[-1][0][[1, 4]].astype(np.float32),
                               want[-1][0][[1, 4]], rtol=2e-3, atol=2e-3)


def test_sparse_out_of_a_dense_op_raises():
    """An op that would write its dense result into a sparse array's
    compact block refuses."""
    rsp = P.nd.sparse.zeros("row_sparse", (4, 2), ctx=P.cpu())
    g = P.nd.ones((4, 2), ctx=P.cpu())
    with pytest.raises(P.base.MXNetError, match="row_sparse"):
        P.nd.sgd_update(rsp, g, out=rsp, lr=0.1)


def _embedding_net(pkg, ctx, contrib, w0, w1):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="net_") if not contrib \
        else nn.Sequential(prefix="net_")
    with net.name_scope():
        emb = pkg.gluon.contrib.nn.SparseEmbedding(*w0.shape) if contrib \
            else nn.Embedding(*w0.shape, sparse_grad=True)
        net.add(emb, nn.Dense(w1.shape[0], flatten=False))
    net.initialize(ctx=ctx)
    net(pkg.nd.array(np.zeros((1, 2)), ctx=ctx))
    return net


@pytest.mark.parametrize("contrib", [False, True],
                         ids=["Embedding", "SparseEmbedding"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_trainer_step_over_sparse_embedding(contrib, opt):
    """Three Trainer steps over ``Embedding(sparse_grad=True)`` (or
    ``contrib.nn.SparseEmbedding``) and a Dense, weights carried from
    the reference by structural name; a batch of 2 x 2 ids of 20."""
    from mxnet_tpu_torch.convert import set_block_params
    rng = np.random.RandomState(4)
    w0 = rng.randn(20, 4).astype(np.float32)
    w1 = rng.randn(3, 4).astype(np.float32)
    kw = {"learning_rate": 0.05, "wd": 0.01}
    if opt == "sgd":
        kw["momentum"] = 0.9
    ids = [rng.randint(0, 20, (2, 2)) for _ in range(3)]
    coefs = [rng.randn(2, 2, 3).astype(np.float32) for _ in range(3)]
    ref = _embedding_net(R, R.cpu(), contrib, w0, w1)
    ref.collect_params()[[k for k in ref.collect_params()
                          if k.endswith("embedding0_weight")][0]] \
        .set_data(R.nd.array(w0))
    arrays = {k: v.data().asnumpy()
              for k, v in ref._collect_params_with_prefix().items()}
    port = _embedding_net(P, P.cpu(), contrib, w0, w1)
    set_block_params(port, arrays)
    emb = [p for p in port.collect_params().values()
           if p.name.endswith("weight") and p.shape == (20, 4)]
    assert [p.grad_stype for p in emb] == ["row_sparse"]
    want, _ = _train(R, R.cpu(), ref, list(zip(ids, coefs)), opt, kw)
    got, _ = _train(P, P.cpu(), port, list(zip(ids, coefs)), opt, kw)
    touched = sorted(set(np.concatenate([i.ravel() for i in ids])))
    for g, w in zip(got, want):
        same(g, w, rtol=1e-5, atol=1e-6)
    rest = [r for r in range(20) if r not in touched]
    np.testing.assert_array_equal(emb[0].data().asnumpy()[rest], w0[rest])


def test_sparse_arrays_cross_packages_as_numpy_parts():
    """The reference's row_sparse and csr arrays carried into the port
    by ``convert.sparse_parts``, and back: the same arrays."""
    from mxnet_tpu_torch.convert import sparse_parts
    d = dense_rand((6, 4), seed=12)
    for stype, make in (("row_sparse", "row_sparse_array"),
                        ("csr", "csr_matrix")):
        ref = R.nd.array(d).tostype(stype)
        port = getattr(P.nd.sparse, make)(sparse_parts(ref), shape=ref.shape,
                                          ctx=P.cpu())
        back = getattr(R.nd.sparse, make)(sparse_parts(port),
                                          shape=port.shape)
        for a, b in zip(sparse_parts(port), sparse_parts(ref)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(back.asnumpy(), d)
        assert port.stype == stype


def test_parameter_dict_get_takes_the_requested_grad_stype():
    for pkg in (R, P):
        pd = pkg.gluon.ParameterDict("p_")
        a = pd.get("w", shape=(2, 2))
        assert a.grad_stype == "default"
        assert pd.get("w", grad_stype="row_sparse") is a
        assert a.grad_stype == "row_sparse"
        assert pd.get("w", grad_stype="default").grad_stype == "row_sparse"
        with pytest.raises(pkg.base.MXNetError):
            a.grad_stype = "csr"


# --- on the card ----------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_card_matches_cpu(cuda_device, name):
    same(run(CASES[name], P, P.gpu(0)), run(CASES[name], P),
         rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_card_trainer_step_over_sparse_embedding(cuda_device):
    """Two Adam steps over ``Embedding(sparse_grad=True)`` hybridized on
    the card (the forward and backward replayed as CUDA graphs, the
    row_sparse conversion outside them) against the same op by op on
    the CPU."""
    rng = np.random.RandomState(5)
    w0 = rng.randn(50, 8).astype(np.float32)
    batches = [(rng.randint(0, 50, 6), rng.randn(6, 8).astype(np.float32))
               for _ in range(2)]
    kw = {"learning_rate": 0.01, "wd": 1e-3}
    runs = []
    for ctx, hybrid in ((P.gpu(0), True), (P.cpu(), False)):
        net = _lookup_net(P, ctx, w0)
        net.hybridize(hybrid)
        runs.append(_train(P, ctx, net, batches, "adam", kw)[0])
    same(runs[0], runs[1], rtol=1e-6, atol=1e-6)
