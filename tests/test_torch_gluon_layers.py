"""The port's new ``gluon.nn`` layers and activations, its
``gluon.loss`` losses and ``gluon.utils`` against the reference's, on
the CPU.

Each block is built in both packages, the reference's weights (where it
has any) carried to the port by structural name, and run under autograd
on the same numpy inputs with the same head gradient: outputs, input
gradients and parameter gradients within 1e-6 + 1e-5 x |ref| (their
elementwise ops, exp/log/erf and small sums in each package's own
order; measured worst: 0.20 of the limit, 3.8e-6 absolute, a
``LayerNorm`` gradient).  Then the
twins of ``tests/test_gluon.py``'s loss, embedding, dropout,
``split_and_load`` and ``clip_global_norm`` tests and of
``tests/test_api_longtail.py``'s SDML and identity/concatenate tests.
"""
import warnings

import numpy as np
import pytest

import mxnet_tpu_torch as P
from mxnet_tpu_torch.convert import set_block_params
from _torch_port import reference as R

TOL = dict(rtol=1e-5, atol=1e-6)


def arr(mx, a):
    a = np.asarray(a, np.float32)
    return mx.nd.array(a, ctx=P.cpu()) if mx is P else mx.nd.array(a)


def run(mx, block, arrays, diff, head_seed=9):
    """(outputs, gradients of the ``diff`` inputs and of the
    parameters) of ``block(*arrays)`` under autograd."""
    xs = [arr(mx, a) for a in arrays]
    for j in diff:
        xs[j].attach_grad()
    params = [p for p in block.collect_params().values()
              if p.grad_req != "null"]
    with mx.autograd.record():
        out = block(*xs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        rng = np.random.RandomState(head_seed)
        loss = sum((o * arr(mx, rng.randn(*o.shape))).sum() for o in outs)
    loss.backward()
    return ([o.asnumpy() for o in outs],
            [xs[j].grad.asnumpy() for j in diff]
            + [p.grad().asnumpy() for p in params])


def check_block(make, arrays, diff=(0,)):
    """``make(mx)`` in both packages on ``arrays``: outputs and
    gradients within TOL."""
    ref = make(R)
    ref.initialize(R.initializer.Uniform(0.5))
    ref(*[arr(R, a) for a in arrays])          # finish deferred shapes
    port = make(P)
    weights = {k: v.data().asnumpy()
               for k, v in ref._collect_params_with_prefix().items()}
    if weights:
        set_block_params(port, weights, ctx=P.cpu())
    r = run(R, ref, arrays, list(diff))
    p = run(P, port, arrays, list(diff))
    for kind, a, b in (("output", p[0], r[0]), ("gradient", p[1], r[1])):
        assert len(a) == len(b), kind
        for k, (x, y) in enumerate(zip(a, b)):
            assert x.shape == y.shape, (kind, k, x.shape, y.shape)
            np.testing.assert_allclose(x, y, err_msg="%s %d" % (kind, k),
                                       **TOL)


def rnd(*shape, seed=0, low=None):
    rng = np.random.RandomState(seed)
    if low is not None:
        return rng.uniform(low, 1.0 - low, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


X = rnd(4, 3, 5)
LAYERS = {
    "Dropout0": (lambda mx: mx.gluon.nn.Dropout(0.0), [X]),
    "Embedding": (lambda mx: mx.gluon.nn.Embedding(10, 4),
                  [np.array([[1, 2, 9], [0, 3, 3]], np.float32)], ()),
    "InstanceNorm": (lambda mx: mx.gluon.nn.InstanceNorm(scale=True),
                     [X]),
    "InstanceNorm_axis2": (lambda mx: mx.gluon.nn.InstanceNorm(
        axis=2, in_channels=5), [X]),
    "LayerNorm": (lambda mx: mx.gluon.nn.LayerNorm(), [X]),
    "LayerNorm_axis1": (lambda mx: mx.gluon.nn.LayerNorm(
        axis=1, center=False), [X]),
    "GroupNorm": (lambda mx: mx.gluon.nn.GroupNorm(num_groups=2),
                  [rnd(2, 4, 3, 3)]),
    "Lambda_name": (lambda mx: mx.gluon.nn.Lambda("tanh"), [X]),
    "Lambda_fn": (lambda mx: mx.gluon.nn.Lambda(
        lambda x: mx.nd.relu(x) * 2), [X]),
    "HybridLambda_name": (lambda mx: mx.gluon.nn.HybridLambda("sigmoid"),
                          [X]),
    "HybridLambda_fn": (lambda mx: mx.gluon.nn.HybridLambda(
        lambda F, x, y: F.tanh(x) * y), [X, rnd(4, 3, 5, seed=1)], (0, 1)),
    "Identity": (lambda mx: mx.gluon.nn.Identity(), [X]),
    "LeakyReLU": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), [X]),
    "PReLU": (lambda mx: mx.gluon.nn.PReLU(in_channels=3), [X]),
    "ELU": (lambda mx: mx.gluon.nn.ELU(0.7), [X]),
    "SELU": (lambda mx: mx.gluon.nn.SELU(), [X]),
    "GELU": (lambda mx: mx.gluon.nn.GELU(), [X]),
    "Swish": (lambda mx: mx.gluon.nn.Swish(1.5), [X]),
}


def concat_net(mx, hybrid):
    cls = mx.gluon.nn.HybridConcatenate if hybrid \
        else mx.gluon.nn.Concatenate
    net = cls(axis=1)
    net.add(mx.gluon.nn.Dense(3), mx.gluon.nn.Identity(),
            mx.gluon.nn.Dense(2, activation="tanh"))
    return net


LAYERS["HybridConcatenate"] = (lambda mx: concat_net(mx, True),
                               [rnd(2, 4)])
LAYERS["Concatenate"] = (lambda mx: concat_net(mx, False), [rnd(2, 4)])


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_reference(name):
    make, arrays, *diff = LAYERS[name]
    check_block(make, arrays, *diff)


N, C = 4, 5
PRED, LABEL = rnd(N, C, seed=2), rnd(N, C, seed=3)
SIGNS = np.sign(rnd(N, C, seed=4)).astype(np.float32)
PROBS = rnd(N, C, seed=5, low=0.05)
SW = rnd(N, 1, seed=6, low=0.1)
CTC_LABEL = np.array([[0, 1, 2, 1], [3, 3, 0, 0], [1, 0, 2, 3],
                      [2, 2, 2, 1]], np.float32)

LOSSES = {
    "L1Loss": (lambda mx: mx.gluon.loss.L1Loss(), [PRED, LABEL]),
    "L1Loss_weighted": (lambda mx: mx.gluon.loss.L1Loss(weight=0.5),
                        [PRED, LABEL, SW]),
    "SigmoidBCELoss": (lambda mx: mx.gluon.loss.SigmoidBCELoss(),
                       [PRED, PROBS]),
    "SigmoidBCELoss_pos_weight": (
        lambda mx: mx.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
        [PRED, PROBS, SW, rnd(1, C, seed=7, low=0.2)]),
    "SigmoidBCELoss_from_sigmoid": (
        lambda mx: mx.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
        [PROBS, rnd(N, C, seed=8, low=0.1)]),
    "SigmoidBCELoss_from_sigmoid_pos_weight": (
        lambda mx: mx.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
        [PROBS, rnd(N, C, seed=8, low=0.1), None,
         rnd(1, C, seed=7, low=0.2)]),
    "KLDivLoss": (lambda mx: mx.gluon.loss.KLDivLoss(), [PRED, PROBS]),
    "KLDivLoss_logits": (lambda mx: mx.gluon.loss.KLDivLoss(
        from_logits=False, axis=1, batch_axis=1), [PRED, PROBS]),
    "CTCLoss": (lambda mx: mx.gluon.loss.CTCLoss(),
                [rnd(N, 6, C, seed=10), CTC_LABEL]),
    "CTCLoss_lengths_TNC": (
        lambda mx: mx.gluon.loss.CTCLoss(layout="TNC", label_layout="TN"),
        [rnd(6, N, C, seed=11), CTC_LABEL.T.copy(),
         np.array([6, 5, 6, 4], np.float32),
         np.array([4, 2, 3, 2], np.float32)]),
    "HuberLoss": (lambda mx: mx.gluon.loss.HuberLoss(rho=0.7),
                  [PRED, LABEL]),
    "HingeLoss": (lambda mx: mx.gluon.loss.HingeLoss(), [PRED, SIGNS]),
    "SquaredHingeLoss": (lambda mx: mx.gluon.loss.SquaredHingeLoss(
        margin=0.5), [PRED, SIGNS, SW]),
    "LogisticLoss": (lambda mx: mx.gluon.loss.LogisticLoss(),
                     [PRED, SIGNS]),
    "LogisticLoss_binary": (lambda mx: mx.gluon.loss.LogisticLoss(
        label_format="binary"), [PRED, (SIGNS + 1) / 2]),
    "TripletLoss": (lambda mx: mx.gluon.loss.TripletLoss(margin=0.3),
                    [PRED, LABEL, rnd(N, C, seed=12)], (0, 1, 2)),
    "PoissonNLLLoss": (lambda mx: mx.gluon.loss.PoissonNLLLoss(),
                       [PRED, np.abs(LABEL) * 3]),
    "PoissonNLLLoss_full": (lambda mx: mx.gluon.loss.PoissonNLLLoss(
        from_logits=False, compute_full=True),
        [PROBS * 4, np.abs(LABEL) * 3]),
    "CosineEmbeddingLoss": (lambda mx: mx.gluon.loss.CosineEmbeddingLoss(
        margin=0.2), [PRED, LABEL, np.array([1, -1, 1, -1], np.float32)],
        (0, 1)),
    "CosineEmbeddingLoss_3d": (lambda mx: mx.gluon.loss.CosineEmbeddingLoss(),
                               [rnd(2, 2, C, seed=13), rnd(2, 2, C, seed=14),
                                np.array([1, -1, -1, 1], np.float32)],
                               (0, 1)),
    "SDMLLoss": (lambda mx: mx.gluon.loss.SDMLLoss(smoothing_parameter=0.2),
                 [PRED, LABEL], (0, 1)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_the_reference(name):
    make, arrays, *diff = LOSSES[name]
    if any(a is None for a in arrays):     # an optional input left out
        k = [a is None for a in arrays].index(True)

        def call(mx, make=make, k=k):
            block = make(mx)
            forward = block.hybrid_forward

            def hf(F, *xs):
                xs = list(xs)
                return forward(F, *xs[:k], None, *xs[k:])
            block.hybrid_forward = hf
            return block
        make, arrays = call, [a for a in arrays if a is not None]
    check_block(make, arrays, *diff)


def test_every_reference_name_exists():
    """Every name of the reference's ``gluon.nn``, ``gluon.loss``,
    ``gluon.rnn`` and ``gluon.utils`` is in the port."""
    import mxnet_tpu.gluon as RG
    from mxnet_tpu.gluon.nn import activations, basic_layers, conv_layers
    for mod, port in ((activations, P.gluon.nn), (basic_layers, P.gluon.nn),
                      (conv_layers, P.gluon.nn),
                      (RG.loss, P.gluon.loss), (RG.rnn.rnn_cell,
                                                P.gluon.rnn),
                      (RG.rnn.rnn_layer, P.gluon.rnn),
                      (RG.utils, P.gluon.utils)):
        missing = [n for n in mod.__all__ if not hasattr(port, n)]
        assert not missing, (mod.__name__, missing)
    for name in ("split_and_load", "split_data", "utils", "rnn"):
        assert hasattr(P.gluon, name)


def test_embedding_sparse_grad_waits_for_row_sparse():
    """``sparse_grad=True`` declares a ``row_sparse`` weight gradient, as
    in the reference, and the forward stays the dense gather
    (``tests/test_torch_sparse.py`` holds the Trainer's lazy update)."""
    outs = []
    w = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    for mx in (R, P):
        emb = mx.gluon.nn.Embedding(10, 4, sparse_grad=True)
        emb.initialize(ctx=mx.cpu())
        emb.weight.set_data(arr(mx, w))
        assert emb.weight.grad_stype == "row_sparse"
        outs.append(emb(arr(mx, [[1, 3], [9, 1]])).asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])


# --- twins of tests/test_gluon.py and tests/test_api_longtail.py ---------
def test_losses():
    """Twin of tests/test_gluon.py:183."""
    gluon, nd = P.gluon, P.nd
    pred = arr(P, np.random.RandomState(0).randn(4, 5))
    label = arr(P, [0, 1, 2, 3])
    l = gluon.loss.SoftmaxCrossEntropyLoss()(pred, label)
    assert l.shape == (4,)
    p = pred.asnumpy()
    logp = p - p.max(1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(1, keepdims=True))
    assert np.allclose(l.asnumpy(), -logp[np.arange(4), [0, 1, 2, 3]],
                       rtol=1e-4, atol=1e-5)
    ones, zeros = nd.ones((2, 3), ctx=P.cpu()), nd.zeros((2, 3), ctx=P.cpu())
    assert np.allclose(gluon.loss.L2Loss()(ones, zeros).asnumpy(), 0.5)
    assert np.allclose(gluon.loss.L1Loss()(ones, zeros).asnumpy(), 1.0)
    h = gluon.loss.HuberLoss()(nd.ones((2,), ctx=P.cpu()) * 3,
                               nd.zeros((2,), ctx=P.cpu()))
    assert np.allclose(h.asnumpy(), 3 - 0.5)
    bce = gluon.loss.SigmoidBinaryCrossEntropyLoss()(
        nd.zeros((2, 1), ctx=P.cpu()), nd.ones((2, 1), ctx=P.cpu()))
    assert np.allclose(bce.asnumpy(), np.log(2), rtol=1e-5)


def test_embedding_layer():
    """Twin of tests/test_gluon.py:213."""
    emb = P.gluon.nn.Embedding(10, 4)
    emb.initialize(ctx=P.cpu())
    assert emb(arr(P, [1, 2, 3])).shape == (3, 4)


def test_dropout_modes():
    """Twin of tests/test_gluon.py:220."""
    d = P.gluon.nn.Dropout(0.5)
    d.initialize(ctx=P.cpu())
    x = P.nd.ones((100,), ctx=P.cpu())
    assert np.allclose(d(x).asnumpy(), 1.0)
    with P.autograd.record():
        y = d(x)
    assert set(np.unique(y.asnumpy())).issubset({0.0, 2.0})


def test_split_and_load():
    """Twin of tests/test_gluon.py:232, with ``split_data``'s uneven
    split and its refusal."""
    data = P.nd.arange(0, 12, ctx=P.cpu()).reshape((6, 2))
    parts = P.gluon.split_and_load(data, [P.cpu(0)])
    assert len(parts) == 1
    parts = P.gluon.utils.split_data(data, 3)
    assert len(parts) == 3 and parts[0].shape == (2, 2)
    uneven = P.gluon.utils.split_data(data, 4, even_split=False)
    assert [p.shape[0] for p in uneven] == [1, 1, 1, 3]
    with pytest.raises(P.base.MXNetError):
        P.gluon.utils.split_data(data, 4)
    np_parts = P.gluon.split_and_load(np.ones((4, 2), np.float32),
                                      [P.cpu(0), P.cpu(0)])
    assert [p.shape for p in np_parts] == [(2, 2), (2, 2)]


def test_clip_global_norm():
    """Twin of tests/test_gluon.py:240, against the reference's return
    value and scaled arrays, and its warning on a non-finite norm."""
    res = []
    for mx in (R, P):
        arrays = [arr(mx, np.ones((2, 2)) * 3), arr(mx, np.ones((3,)) * 4)]
        norm = mx.gluon.utils.clip_global_norm(arrays, 1.0)
        total = np.sqrt(sum((a.asnumpy() ** 2).sum() for a in arrays))
        assert abs(total - 1.0) < 1e-4
        res.append((norm, [a.asnumpy() for a in arrays]))
    assert isinstance(res[1][0], float)
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    for a, b in zip(res[1][1], res[0][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    small = [arr(P, [0.1, 0.2])]
    assert P.gluon.utils.clip_global_norm(small, 1.0) == pytest.approx(
        np.sqrt(0.05), rel=1e-6)
    np.testing.assert_array_equal(small[0].asnumpy(),
                                  np.float32([0.1, 0.2]))
    nd_norm = P.gluon.utils.clip_global_norm([arr(P, [3.0, 4.0])], 10.0,
                                             check_isfinite=False)
    assert float(nd_norm.asscalar()) == pytest.approx(5.0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        P.gluon.utils.clip_global_norm([arr(P, [np.inf, 1.0])], 1.0)
    assert any("nan or inf" in str(x.message) for x in w)


def test_check_sha1_and_download(tmp_path):
    import hashlib
    f = tmp_path / "blob"
    f.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert P.gluon.utils.check_sha1(str(f), digest)
    assert not P.gluon.utils.check_sha1(str(f), "0" * 40)
    with pytest.raises(P.base.MXNetError):
        P.gluon.utils.download("http://localhost/none")


def test_sdml_loss_matches_numpy_oracle():
    """Twin of tests/test_api_longtail.py:118."""
    rng = np.random.RandomState(0)
    Nn, D = 4, 5
    a = rng.randn(Nn, D).astype("float32")
    b = rng.randn(Nn, D).astype("float32")
    sp = 0.3
    sd = P.gluon.loss.SDMLLoss(smoothing_parameter=sp)
    got = sd(arr(P, a), arr(P, b)).asnumpy()
    dist = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    z = -dist
    logp = z - z.max(1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(1, keepdims=True))
    gold = np.eye(Nn, dtype="float32")
    labels = gold * (1 - sp) + (1 - gold) * sp / (Nn - 1)
    expect = (labels * (np.log(labels + 1e-12) - logp)).mean(axis=1)
    assert np.allclose(got, expect, rtol=1e-4, atol=1e-5)
    x1 = arr(P, a)
    x1.attach_grad()
    with P.autograd.record():
        L = sd(x1, arr(P, b)).mean()
    L.backward()
    assert np.isfinite(x1.grad.asnumpy()).all()
    x1b = arr(P, a - 0.05 * x1.grad.asnumpy())
    assert float(sd(x1b, arr(P, b)).mean().asnumpy()) < float(L.asnumpy())


def test_identity_concatenate_layers():
    """Twin of tests/test_api_longtail.py:169."""
    nn = P.gluon.nn
    net = nn.HybridConcatenate(axis=1)
    net.add(nn.Dense(3), nn.Identity(), nn.Dense(2))
    net.initialize(P.initializer.Xavier(), ctx=P.cpu())
    x = arr(P, np.ones((2, 4)))
    ref = net(x)
    assert ref.shape == (2, 9)
    net.hybridize()
    assert np.allclose(net(x).asnumpy(), ref.asnumpy(), rtol=1e-6)
    assert isinstance(nn.Block, type) and isinstance(nn.SymbolBlock, type)
