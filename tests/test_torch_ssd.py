"""``examples/ssd_detection.py``'s SSD in the port against the
reference: the example's ``SSDHead`` in the reference and its twin in
``tests/_torch_ssd.py`` built in the port from the same weights
(``convert.set_block_params``), driven by the same step on the same
synthetic batches (``MultiBoxPrior`` anchors, ``MultiBoxTarget``,
softmax cross-entropy + smooth L1, Adam at the example's lr 2e-3).

Tolerances:
* the anchors bit for bit;
* the losses of 3 steps within 1e-5 of (1 + |loss|): both packages sum
  the batch in their own order (f32), and Adam's update of a weight
  whose gradient is rounding noise parts the two runs a little more
  each step;
* the parameters as ``tests/test_torch_optimizers.py``'s Adam case
  holds them: every element within 2 x lr a step (Adam moves a weight
  by about lr whatever its gradient), and all but 1% within 1e-6 after
  the first step and 1e-5 after the third;
* the decode of one batch from the same weights (the reference's after
  its 3 steps): class ids and kept rows bit for bit, boxes and scores
  within 1e-6.

The ``cuda`` case runs the port's SSD hybridized and op by op on the
card from one set of weights (cuDNN deterministic, TF32 off): 3 steps
bit for bit, losses, parameters and running statistics.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import _torch_ssd as S
from _torch_port import cuda_device  # noqa: F401

STEPS = 3


def _example():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "ssd_detection.py")
    spec = importlib.util.spec_from_file_location("ssd_detection", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair():
    """(reference net, port net, reference anchors, port anchors) from
    one set of seeded weights."""
    import mxnet_tpu as R
    import mxnet_tpu_torch as P
    from mxnet_tpu_torch.convert import set_block_params
    ex = _example()
    ranc = S.anchors(R, R.cpu())
    panc = S.anchors(P, P.cpu())
    np.random.seed(5)
    rnet = ex.SSDHead(ranc.shape[1])
    rnet.initialize(R.initializer.Xavier(), ctx=R.cpu())
    x, _ = S.make_batch(np.random.RandomState(9), 2)
    rnet(R.nd.array(x))
    pnet = S.ssd_head(P, panc.shape[1])
    pnet.initialize(P.init.Xavier(), ctx=P.cpu())
    set_block_params(pnet, S.params_of(rnet), ctx=P.cpu())
    return rnet, pnet, ranc, panc


def _train(pkg, net, anc, ctx, steps=STEPS):
    rng = np.random.RandomState(0)
    tr = S.trainer(pkg, net)
    losses, states = [], []
    for _ in range(steps):
        x, labels = S.make_batch(rng, S.BATCH)
        c, l = S.train_step(pkg, net, tr, anc, pkg.nd.array(x, ctx=ctx),
                            pkg.nd.array(labels, ctx=ctx))
        losses.append((float(c.asnumpy()), float(l.asnumpy())))
        states.append(S.params_of(net))
    return losses, states


@pytest.fixture(scope="module")
def trained():
    """The pair from one set of weights and the reference's 3 steps:
    (reference net, port net, reference anchors, port anchors,
    reference losses, reference states)."""
    import mxnet_tpu as R
    rnet, pnet, ranc, panc = _pair()
    return (rnet, pnet, ranc, panc) + _train(R, rnet, ranc, R.cpu())


def test_ssd_trains_as_the_reference(trained):
    import mxnet_tpu_torch as P
    _, pnet, ranc, panc, rl, rs = trained
    np.testing.assert_array_equal(panc.asnumpy(), ranc.asnumpy())
    assert panc.shape == (1, 64, 4)
    pl, ps = _train(P, pnet, panc, P.cpu())
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert sum(pl[-1]) < sum(pl[0])
    lr = S.LR
    for step, atol in ((0, 1e-6), (STEPS - 1, 1e-5)):
        assert sorted(ps[step]) == sorted(rs[step])
        over = total = 0
        for k in rs[step]:
            d = np.abs(ps[step][k] - rs[step][k])
            assert d.max() <= 2 * lr * (step + 1), (k, d.max())
            over += int((d > atol).sum())
            total += d.size
        assert over <= 0.01 * total, (step, over, total)


def test_ssd_decode_rows_match_the_reference(trained):
    """One batch decoded by both packages from the same weights (the
    reference's after its 3 steps): the detections row for row."""
    import mxnet_tpu as R
    import mxnet_tpu_torch as P
    from mxnet_tpu_torch.convert import set_block_params
    rnet, _, ranc, panc, _, _ = trained
    pnet = S.ssd_head(P, panc.shape[1])
    pnet.initialize(P.init.Xavier(), ctx=P.cpu())
    set_block_params(pnet, S.params_of(rnet), ctx=P.cpu())
    x, labels = S.make_batch(np.random.RandomState(1), S.EVAL_BATCH)
    want = S.decode(R, rnet, ranc, R.nd.array(x))
    got = S.decode(P, pnet, panc, P.nd.array(x, ctx=P.cpu()))
    assert got.shape == want.shape == (S.EVAL_BATCH, 64, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert S.evaluate(got, labels) == S.evaluate(want, labels)


@pytest.fixture
def deterministic_cudnn():
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.cuda
def test_ssd_hybridized_equals_op_by_op_on_the_card(cuda_device,
                                                     deterministic_cudnn):
    import mxnet_tpu_torch as P
    from mxnet_tpu_torch.convert import set_block_params
    ctx = P.gpu(0)
    anc = S.anchors(P, ctx)
    seed = S.ssd_head(P, anc.shape[1])
    seed.initialize(P.init.Xavier(), ctx=P.cpu())
    seed(P.nd.array(S.make_batch(np.random.RandomState(9), 2)[0],
                    ctx=P.cpu()))
    arrays = S.params_of(seed)
    runs = []
    for hybrid in (False, True):
        net = S.ssd_head(P, anc.shape[1])
        net.initialize(P.init.Xavier(), ctx=ctx)
        set_block_params(net, arrays, ctx=ctx)
        net.hybridize(hybrid)
        runs.append(_train(P, net, anc, ctx))
    (l0, s0), (l1, s1) = runs
    assert l0 == l1
    for a, b in zip(s0, s1):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
