"""The port's random samplers (``mxnet_tpu_torch/ops/random_ops.py``)
and ``mx.random.seed`` on the CPU.

The reference's ``jax.random`` streams cannot be reproduced by
``torch.Generator``s, so each sampler case of
``tests/_torch_port.py``'s ``RANDOM_SPECS`` is held on:

* the output's shape and dtype against the reference's draw of the same
  case (its JAX runs without x64: int64 against int32);
* its support (``randint``'s bounds, Poisson-type draws integers,
  ``_shuffle`` a permutation) in both packages;
* the first two moments of 20000 draws each (per parameter row) within
  6 standard errors of the distribution's (``check_moments``);
* determinism: two draws after ``mx.random.seed(0)`` are bit-identical,
  a third without a re-seed differs;
* ``_sample_multinomial``'s ``get_prob``: the port's log-probabilities of
  the classes the reference drew equal the reference's (rtol 1e-6).

A hybridized block that draws ``F.random_uniform`` draws new values at
each call and repeats them after a re-seed, as the same block op by op.
The ``cuda`` tests run the determinism, moments and hybridized checks
on the card.
"""
import numpy as np
import pytest
import torch

import _torch_port as T
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

import mxnet_tpu_torch as P


@pytest.mark.parametrize("spec", T.RANDOM_SPECS, ids=repr)
def test_sampler_against_reference(spec):
    mine = T.random_draw(P, spec, P.cpu())
    theirs = T.random_draw(R, spec)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape, (a.shape, b.shape)
        assert T.ref_dtype(a.dtype) == b.dtype, (a.dtype, b.dtype)
    assert np.dtype(mine[0].dtype) == np.dtype(spec.dtype)
    T.check_draw(spec, mine)
    T.check_support(spec, theirs[0])


@pytest.mark.parametrize("spec", T.RANDOM_SPECS, ids=repr)
def test_seed_repeats_and_draws_differ(spec):
    P.random.seed(0)
    a = T.random_draw(P, spec, P.cpu())
    P.random.seed(0)
    b = T.random_draw(P, spec, P.cpu())
    c = T.random_draw(P, spec, P.cpu())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])


def test_multinomial_log_prob_matches_reference():
    """The reference's draw (indices and their log-probabilities); the
    port's log-probabilities of those indices."""
    from mxnet_tpu_torch.ops.random_ops import multinomial_log_prob
    probs = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    idx, lp = R.nd._sample_multinomial(R.nd.array(probs), shape=6,
                                       get_prob=True)
    got = multinomial_log_prob(torch.from_numpy(probs),
                               torch.from_numpy(idx.asnumpy().copy()))
    np.testing.assert_allclose(got.numpy(), lp.asnumpy(), rtol=1e-6)
    one, lp1 = P.nd._sample_multinomial(P.nd.array(probs[0], ctx=P.cpu()),
                                        get_prob=True)
    assert one.shape == () and lp1.shape == ()


def test_seed_by_context_and_dropout():
    """``seed(s, ctx=cpu())`` seeds the CPU's generator alone; Dropout
    in training draws from it."""
    x = P.nd.ones((64, 64), ctx=P.cpu())
    masks = []
    for _ in range(2):
        P.random.seed(3, ctx=P.cpu())
        with P.autograd.train_mode():
            masks.append(P.nd.Dropout(x, p=0.5).asnumpy())
    np.testing.assert_array_equal(*masks)
    assert 0.4 < (masks[0] == 0).mean() < 0.6
    with pytest.raises(TypeError):
        P.random.seed(1, ctx="cpu")


def test_hybridized_random_op():
    T.check_hybridized_draws(P.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("spec", T.RANDOM_SPECS, ids=repr)
def test_sampler_on_card(spec, cuda_device):
    P.random.seed(0)
    a = T.random_draw(P, spec, P.gpu(0))
    P.random.seed(0)
    b = T.random_draw(P, spec, P.gpu(0))
    c = T.random_draw(P, spec, P.gpu(0))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    T.check_draw(spec, a)


@pytest.mark.cuda
def test_hybridized_random_op_on_card(cuda_device):
    T.check_hybridized_draws(P.gpu(0))
