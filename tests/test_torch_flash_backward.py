"""Port parity: the training half of
``mxnet_tpu_torch.kernels.flash_attention`` — the positional-hash
dropout, the plain forward with dropout, the plain dQ and dK/dV
against the reference Pallas kernels in interpreter mode, and the
autograd Function against ``jax.grad`` of the reference
``flash_attention``; the CUDA kernels against their plain versions on
the card.  JAX is imported inside the parity tests only, so the
``cuda`` tests also run where JAX is absent (``pytest --noconftest -m
cuda``).

Tolerances: the hash is compared bit for bit.  Interpreter mode
computes exact f32, and the port's plain versions sum in another order:
1e-5 on O and lse, 1e-4 on the gradients, the bar of
tests/test_flash_backward.py."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from _torch_port import check_flash_on_card

_TOL_FWD = 1e-5
_TOL_BWD = 1e-4


@pytest.fixture
def JFA():
    """The reference module with its Pallas kernels in interpreter
    mode (set and restored, as tests/test_flash_backward.py does)."""
    from mxnet_tpu.kernels import flash_attention as JFA
    old = JFA._INTERPRET
    JFA._INTERPRET = True
    yield JFA
    JFA._INTERPRET = old


def _inputs(B, T, H, dh, seed=0):
    """q, k, v, dO (B, T, H, dh) f32 and a (B, T) key mask."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, T, H, dh).astype(np.float32)
                  for _ in range(4))
    mask = rng.rand(B, T) > 0.2
    mask[:, :8] = True
    return q, k, v, g, mask


def _t(*xs, device="cpu", dtype=None):
    return [torch.from_numpy(np.array(x)).to(device, dtype) for x in xs]


@pytest.mark.parametrize("bh", [0, 7, 191])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_hash_bit_identical(bh, rate):
    import jax.numpy as jnp
    from mxnet_tpu.kernels.flash_attention import _dropout_keep as ref
    from mxnet_tpu_torch.kernels.flash_attention import _dropout_keep
    rng = np.random.RandomState(bh)
    qp, kp = rng.randint(0, 4096, 256), rng.randint(0, 4096, 192)
    for seed in (0, 12345, 2**31 - 2, -7):
        want = np.asarray(ref(jnp.uint32(bh), jnp.asarray(qp),
                              jnp.asarray(kp), jnp.int32(seed), rate))
        got = _dropout_keep(bh, torch.from_numpy(qp), torch.from_numpy(kp),
                            seed, rate)
        np.testing.assert_array_equal(got.numpy(), want)


def test_dense_keep_mask_bit_identical():
    import jax.numpy as jnp
    from mxnet_tpu.kernels.flash_attention import dense_keep_mask as ref
    from mxnet_tpu_torch.kernels.flash_attention import dense_keep_mask
    want = np.asarray(ref(3, 4, 40, jnp.int32(2024), 0.25))
    got = dense_keep_mask(3, 4, 40, torch.tensor([2024], dtype=torch.int32),
                          0.25)
    assert got.shape == (3, 4, 40, 40) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dense_keep_mask(3, 4, 40, 2024, 0.25).numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_with_dropout_matches_pallas(JFA, causal):
    import jax.numpy as jnp
    from mxnet_tpu_torch.kernels.flash_attention import flash_fwd
    q, k, v, _, mask = _inputs(2, 128, 2, 64, seed=1)
    o_r, lse_r = JFA._flash_fwd_tpu(
        *(jnp.asarray(x) for x in (q, k, v, mask)),
        jnp.asarray([77], jnp.int32), causal=causal, dropout=0.25)
    o, lse = flash_fwd(*_t(q, k, v), mask=torch.from_numpy(mask),
                       causal=causal, dropout=0.25,
                       seed=torch.tensor([77], dtype=torch.int32))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=_TOL_FWD,
                               atol=_TOL_FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r),
                               rtol=_TOL_FWD, atol=_TOL_FWD)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_plain_backward_matches_pallas(JFA, causal, dropout):
    """dQ and dK/dV of the plain versions against ``_flash_bwd_tpu``
    (two 128-row tiles, so the causal loop bounds are exercised), both
    given the reference forward's O and lse."""
    import jax.numpy as jnp
    from mxnet_tpu_torch.kernels.flash_attention import (flash_bwd_dkv,
                                                         flash_bwd_dq)
    q, k, v, g, mask = _inputs(1, 256, 2, 64, seed=2)
    seed = jnp.asarray([4321], jnp.int32)
    jq, jk, jv, jg, jm = (jnp.asarray(x) for x in (q, k, v, g, mask))
    o_r, lse_r = JFA._flash_fwd_tpu(jq, jk, jv, jm, seed, causal=causal,
                                    dropout=dropout)
    want = JFA._flash_bwd_tpu(jq, jk, jv, jm, seed, o_r, lse_r, jg,
                              causal=causal, dropout=dropout)
    tq, tk, tv, tg, tm, o, lse = _t(q, k, v, g, mask, o_r, lse_r)
    delta = (tg * o).sum(-1).transpose(1, 2).contiguous()
    kw = dict(mask=tm, causal=causal, dropout=dropout,
              seed=torch.tensor([4321], dtype=torch.int32))
    dq = flash_bwd_dq(tq, tk, tv, tg, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(tq, tk, tv, tg, lse, delta, **kw)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=_TOL_BWD, atol=_TOL_BWD)


@pytest.mark.parametrize("causal,dropout", [(True, 0.1), (False, 0.0)])
def test_autograd_matches_jax_grad(JFA, causal, dropout):
    """The port's ``flash_attention`` through torch autograd (plain
    forward and backward on the CPU) against ``jax.grad`` of the
    reference ``flash_attention`` (the Pallas custom VJP)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu_torch.kernels.flash_attention import flash_attention
    q, k, v, g, mask = _inputs(2, 128, 2, 64, seed=3)
    seed = 99 if dropout else None

    def jloss(q, k, v):
        out = JFA.flash_attention(q, k, v, jnp.asarray(mask), causal=causal,
                                  dropout=dropout, dropout_seed=seed)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = flash_attention(tq, tk, tv, mask=torch.from_numpy(mask),
                          causal=causal, dropout=dropout, dropout_seed=seed)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=_TOL_FWD, atol=_TOL_FWD)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=_TOL_BWD, atol=_TOL_BWD)


def test_dropout_arguments_checked():
    from mxnet_tpu_torch.kernels.flash_attention import flash_attention
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        flash_attention(x, x, x, dropout=0.1)
    with pytest.raises(ValueError, match="dropout must be in"):
        flash_attention(x, x, x, dropout=-0.1, dropout_seed=0)


# ------------------------------------------------------------- on the card --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,use_mask,dropout", [
    (False, True, 0.1), (True, False, 0.1), (True, True, 0.0),
    (False, False, 0.0)])
def test_cuda_kernels_match_plain(cuda_device, dtype, causal,  # noqa: F811
                                  use_mask, dropout):
    """The forward with dropout and both backward kernels against their
    plain versions at BERT-base's head shape (B=2, T=512, H=12, dh=64),
    each kernel launched exactly once per call.  f32: summation order
    only (1e-5 on O, 1e-4 on the gradients, the CPU bar).  bf16: the
    limits ``chip_smoke.py`` derives and states (``fwd_limit``,
    ``bwd_limits``; run from the repository root), so the card's test
    and the smoke run hold the kernels to one bar."""
    from chip_smoke import bwd_limits, fwd_limit
    from mxnet_tpu_torch.kernels import flash_attention as FA
    dt = getattr(torch, dtype)
    q, k, v, g, mask = _inputs(2, 512, 12, 64, seed=4)
    q, k, v, g = _t(q, k, v, g, device=cuda_device, dtype=dt)
    m = torch.from_numpy(mask).to(cuda_device) if use_mask else None
    seed = torch.tensor([555], dtype=torch.int32, device=cuda_device)
    kw = dict(mask=m, causal=causal, dropout=dropout, seed=seed)
    n = (FA.flash_fwd.launches, FA.flash_bwd_dq.launches,
         FA.flash_bwd_dkv.launches)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = FA.flash_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = FA.flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (FA.flash_fwd.launches, FA.flash_bwd_dq.launches,
            FA.flash_bwd_dkv.launches) == tuple(x + 1 for x in n)
    refs = (FA.flash_bwd_dq_reference(q, k, v, g, lse, delta, **kw),
            *FA.flash_bwd_dkv_reference(q, k, v, g, lse, delta, **kw))
    if dtype == "float32":
        o_r, _ = FA.flash_fwd_reference(q, k, v, **kw)
        lim_o = _TOL_FWD * (1 + o_r.abs())
        limits = [_TOL_BWD * (1 + r.abs()) for r in refs]
    else:
        o_r, _, lim_o = fwd_limit(FA, q, k, v, kw)
        limits = bwd_limits(FA, q, k, v, g, lse, delta, refs, kw)
    for got, ref, lim in zip((o, dq, dk, dv), (o_r,) + refs,
                             (lim_o, *limits)):
        got, ref = got.float(), ref.float()
        assert bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() <= lim).all()), \
            float((got - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("T", [1, 17, 100, 513])
@pytest.mark.parametrize("causal,use_mask,dropout", [
    (False, True, 0.1), (True, True, 0.1), (True, False, 0.0)])
def test_cuda_kernels_ragged(cuda_device, dtype, dh, T, causal,  # noqa: F811
                             use_mask, dropout):
    """Forward, dQ and dK/dV at lengths no tile divides (T = 1 and 17
    below one tile), dh 64 and 128, with a row whose keys are all masked
    (not causal), held to ``chip_smoke.py``'s limits (B=2, H=3)."""
    check_flash_on_card(cuda_device, getattr(torch, dtype), T, dh, causal,
                        use_mask, dropout, seed=T + dh)
