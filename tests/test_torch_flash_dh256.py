"""Port parity at head dim 256: the flash forward, dQ and dK/dV of
``mxnet_tpu_torch.kernels.flash_attention`` against the reference's
Pallas kernels in interpreter mode (which take dh 64, 128 and 256,
``mxnet_tpu/kernels/flash_attention.py:478``), and the CUDA kernels
against their plain versions on the card.

Tolerances as in tests/test_torch_flash_backward.py: interpreter mode
computes exact f32 and the plain versions sum in another order, 1e-5 on
O and lse, 1e-4 on the gradients.  On the card: f32 within the same
bars, bf16 within the limits ``chip_smoke.py`` derives (``fwd_limit``,
``bwd_limits``; run from the repository root)."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from _torch_port import check_flash_on_card

DH = 256
_TOL_FWD, _TOL_BWD = 1e-5, 1e-4


@pytest.fixture
def JFA():
    """The reference module with its Pallas kernels in interpreter mode
    (set and restored)."""
    from mxnet_tpu.kernels import flash_attention as JFA
    old = JFA._INTERPRET
    JFA._INTERPRET = True
    yield JFA
    JFA._INTERPRET = old


def _inputs(B, T, H, seed):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, T, H, DH).astype(np.float32)
                  for _ in range(4))
    mask = rng.rand(B, T) > 0.2
    mask[:, :8] = True
    return q, k, v, g, mask


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_dh256_plain_matches_pallas(JFA, causal, dropout):
    """Forward (O, lse) and the three gradients at T=128, two heads,
    with a padding mask."""
    import jax.numpy as jnp
    from mxnet_tpu_torch.kernels.flash_attention import (
        flash_bwd_dkv, flash_bwd_dq, flash_fwd)
    q, k, v, g, mask = _inputs(1, 128, 2, seed=11 + int(causal))
    seed = jnp.asarray([2025], jnp.int32)
    jq, jk, jv, jg, jm = (jnp.asarray(x) for x in (q, k, v, g, mask))
    o_r, lse_r = JFA._flash_fwd_tpu(jq, jk, jv, jm, seed, causal=causal,
                                    dropout=dropout)
    want = JFA._flash_bwd_tpu(jq, jk, jv, jm, seed, o_r, lse_r, jg,
                              causal=causal, dropout=dropout)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    kw = dict(mask=torch.from_numpy(mask), causal=causal, dropout=dropout,
              seed=torch.tensor([2025], dtype=torch.int32))
    o, lse = flash_fwd(tq, tk, tv, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=_TOL_FWD,
                               atol=_TOL_FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r),
                               rtol=_TOL_FWD, atol=_TOL_FWD)
    o_t, lse_t = torch.from_numpy(np.array(o_r)), \
        torch.from_numpy(np.array(lse_r))
    delta = (tg * o_t).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq(tq, tk, tv, tg, lse_t, delta, **kw)
    dk, dv = flash_bwd_dkv(tq, tk, tv, tg, lse_t, delta, **kw)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=_TOL_BWD, atol=_TOL_BWD)


def test_dh256_autograd_matches_jax_grad(JFA):
    """``flash_attention`` through torch autograd against ``jax.grad``
    of the reference's, causal with dropout."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu_torch.kernels.flash_attention import flash_attention
    q, k, v, g, mask = _inputs(1, 128, 1, seed=13)

    def jloss(q, k, v):
        out = JFA.flash_attention(q, k, v, jnp.asarray(mask), causal=True,
                                  dropout=0.1, dropout_seed=5)
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, mask=torch.from_numpy(mask),
                          causal=True, dropout=0.1, dropout_seed=5)
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=_TOL_BWD, atol=_TOL_BWD)


def test_head_dims_the_wrappers_take():
    """The CUDA wrappers' check passes dh 64, 128 and 256 and refuses
    others before any launch (on a stand-in for a CUDA tensor: no card
    needed; the stand-in then fails the contiguity check)."""
    from mxnet_tpu_torch.kernels.flash_attention import _check
    for dh in (64, 128, 256):
        with pytest.raises(ValueError, match="contiguous"):
            _check("flash_fwd", _CudaStandIn(dh), (), None, None, 0.0)
    with pytest.raises(ValueError, match="head dim 96"):
        _check("flash_fwd", _CudaStandIn(96), (), None, None, 0.0)


def test_bf16_tensors_must_be_16_byte_aligned():
    """The tensor-core kernels copy 16-byte pieces: ``_check`` refuses a
    contiguous bf16 q that starts 8 bytes off (a stand-in for a CUDA
    view; no card needed) and passes the aligned one on to the mask."""
    from mxnet_tpu_torch.kernels.flash_attention import _check
    q = _CudaStandIn(64, torch.bfloat16, contiguous=True, ptr=8)
    with pytest.raises(ValueError, match="16-byte"):
        _check("flash_fwd", q, (), None, None, 0.0)
    q = _CudaStandIn(64, torch.bfloat16, contiguous=True, ptr=256)
    with pytest.raises(ValueError, match="mask must be"):
        _check("flash_fwd", q, (), torch.zeros(1, 9), None, 0.0)


class _CudaStandIn:
    """Just enough of a (1, 8, 1, dh) CUDA tensor for ``_check``."""

    def __init__(self, dh, dtype=torch.float32, contiguous=False, ptr=0):
        self.device = torch.device("cuda", 0)
        self.dtype = dtype
        self.shape = torch.Size((1, 8, 1, dh))
        self._contiguous, self._ptr = contiguous, ptr

    def dim(self):
        return 4

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._ptr


# ------------------------------------------------------------- on the card --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dh256_kernels_match_plain(cuda_device, dtype):  # noqa: F811
    """The three kernels at dh 256 (B=2, T=256, H=4, padding mask,
    dropout 0.1) against their plain versions, one launch each."""
    from chip_smoke import bwd_limits, fwd_limit
    from mxnet_tpu_torch.kernels import flash_attention as FA
    dt = getattr(torch, dtype)
    q, k, v, g, mask = _inputs(2, 256, 4, seed=14)
    q, k, v, g = (torch.from_numpy(x).to(cuda_device, dt)
                  for x in (q, k, v, g))
    kw = dict(mask=torch.from_numpy(mask).to(cuda_device), causal=False,
              dropout=0.1,
              seed=torch.tensor([77], dtype=torch.int32, device=cuda_device))
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
@pytest.mark.parametrize("T", [1, 17, 100, 513])
@pytest.mark.parametrize("causal,use_mask", [(False, True), (True, False)])
def test_cuda_dh256_ragged(cuda_device, dtype, T, causal,  # noqa: F811
                           use_mask):
    """The three kernels at dh 256 at lengths no tile divides, dropout
    0.1, a row whose keys are all masked (not causal), held to
    ``chip_smoke.py``'s limits (B=2, H=2)."""
    check_flash_on_card(cuda_device, getattr(torch, dtype), T, DH, causal,
                        use_mask, 0.1, seed=T + 7, H=2)
