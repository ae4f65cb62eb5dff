"""Port parity: ``mxnet_tpu_torch.kernels.flash_attention`` — its plain
forward against the reference Pallas forward ``_flash_fwd_tpu`` in
interpreter mode (O and lse) and against ``_reference_attention``; the
CUDA kernel against the plain version on the card.  The training half
(dropout, backward) is tests/test_torch_flash_backward.py.  JAX is imported
inside the parity tests only, so the ``cuda`` tests also run where JAX
is absent (``pytest --noconftest -m cuda``).

Tolerance 1e-5 in f32: the kernel and the plain version sum the
softmax in different orders (interpreter mode computes exact f32)."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from _torch_port import check_flash_on_card

_TOL = 1e-5


@pytest.fixture
def FA():
    """The reference module with its Pallas kernels in interpreter
    mode (set and restored, as tests/test_flash_backward.py does)."""
    from mxnet_tpu.kernels import flash_attention as FA
    old = FA._INTERPRET
    FA._INTERPRET = True
    yield FA
    FA._INTERPRET = old


def _inputs(B, T, H, dh, use_mask, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, dh).astype(np.float32) for _ in range(3))
    mask = None
    if use_mask:
        mask = rng.rand(B, T) > 0.2
        mask[:, :8] = True
    return q, k, v, mask


def _port(q, k, v, mask, causal, device="cpu", dtype=torch.float32):
    from mxnet_tpu_torch.kernels.flash_attention import flash_fwd
    t = [torch.from_numpy(x).to(device, dtype) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask).to(device)
    return flash_fwd(*t, mask=m, causal=causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [False, True])
def test_plain_matches_pallas_forward(FA, causal, use_mask):
    import jax.numpy as jnp
    q, k, v, mask = _inputs(2, 128, 2, 64, use_mask)
    o_ref, lse_ref = FA._flash_fwd_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask),
        jnp.zeros(1, jnp.int32), causal=causal)
    o, lse = _port(q, k, v, mask, causal)
    assert lse.shape == (2, 2, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=_TOL,
                               atol=_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                               rtol=_TOL, atol=_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_attention_t40(FA, causal):
    """A length no 128-tile divides: the reference attention itself."""
    import jax.numpy as jnp
    q, k, v, mask = _inputs(2, 40, 3, 16, True, seed=1)
    ref = FA._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(mask),
                                  causal=causal)
    from mxnet_tpu_torch.kernels.flash_attention import flash_attention
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = flash_attention(*t, mask=torch.from_numpy(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=_TOL,
                               atol=_TOL)


def test_dropout_is_the_training_slice(FA):
    """Dropout came with the training slice: ``flash_attention`` with
    dropout matches the reference's (Pallas forward, positional-hash
    dropout, same seed), and a rate outside [0, 1) still raises."""
    import jax.numpy as jnp
    q, k, v, mask = _inputs(2, 128, 2, 64, True, seed=3)
    ref = FA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), causal=True, dropout=0.1,
                             dropout_seed=11)
    from mxnet_tpu_torch.kernels.flash_attention import flash_attention
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = flash_attention(*t, mask=torch.from_numpy(mask), causal=True,
                          dropout=0.1, dropout_seed=11)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=_TOL,
                               atol=_TOL)
    with pytest.raises(ValueError):
        flash_attention(*t, dropout=1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("T,causal,use_mask,dtype", [
    (192, True, False, "float32"), (512, True, True, "float32"),
    (200, False, True, "float32"), (192, True, False, "bfloat16"),
    (512, False, True, "bfloat16")])
def test_cuda_kernel_matches_plain(cuda_device, T, causal,  # noqa: F811
                                   use_mask, dtype):
    """The CUDA kernel against the plain version at the prefill path's
    shapes (B=4, H=12, dh=64).  f32: 1e-5 on O, 1e-4 on lse (summation
    order); bf16: 2e-2 on O, 5e-2 on lse (the plain version's logits
    are bf16, the kernel's f32)."""
    from mxnet_tpu_torch.kernels.flash_attention import flash_fwd
    q, k, v, mask = _inputs(4, T, 12, 64, use_mask, seed=2)
    dt = getattr(torch, dtype)
    before = flash_fwd.launches
    o, lse = _port(q, k, v, mask, causal, device=cuda_device, dtype=dt)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    o_r, lse_r = _port(q, k, v, mask, causal, dtype=dt)
    to, tl = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 5e-2)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_r.float().numpy(), rtol=to, atol=to)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_r.numpy(), rtol=tl,
                               atol=tl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 17, 100, 513])
@pytest.mark.parametrize("causal,use_mask,dropout", [
    (False, True, 0.1), (True, False, 0.0), (True, True, 0.1)])
def test_cuda_forward_ragged(cuda_device, dtype, T, causal,  # noqa: F811
                             use_mask, dropout):
    """The forward at lengths no tile divides (T = 1 and 17 below one
    tile, causal or not), with a row whose keys are all masked and with
    dropout, held to ``chip_smoke.py``'s limits (B=2, H=3, dh=64)."""
    check_flash_on_card(cuda_device, getattr(torch, dtype), T, 64, causal,
                        use_mask, dropout, seed=T, backward=False)
