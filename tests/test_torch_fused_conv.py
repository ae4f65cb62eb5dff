"""Port parity: ``mxnet_tpu_torch.kernels.fused_conv`` (the fused 3x3
convolution) against the reference's Pallas ``conv3x3_fused`` run in
interpreter mode, and, on the card, the CUDA kernel against its plain
version.

Tolerances.  f32: ``y`` within 1e-5 (abs and rel) and the sums within
rtol 1e-4, the bars of the reference's own test
(``tests/test_fused_conv.py``); the two sum 9*C f32 products, and the
B*H*W outputs of the stats, in other orders.  bf16 inputs: both round
the normalised input to bf16 the same way, their f32 products of bf16
values are exact, and each rounds its f32 accumulator to bf16 once, so
``y`` differs by at most one bf16 rounding (2^-8 of |y| each side,
2^-7 in all) plus the f32 summation-order slack.  The card's limits are
derived in ``chip_smoke.py`` (``conv_limits``, ``conv_stats_limits``,
``conv_case``) and used here too."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)

CASES = [
    # (B, H, W, C, K, th, bk, prologue, relu, stats): the reference
    # test's three cases
    (2, 8, 8, 8, 16, 4, 16, False, False, False),
    (2, 8, 8, 8, 16, 4, 16, True, True, True),
    (1, 12, 12, 16, 32, 6, 32, True, False, True),
]


def _inputs(case, seed=0):
    B, H, W, C, K, th, bk, prologue, relu, stats = case
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, K) * 0.1).astype(np.float32)
    scale = (rng.rand(C) + 0.5).astype(np.float32) if prologue else None
    shift = (rng.randn(C) * 0.1).astype(np.float32) if prologue else None
    return x, w, scale, shift


def _reference(x, w, scale, shift, case, dtype=None):
    """The reference's Pallas kernel in interpreter mode, as numpy."""
    import jax.numpy as jnp
    import mxnet_tpu.kernels.fused_conv as fc
    B, H, W, C, K, th, bk, prologue, relu, stats = case
    dt = jnp.float32 if dtype is None else dtype
    old = fc._INTERPRET
    fc._INTERPRET = True
    try:
        out = fc.conv3x3_fused(
            jnp.asarray(x, dt), jnp.asarray(w, dt),
            scale=None if scale is None else jnp.asarray(scale),
            shift=None if shift is None else jnp.asarray(shift),
            relu=relu, stats=stats, th=th, bk=bk)
    finally:
        fc._INTERPRET = old
    out = out if stats else (out,)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def _port(x, w, scale, shift, case, dtype=torch.float32):
    from mxnet_tpu_torch.kernels import fused_conv as FC
    B, H, W, C, K, th, bk, prologue, relu, stats = case

    def t(a):
        return None if a is None else torch.from_numpy(a)

    out = FC.conv3x3_fused(t(x).to(dtype), t(w).to(dtype), t(scale),
                           t(shift), relu=relu, stats=stats, th=th, bk=bk)
    out = out if stats else (out,)
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_kernel_f32(case):
    x, w, scale, shift = _inputs(case)
    ref = _reference(x, w, scale, shift, case)
    got = _port(x, w, scale, shift, case)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    if case[-1]:
        np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-4)


def test_plain_matches_reference_kernel_bf16():
    """bf16 inputs with the prologue, ReLU and stats: ``y`` within one
    bf16 rounding (2^-7 of |y|) plus f32 order slack; the sums within
    rtol 1e-4 (both sum the f32 accumulator)."""
    import jax.numpy as jnp
    case = (2, 8, 8, 16, 32, 4, 16, True, True, True)
    x, w, scale, shift = _inputs(case, seed=3)
    ref = _reference(x, w, scale, shift, case, dtype=jnp.bfloat16)
    got = _port(x, w, scale, shift, case, dtype=torch.bfloat16)
    limit = 2.0 ** -7 * np.abs(ref[0]) + 1e-5
    assert np.all(np.abs(got[0] - ref[0]) <= limit)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-4)


def test_relu_alone_and_out_dtype():
    """ReLU without scale maps x to max(x, 0) (the halo stays 0), and
    ``out_dtype`` casts the f32 accumulator."""
    from mxnet_tpu_torch.kernels import fused_conv as FC
    case = (1, 6, 6, 4, 8, None, None, False, True, False)
    x, w, _, _ = _inputs(case, seed=5)
    ref = _reference(x, w, None, None, case)
    got = _port(x, w, None, None, case)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    y = FC.conv3x3_fused(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(w).bfloat16(), relu=True,
                         out_dtype=torch.float32)
    assert y.dtype == torch.float32 and tuple(y.shape) == (1, 6, 6, 8)


@pytest.mark.parametrize("kw", [dict(th=5), dict(bk=12), dict(th=3, bk=16)])
def test_tile_validation(kw):
    """H = 8 and K = 16: th must divide H and bk K."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.kernels import fused_conv as FC
    x = torch.zeros(1, 8, 8, 4)
    w = torch.zeros(3, 3, 4, 16)
    with pytest.raises(MXNetError, match="th and K"):
        FC.conv3x3_fused(x, w, **kw)


def test_defaults_and_shape_errors():
    """The reference's defaults (th = H if H <= 28 else 28, bk = min(K,
    128)) pass where they divide, fail where they do not (H = 30), and
    malformed shapes raise."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.kernels import fused_conv as FC
    FC.conv3x3_fused(torch.zeros(1, 56, 3, 2), torch.zeros(3, 3, 2, 4))
    with pytest.raises(MXNetError):
        FC.conv3x3_fused(torch.zeros(1, 30, 3, 2), torch.zeros(3, 3, 2, 4))
    with pytest.raises(MXNetError):
        FC.conv3x3_fused(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 5, 16))
    with pytest.raises(MXNetError):
        FC.conv3x3_fused(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 16),
                         scale=torch.ones(4))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    dict(), dict(scale=True, relu=True, stats=True),
    dict(scale=True, stats=True), dict(relu=True)])
def test_cuda_kernel_matches_plain(cuda_device, flags):  # noqa: F811
    """The CUDA kernel against its plain version on the card at the
    experiment's 28 x 28 x 128 shape (batch 2, bf16), through
    ``chip_smoke.conv_case``: y within ``conv_limits``; with stats, the
    f32 accumulator within its slack, the sums within their limits of an
    f64 reduction of it, two calls bit-identical, and a dropped block of
    partials caught."""
    from chip_smoke import conv_case, conv_inputs, conv_kw
    from mxnet_tpu_torch.kernels import fused_conv as FC
    x, w, sc, sh = conv_inputs(cuda_device, 2, 28, 28, 128, torch.bfloat16,
                               np.random.RandomState(1))
    n0 = FC.conv3x3_fused.launches
    failures = []
    conv_case(FC, x, w, conv_kw(flags, sc, sh, 28, 128), "conv3x3 test",
              failures)
    assert FC.conv3x3_fused.launches == n0 + (3 if flags.get("stats") else 1)
    assert failures == []


CHAIN = dict(scale=True, relu=True, stats=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,K,dtype,out,flags", [
    # tiles of 128 pixels that cross images
    (3, 7, 7, 512, 512, torch.bfloat16, None, CHAIN),
    (3, 14, 14, 256, 256, torch.bfloat16, None, CHAIN),
    # C % 8 != 0: the scalar load loop
    (2, 9, 11, 20, 24, torch.bfloat16, None, CHAIN),
    (2, 9, 11, 20, 24, torch.bfloat16, None, dict(relu=True)),
    # W = 1, and W = 717, the widest the f32 kernel takes
    (3, 8, 1, 16, 16, torch.bfloat16, None, CHAIN),
    (1, 4, 717, 16, 32, torch.bfloat16, None, CHAIN),
    (1, 4, 717, 16, 32, torch.float32, None, CHAIN),
    # bf16 in, f32 out
    (2, 14, 14, 64, 64, torch.bfloat16, torch.float32, CHAIN),
    # the f32 instance (CUDA cores)
    (2, 28, 28, 32, 32, torch.float32, None, CHAIN),
])
def test_cuda_kernel_shapes(cuda_device, B, H, W, C, K, dtype, out,  # noqa: F811
                            flags):
    """The kernel against its plain version through
    ``chip_smoke.conv_case`` at shapes off the experiment's path: y
    within ``conv_limits``, the f32 accumulator within its slack, the
    sums within their limits, two calls bit-identical, every dropped
    row of partials caught, and one launch a call."""
    from chip_smoke import conv_case, conv_inputs, conv_kw
    from mxnet_tpu_torch.kernels import fused_conv as FC
    x, w, sc, sh = conv_inputs(cuda_device, B, H, W, C, dtype,
                               np.random.RandomState(H * W + C), K=K)
    n0 = FC.conv3x3_fused.launches
    failures = []
    conv_case(FC, x, w, conv_kw(flags, sc, sh, None, None, out),
              "conv3x3 test %dx%dx%dx%d->%d" % (B, H, W, C, K), failures)
    assert FC.conv3x3_fused.launches == n0 + (3 if flags.get("stats")
                                              else 1)
    assert failures == []


@pytest.mark.cuda
def test_cuda_kernel_unaligned_view(cuda_device):  # noqa: F811
    """bf16 x and w that are contiguous views 2 bytes off a 16-byte
    boundary take the scalar load loop and agree with the plain version
    (C and K multiples of 8)."""
    from chip_smoke import conv_case, conv_inputs, conv_kw
    from mxnet_tpu_torch.kernels import fused_conv as FC
    x, w, sc, sh = conv_inputs(cuda_device, 2, 14, 14, 64, torch.bfloat16,
                               np.random.RandomState(5))

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    x, w = offset(x), offset(w)
    assert x.data_ptr() % 16 and w.data_ptr() % 16 and x.is_contiguous()
    failures = []
    conv_case(FC, x, w, conv_kw(CHAIN, sc, sh, None, None), "conv3x3 "
              "offset view", failures)
    assert failures == []
