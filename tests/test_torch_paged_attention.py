"""Port parity: ``mxnet_tpu_torch.kernels.paged_attention`` against the
reference Pallas kernel (interpreter mode) and its jnp reference, on
the cases of tests/test_paged_attention.py; the CUDA kernel against its
plain version on the card (JAX is imported inside the parity tests
only, so the ``cuda`` tests also run with ``pytest --noconftest``).

Tolerances are the reference file's: rtol/atol 3e-6 in f32 (a few ulps:
online softmax normalises once at the end, the reference before the V
dot) and 2e-2 in bf16 (bf16 rounding of p and the operands)."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)

_RTOL, _ATOL = 3e-6, 3e-6


def _mk(T=6, H=2, dh=8, ps=4, PP=3, NP=11, int8=False, seed=0,
        dtype="float32"):
    """Numpy inputs drawn as tests/test_paged_attention.py ``_mk``."""
    rng = np.random.RandomState(seed)
    q = rng.randn(T, H, dh).astype(np.float32)
    if int8:
        pool = rng.randint(-127, 128, (NP, ps, H, 2 * dh)).astype(np.int8)
        scale = (np.abs(rng.randn(NP, 2, ps, H)) * 0.02 + 1e-4) \
            .astype(np.float32)
    else:
        pool = rng.randn(NP, ps, H, 2 * dh).astype(np.float32)
        scale = None
    bt = rng.randint(1, NP, (T, PP)).astype(np.int32)
    return q, pool, scale, bt, dtype


def _jax(q, pool, scale, bt, pos, ps, dtype):
    import jax.numpy as jnp
    from mxnet_tpu.kernels import paged_attention as PA
    dt = jnp.dtype(dtype)
    args = (jnp.asarray(q, dt),
            jnp.asarray(pool) if pool.dtype == np.int8
            else jnp.asarray(pool, dt),
            None if scale is None else jnp.asarray(scale),
            jnp.asarray(bt), jnp.asarray(pos, jnp.int32))
    out = PA.paged_attention(*args, page_size=ps, interpret=True)
    ref = PA.paged_attention_reference(*args, page_size=ps)
    return np.asarray(out), np.asarray(ref)


def _port(q, pool, scale, bt, pos, ps, dtype, device="cpu"):
    from mxnet_tpu_torch.kernels import paged_attention as PA
    dt = getattr(torch, dtype)
    qt = torch.from_numpy(q).to(device, dt)
    pt = torch.from_numpy(pool).to(device)
    if pool.dtype != np.int8:
        pt = pt.to(dt)
    st = None if scale is None else torch.from_numpy(scale).to(device)
    return PA.paged_attention(
        qt, pt, st, torch.from_numpy(bt).to(device),
        torch.tensor(pos, dtype=torch.int32, device=device), page_size=ps)


CASES = {
    # page-boundary positions: page 0 full, first slot of page 1, page
    # 1 full, first slot of page 2, ragged mid page, every slot
    "page_boundaries": (dict(T=6), [3, 4, 7, 8, 5, 11]),
    # pos=0 rows: one live slot, later pages contribute nothing
    "single_token_rows": (dict(T=3), [0, 0, 1]),
    "int8_kv": (dict(T=5, int8=True), [0, 3, 4, 8, 11]),
    "bf16": (dict(T=4, dtype="bfloat16", dh=16), [2, 5, 7, 11]),
    "larger_heads": (dict(T=4, H=4, dh=32, ps=8, PP=4, NP=17, seed=3),
                     [7, 8, 15, 31]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_kernel(case):
    kw, pos = CASES[case]
    q, pool, scale, bt, dtype = _mk(**kw)
    ps = kw.get("ps", 4)
    out_k, out_r = _jax(q, pool, scale, bt, pos, ps, dtype)
    got = _port(q, pool, scale, bt, pos, ps, dtype).numpy()
    assert got.dtype == np.float32 and got.shape == out_r.shape
    tol = 2e-2 if dtype == "bfloat16" else _RTOL
    np.testing.assert_allclose(got, out_k, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, out_r, rtol=tol, atol=tol)


def test_shared_and_repeated_pages():
    """Aliased tables (prefix reuse), scratch-page tails and a repeated
    page: the walk reads whatever the table says, masked by pos."""
    q, pool, scale, bt, dtype = _mk(T=4)
    bt = bt.copy()
    bt[1] = bt[0]
    bt[2, 1:] = 0
    bt[3] = bt[3, 0]
    pos = [9, 9, 2, 10]
    out_k, out_r = _jax(q, pool, scale, bt, pos, 4, dtype)
    got = _port(q, pool, scale, bt, pos, 4, dtype).numpy()
    np.testing.assert_allclose(got, out_k, rtol=_RTOL, atol=_ATOL)
    np.testing.assert_allclose(got, out_r, rtol=_RTOL, atol=_ATOL)


def test_pos0_is_first_value_row():
    """pos=0: softmax over one logit is exactly 1, so the output is the
    v half of slot 0 of the row's first page."""
    q, pool, scale, bt, dtype = _mk(T=3)
    got = _port(q, pool, scale, bt, [0, 0, 1], 4, dtype).numpy()
    np.testing.assert_allclose(got[0], pool[bt[0, 0], 0, :, 8:],
                               rtol=1e-6)


def test_dead_row_on_scratch_page():
    """The engine's dead rows: an all-zero block-table row (scratch page
    0) at pos 0 gives a finite output, the scratch slot's v."""
    q, pool, scale, bt, dtype = _mk(T=2)
    bt = bt.copy()
    bt[1] = 0
    got = _port(q, pool, scale, bt, [5, 0], 4, dtype).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1], pool[0, 0, :, 8:], rtol=1e-6)


def test_rejects_bad_pool_geometry():
    q, pool, scale, bt, dtype = _mk()
    with pytest.raises(ValueError):
        _port(q, pool, scale, bt, [0] * 6, 8, dtype)   # pool is ps=4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_cuda_kernel_matches_plain(cuda_device, kind):  # noqa: F811
    """The CUDA kernel against its plain version at the serving path's
    shapes (T=32, H=12, dh=64, ps=16, PP=32), pos spread over the view
    and two dead rows.  f32: 1e-5 (reduction order).  bf16 and int8:
    the kernel rounds each weight p_i to bf16 before normalising, the
    plain version after, so they differ by at most 2^-7 * sum_i p_i|v_i|
    per element: 1e-5 + 8e-3 * (the plain version on |v|)."""
    from mxnet_tpu_torch.kernels import paged_attention as PA
    int8 = kind == "int8"
    dtype = "bfloat16" if int8 else kind
    q, pool, scale, bt, _ = _mk(T=32, H=12, dh=64, ps=16, PP=32, NP=513,
                                int8=int8, seed=5)
    rng = np.random.RandomState(6)
    pos = rng.randint(0, 512, 32)
    pos[:2] = 0
    bt[:2] = 0
    before = PA.paged_attention.launches
    got = _port(q, pool, scale, bt, pos, 16, dtype, device=cuda_device)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    ref = _port(q, pool, scale, bt, pos, 16, dtype).numpy()
    got = got.cpu().numpy()
    if kind == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        return
    absv = pool.copy()
    absv[..., 64:] = np.abs(absv[..., 64:])
    limit = 1e-5 + 8e-3 * _port(q, absv, scale, bt, pos, 16, dtype).numpy()
    assert (np.abs(got - ref) <= limit).all(), np.abs(got - ref).max()
