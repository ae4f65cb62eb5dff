"""Shared inputs for the ``tests/test_torch_*.py`` parity tests: one
numpy parameter tree that goes both through ``mxnet_tpu`` and, via
``mxnet_tpu_torch.convert.from_jax``, through the port."""
import dataclasses

import numpy as np
import pytest
import torch


def configs(**kw):
    """(JAX config, port config) with identical fields: the tiny GPT of
    tests/test_serving.py unless overridden."""
    from mxnet_tpu.models import gpt
    from mxnet_tpu_torch.models.transformer import TransformerConfig
    base = dict(use_flash=False, remat=False, dropout=0.0,
                dtype="float32", vocab_size=128, max_len=64)
    base.update(kw)
    jcfg = gpt.gpt_tiny(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def numpy_params(jcfg, seed):
    """The reference ``init_params`` tree as numpy, with every bias and
    layer-norm gain/bias re-drawn (the reference initialises them to
    0 and 1, which would hide a missing bias)."""
    import jax
    from mxnet_tpu.models import transformer as T
    tree = jax.device_get(T.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed + 1000)

    def bias(n):
        return (0.05 * rng.randn(n)).astype(np.float32)

    def ln(d):
        return {"g": (1.0 + 0.1 * rng.randn(d["g"].size)).astype(np.float32),
                "b": bias(d["b"].size)}

    tree["emb_ln"] = ln(tree["emb_ln"])
    tree["mlm_ln"] = ln(tree["mlm_ln"])
    tree["mlm_bias"] = bias(tree["mlm_bias"].size)
    for layer in tree["layers"]:
        for k in ("bq", "bk", "bv", "bo", "b1", "b2"):
            layer[k] = bias(layer[k].size)
        layer["ln1"] = ln(layer["ln1"])
        layer["ln2"] = ln(layer["ln2"])
    return tree


def quantized(tree):
    """The reference ``quantize_decode_params`` of a numpy tree, as
    numpy."""
    import jax
    from mxnet_tpu.models import gpt
    return jax.device_get(gpt.quantize_decode_params(tree))


def to_port(tree):
    from mxnet_tpu_torch.convert import from_jax
    return from_jax(tree, "cpu")


@pytest.fixture
def cuda_device():
    """The CUDA device, or skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_flash_on_card(dev, dtype, T, dh, causal, use_mask, dropout, seed,
                        backward=True, B=2, H=3):
    """The flash forward (and, with ``backward``, dQ and dK/dV) kernels
    launched once each on the card at (B, T, H, dh) and held against
    their plain versions: f32 within 1e-5 (O) and 1e-4 (lse, the
    gradients) of 1 + |plain|; bf16 within the limits ``chip_smoke.py``
    derives (``fwd_limit``, ``bwd_limits``; run from the repository
    root), lse within the f32 1e-4.  With ``use_mask`` and not causal,
    the last batch row has all its keys masked; with causal, key 0 is
    kept in every row (a query whose keys up to the diagonal are all
    masked has no common answer: the plain version spreads it over all
    T keys, the kernels over the tiles up to the diagonal)."""
    from chip_smoke import LSE_TOL, bwd_limits, fwd_limit
    from mxnet_tpu_torch.kernels import flash_attention as FA
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B, T, H, dh).astype(np.float32))
                  .to(dev, dtype) for _ in range(4))
    mask = None
    if use_mask:
        m = rng.rand(B, T) > 0.3
        m[:, 0] = True
        if not causal:
            m[-1] = False
        mask = torch.from_numpy(m).to(dev)
    kw = dict(mask=mask, causal=causal, dropout=dropout,
              seed=torch.tensor([seed], dtype=torch.int32, device=dev))
    before = (FA.flash_fwd.launches, FA.flash_bwd_dq.launches,
              FA.flash_bwd_dkv.launches)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    got, refs, limits = [o], [], []
    if dtype == torch.float32:
        o_r, lse_r = FA.flash_fwd_reference(q, k, v, **kw)
        limits.append(1e-5 * (1 + o_r.abs()))
    else:
        o_r, lse_r, lim = fwd_limit(FA, q, k, v, kw)
        limits.append(lim)
    refs.append(o_r)
    got.append(lse)
    refs.append(lse_r)
    limits.append(LSE_TOL["float32"] * (1 + lse_r.abs()))
    if backward:
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = FA.flash_bwd_dq(q, k, v, g, lse, delta, **kw)
        dk, dv = FA.flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
        grads = (FA.flash_bwd_dq_reference(q, k, v, g, lse, delta, **kw),
                 *FA.flash_bwd_dkv_reference(q, k, v, g, lse, delta, **kw))
        got += [dq, dk, dv]
        refs += list(grads)
        limits += ([1e-4 * (1 + r.float().abs()) for r in grads]
                   if dtype == torch.float32 else
                   bwd_limits(FA, q, k, v, g, lse, delta, grads, kw))
    torch.cuda.synchronize()
    n = 3 if backward else 1
    assert (FA.flash_fwd.launches, FA.flash_bwd_dq.launches,
            FA.flash_bwd_dkv.launches)[:n] == tuple(x + 1 for x in before)[:n]
    for name, x, r, lim in zip(("O", "lse", "dQ", "dK", "dV"), got, refs,
                               limits):
        x, r = x.float(), r.float()
        assert bool(torch.isfinite(x).all()), name
        err = (x - r).abs()
        assert bool((err <= lim).all()), (name, float((err / lim).max()))
