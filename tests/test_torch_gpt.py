"""Port parity: ``mxnet_tpu_torch.models.gpt`` against
``mxnet_tpu.models.gpt`` on one numpy parameter tree (the reference
init with re-drawn biases and layer norms), f32 compute.

Tolerance 1e-5 on logits and float caches: torch's and XLA's CPU
matmuls sum in different orders.  Quantizations (_kv_quantize,
quantize_decode_params) are bit-exact; greedy generate is
token-identical."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx  # noqa: F401  (conftest device setup)
from _torch_port import configs, numpy_params, quantized, to_port

_TOL = 1e-5


def _both(seed, w8=False):
    """(jax cfg, port cfg, numpy tree for JAX, prepared port tree)."""
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, seed)
    if w8:
        tree = quantized(tree)
    return jcfg, tcfg, tree, G.prepare_params(to_port(tree), tcfg, "cpu")


def _cache_np(c):
    return {k: v.numpy() for k, v in c.items()}


@pytest.mark.parametrize("w8,kv_int8", [(False, False), (False, True),
                                        (True, False)])
def test_prefill_full_matches(w8, kv_int8):
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree, params = _both(1, w8)
    tokens = np.random.RandomState(2).randint(1, 120, (2, 7))
    jl, jc = JG._prefill_full(tree, jcfg, jnp.asarray(tokens), 12,
                              kv_int8=kv_int8)
    tl, tc = G._prefill_full(params, tcfg, torch.from_numpy(tokens), 12,
                             kv_int8=kv_int8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=_TOL,
                               atol=_TOL)
    for a, b in zip(tc, jc):
        a, b = _cache_np(a), {k: np.asarray(v) for k, v in b.items()}
        assert set(a) == set(b)
        if kv_int8:
            # a k/v value within ~1e-7 of a rounding boundary may land
            # one grid step away; all but a handful must match exactly
            diff = np.abs(a["kv"].astype(int) - b["kv"].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            np.testing.assert_allclose(a["s"], b["s"], rtol=_TOL, atol=_TOL)
        else:
            np.testing.assert_allclose(a["kv"], b["kv"], rtol=_TOL,
                                       atol=_TOL)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_one_matches(kv_int8):
    """Both sides decode one token from the SAME caches (the JAX
    prefill's, converted) at position P."""
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree, params = _both(3)
    tokens = np.random.RandomState(4).randint(1, 120, (2, 6))
    _, jc = JG._prefill_full(tree, jcfg, jnp.asarray(tokens), 10,
                             kv_int8=kv_int8)
    caches = [{k: torch.from_numpy(np.array(v)) for k, v in c.items()}
              for c in jc]
    tok = np.array([5, 77], np.int32)
    jl, jc2 = JG._decode_one(tree, jcfg, jnp.asarray(tok), 6, jc)
    tl, tc2 = G._decode_one(params, tcfg, torch.from_numpy(tok).long(), 6,
                            caches)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=_TOL,
                               atol=_TOL)
    for a, b in zip(tc2, jc2):
        if kv_int8:
            np.testing.assert_array_equal(a["kv"][:, :6].numpy(),
                                          np.asarray(b["kv"])[:, :6])
            np.testing.assert_allclose(a["s"].numpy(), np.asarray(b["s"]),
                                       rtol=_TOL, atol=_TOL)
        else:
            np.testing.assert_allclose(a["kv"].numpy(),
                                       np.asarray(b["kv"]), rtol=_TOL,
                                       atol=_TOL)


def test_kv_quantize_bit_exact():
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu_torch.models import gpt as G
    rng = np.random.RandomState(5)
    k, v = (rng.randn(6, 9, 16).astype(np.float32) for _ in range(2))
    k[0, 0] = 0.0                         # all-zero row: the 1e-8 floor
    jq, js = JG._kv_quantize(jnp.asarray(k), jnp.asarray(v))
    tq, ts = G._kv_quantize(torch.from_numpy(k), torch.from_numpy(v))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_decode_params_bit_exact():
    from mxnet_tpu_torch.models import gpt as G
    jcfg, _ = configs()
    tree = numpy_params(jcfg, 6)
    ref = quantized(tree)
    got = G.quantize_decode_params(to_port(tree))

    def walk(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for key in b:
                walk(a[key], b[key], path + "/" + key)
        elif isinstance(b, list):
            assert len(a) == len(b)
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, "%s/%d" % (path, i))
        else:
            assert str(a.dtype).split(".")[-1] == np.asarray(b).dtype.name, \
                path
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=path)

    walk(got, ref, "")


@pytest.mark.parametrize("w8", [False, True])
def test_greedy_generate_token_identical(w8):
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree, _ = _both(7, w8)
    prompt = np.random.RandomState(8).randint(1, 120, (2, 5)) \
        .astype(np.int32)
    ref = np.asarray(JG.generate(tree, jcfg, jnp.asarray(prompt), 9))
    got = G.generate(to_port(tree), tcfg, prompt, 9, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampling_follows_the_generator():
    """temperature > 0 draws from the torch.Generator it is given: the
    same seed gives the same tokens."""
    from mxnet_tpu_torch.models import gpt as G
    _, tcfg = configs()
    params = G.init_params(0, tcfg, device="cpu")
    prompt = np.array([[1, 2, 3]])

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return G.generate(params, tcfg, prompt, 6, temperature=1.0,
                          generator=g, device="cpu")

    a, b = run(11), run(11)
    assert a.shape == (1, 9)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ((a[:, 3:] >= 0) & (a[:, 3:] < tcfg.vocab_size)).all()
    with pytest.raises(ValueError):
        G.generate(params, tcfg, prompt, 62, device="cpu")  # > max_len
