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
