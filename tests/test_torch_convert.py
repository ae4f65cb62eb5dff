"""``mxnet_tpu_torch.convert.from_jax`` maps the reference parameter
tree leaf for leaf (structure, dtype, shape, values), int8 leaves of
``quantize_decode_params`` included; the port's own ``init_params``
draws the reference's tree and shapes; entry points refuse to run on
a missing GPU unless told ``device="cpu"``."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx  # noqa: F401  (conftest device setup)
from _torch_port import configs, numpy_params, quantized


def _pairs(a, b, path=""):
    """Yield (port leaf, reference leaf, path), asserting the same
    structure on the way."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            yield from _pairs(a[k], b[k], path + "/" + k)
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, "%s/%d" % (path, i))
    else:
        yield a, np.asarray(b), path


@pytest.mark.parametrize("w8", [False, True])
def test_from_jax_leaf_for_leaf(w8):
    from mxnet_tpu_torch.convert import from_jax
    jcfg, _ = configs()
    tree = numpy_params(jcfg, 0)
    if w8:
        tree = quantized(tree)
    got = from_jax(tree, "cpu")
    n = n_int8 = 0
    for t, ref, path in _pairs(got, tree):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", path
        assert tuple(t.shape) == ref.shape, path
        assert str(t.dtype).split(".")[-1] == ref.dtype.name, path
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=path)
        n += 1
        n_int8 += t.dtype == torch.int8
    # every 2-D weight becomes {"q": int8, "s": f32} under w8: tok_emb,
    # mlm_dense and six per layer
    assert n_int8 == ((2 + 6 * jcfg.n_layers) if w8 else 0)
    assert n > 20


def test_from_jax_bfloat16_and_jax_arrays():
    """bf16 leaves keep their 16 bits; device arrays convert through
    ``__array__`` without the port importing JAX."""
    import jax.numpy as jnp
    from mxnet_tpu_torch.convert import from_jax
    x = jnp.asarray(np.random.RandomState(1).randn(3, 5), jnp.bfloat16)
    got = from_jax({"w": x, "b": [jnp.arange(4)]}, "cpu")
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.arange(4))


@pytest.mark.parametrize("w8", [False, True])
def test_to_numpy_inverts_from_jax(w8):
    """``to_numpy`` gives back the tree ``from_jax`` was given, leaf for
    leaf (structure, dtype, values); bf16 comes back as its exact f32
    value."""
    from mxnet_tpu_torch.convert import from_jax, to_numpy
    jcfg, _ = configs()
    tree = numpy_params(jcfg, 2)
    if w8:
        tree = quantized(tree)
    back = to_numpy(from_jax(tree, "cpu"))
    for a, ref, path in _pairs(back, tree):
        assert isinstance(a, np.ndarray) and a.dtype == ref.dtype, path
        np.testing.assert_array_equal(a, ref, err_msg=path)
    x = torch.randn(3, 4).to(torch.bfloat16).requires_grad_()
    got = to_numpy({"w": x})["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.detach().float().numpy())


def test_init_params_matches_reference_tree():
    import jax
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg = configs()
    ref = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    got = G.init_params(0, tcfg, device="cpu")
    for t, r, path in _pairs(got, ref):
        assert tuple(t.shape) == r.shape and t.dtype == torch.float32, path
    again = G.init_params(0, tcfg, device="cpu")
    np.testing.assert_array_equal(got["layers"][1]["w2"].numpy(),
                                  again["layers"][1]["w2"].numpy())
    assert float(got["tok_emb"].std()) == pytest.approx(0.02, rel=0.1)


def test_entry_points_need_a_device(monkeypatch):
    """With no GPU and no device given, entry points raise; they never
    drop to the CPU on their own."""
    import mxnet_tpu_torch as MT
    from mxnet_tpu_torch.convert import from_jax
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.serving import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.init_params(0, tcfg)
    params = G.init_params(0, tcfg, device="cpu")
    with pytest.raises(RuntimeError):
        G.generate(params, tcfg, np.ones((1, 3), np.int32), 2)
    with pytest.raises(RuntimeError):
        ServingEngine(params, tcfg, num_slots=1, page_size=4)
    with pytest.raises(RuntimeError):
        from_jax({"w": np.ones(2)})
    with pytest.raises(RuntimeError):
        MT.resolve_device("cuda")
    from mxnet_tpu_torch.models import transformer as T
    with pytest.raises(RuntimeError):
        T.make_train_step(tcfg)
    assert MT.resolve_device("cpu") == torch.device("cpu")
