"""Port parity: ``mxnet_tpu_torch.contrib.amp`` against
``mxnet_tpu.contrib.amp``.

The op lists are the port's own copy and must equal the reference's
entry for entry; every op the port registers has exactly one class.
The cast hook, given the same op and input dtypes, returns the same
dtypes as the reference's.  Port twins of the reference's own tests
(``tests/test_amp.py``) run on the port.
"""
import numpy as np
import pytest
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32}


@pytest.fixture
def amp_on():
    from mxnet_tpu_torch.contrib import amp
    amp.init(target_dtype="bfloat16")
    yield
    amp.disable()


def test_amp_casts_matmul_to_bf16(amp_on):
    """Twin of tests/test_amp.py::test_amp_casts_matmul_to_bf16."""
    import mxnet_tpu_torch as mx
    with mx.cpu():
        a = mx.nd.ones((4, 8))
        b = mx.nd.ones((8, 4))
        out = mx.nd.dot(a, b)
        assert out._data.dtype == torch.bfloat16
        s = mx.nd.softmax(out)
        assert s._data.dtype == torch.float32


def test_amp_widest_cast(amp_on):
    """Twin of tests/test_amp.py::test_amp_widest_cast."""
    import mxnet_tpu_torch as mx
    with mx.cpu():
        a = mx.nd.ones((2, 2))
        b = mx.nd.NDArray(torch.ones(2, 2, dtype=torch.bfloat16))
        out = mx.nd.broadcast_add(a, b)
        assert out._data.dtype == torch.float32


def test_amp_registry_classification_complete():
    """Twin of tests/test_amp.py::test_amp_registry_classification_complete
    over the port's registry: every op has one class, no op sits in two,
    the matmul and convolution families are target (or fp32) ops; the
    lists equal the reference's and name only ops the reference
    registers."""
    import re
    from collections import Counter
    from mxnet_tpu.contrib.amp import lists as jlists
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.contrib.amp import lists
    from mxnet_tpu_torch.ops import registry
    canon = sorted({registry.get_op(n).name for n in registry.list_ops()})
    unclassified = [n for n in canon if lists.classify(n) is None]
    assert not unclassified, unclassified
    seen = Counter(lists.TARGET_DTYPE_OPS + lists.FP32_OPS +
                   lists.WIDEST_TYPE_CASTS + lists.PASSTHROUGH_SAFE_OPS)
    assert not [n for n, c in seen.items() if c > 1]
    mxu = re.compile(r"(?i)(dot|conv|rnn|gemm|matmul|correlation|"
                     r"interleaved|einsum|tensordot)")
    for n in canon:
        if mxu.search(n) and not n.startswith("_contrib_quantized_"):
            assert lists.classify(n) in ("target", "fp32"), n
    for name in ("TARGET_DTYPE_OPS", "FP32_OPS", "WIDEST_TYPE_CASTS",
                 "PASSTHROUGH_SAFE_OPS"):
        assert getattr(lists, name) == getattr(jlists, name), name
    for n in seen:
        assert jreg.op_exists(n), n


def test_amp_classify_helper():
    """Twin of tests/test_amp.py::test_amp_classify_helper."""
    from mxnet_tpu_torch.contrib.amp import lists
    assert lists.classify("dot") == "target"
    assert lists.classify("softmax") == "fp32"
    assert lists.classify("Concat") == "widest"
    assert lists.classify("relu") == "passthrough"
    assert lists.classify("no_such_op_xyz") is None


@pytest.mark.parametrize("target", ["bfloat16", "float16"])
@pytest.mark.parametrize("op,dtypes", [
    ("Convolution", ("float32", "float32", "float32")),
    ("FullyConnected", ("bfloat16", "float32")),
    ("softmax", ("bfloat16",)),
    ("log_softmax", ("float16",)),
    ("BatchNorm", ("bfloat16", "float32", "float32", "float32", "float32")),
    ("broadcast_add", ("bfloat16", "float32")),
    ("broadcast_add", ("bfloat16", "bfloat16")),
    ("broadcast_mul", ("float16", "bfloat16")),
    ("broadcast_add", ("int32", "int32")),
    ("pick", ("float32", "float32")),
    ("mean", ("bfloat16",)),
])
def test_hook_matches_reference(target, op, dtypes):
    """The port's hook maps an op's input dtypes as the reference's
    does, in each class, for both target dtypes (int inputs are never
    cast)."""
    import jax.numpy as jnp
    from mxnet_tpu.contrib.amp.amp import _make_hook as jmake
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.contrib.amp.amp import _make_hook
    from mxnet_tpu_torch.ops import registry
    want = jmake(target)(jreg.get_op(op), [jnp.zeros((2,), d)
                                           for d in dtypes])
    got = _make_hook(target)(registry.get_op(op), [
        torch.zeros(2, dtype=_DTYPES[d]) for d in dtypes])
    assert [str(t.dtype).replace("torch.", "") for t in got] == \
        [str(a.dtype) for a in want]


def test_hook_casts_are_recorded():
    """Under ``autograd.record`` a target op's casts are on the tape:
    the f32 variable gets an f32 gradient through the bf16 matmul."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    amp.init()
    try:
        with mx.cpu():
            a = mx.nd.ones((4, 8))
            a.attach_grad()
            with mx.autograd.record():
                y = mx.nd.dot(a, mx.nd.ones((8, 2)))
            y.backward()
    finally:
        amp.disable()
    assert y._data.dtype == torch.bfloat16
    assert a.grad._data.dtype == torch.float32
    np.testing.assert_array_equal(a.grad.asnumpy(), np.full((4, 8), 2.0))
    assert not amp.is_initialized()


def test_loss_scaler_dynamics():
    """Twin of tests/test_amp.py::test_loss_scaler_dynamics."""
    from mxnet_tpu_torch.contrib import amp
    s = amp.LossScaler(init_scale=1024, scale_factor=2, scale_window=3)
    s.update_scale(True)
    assert s.loss_scale == 512
    for _ in range(3):
        s.update_scale(False)
    assert s.loss_scale == 1024


def test_overflow_skips_update():
    """Twin of tests/test_amp.py::test_overflow_skips_update: a float16
    scaler sees the poisoned gradient, lowers its scale and skips the
    update."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    with mx.cpu():
        net = mx.gluon.nn.Dense(2)
        net.initialize()
        x = mx.nd.ones((2, 4))
        with mx.autograd.record():
            out = net(x)
        out.backward()
        amp.init(target_dtype="float16")
        try:
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 0.1})
            amp.init_trainer(trainer)
            w0 = net.weight.data().asnumpy().copy()
            net.weight.grad()._data.fill_(float("inf"))
            scale0 = trainer._amp_loss_scaler.loss_scale
            trainer.step(2)
            assert trainer._amp_loss_scaler.loss_scale < scale0
            np.testing.assert_array_equal(net.weight.data().asnumpy(), w0)
            with amp.scale_loss(out, trainer) as scaled:
                assert float(scaled.asnumpy()[0, 0]) == \
                    float(out.asnumpy()[0, 0]) * \
                    trainer._amp_loss_scaler.loss_scale
        finally:
            amp.disable()


def test_convert_symbol_not_ported():
    from mxnet_tpu_torch.contrib import amp
    with pytest.raises(NotImplementedError, match="convert_symbol"):
        amp.convert_symbol(None)
    with pytest.raises(NotImplementedError, match="convert_model"):
        amp.convert_model(None, {}, {})
