"""Port parity: four faults of the port that the reference's own tests
showed, each held against the reference on the CPU.

* A head off the autograd tape: ``backward`` gives it no gradient and
  goes on (an output of a ``grad_req="null"`` variable; ``topk``'s
  integer indices beside its values), while a head that no variable
  reaches still cannot be differentiated.
* NumPy arrays in an op's array positions (``nd.take``, ``nd.dot``,
  ``nd.pick``; every case of ``OP_SPECS`` with its later inputs as
  numpy arrays is in ``test_torch_numpy_operands.py``).
* A bfloat16 array's ``dtype``: ``str`` and ``name`` ``'bfloat16'``,
  equal to ``'bfloat16'`` and to ``torch.bfloat16``, taken back by every
  dtype argument.
* The Prometheus scrape folds in the native runtime's counters under the
  reference's names.

Values are f32 results of the same arithmetic, compared exactly."""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
from _torch_port import reference as R


def _both():
    return ((R, {}), (P, {"ctx": P.cpu()}))


# --- C.1: heads off the tape -----------------------------------------------
def test_backward_through_a_null_variable_leaves_a_zero_gradient():
    grads = []
    for mx, kw in _both():
        x = mx.nd.array([1.0], **kw)
        x.attach_grad(grad_req="null")
        with mx.autograd.record():
            y = x * 2
        y.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    np.testing.assert_array_equal(grads[1], [0.0])


def test_backward_over_topk_values_and_indices():
    x = np.array([[1.0, 3.0, 2.0], [5.0, 4.0, 6.0]], np.float32)
    grads = []
    for mx, kw in _both():
        a = mx.nd.array(x, **kw)
        a.attach_grad()
        with mx.autograd.record():
            vals, idx = mx.nd.topk(a, k=2, ret_typ="both", axis=-1)
        mx.autograd.backward([vals, idx])
        grads.append(a.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    np.testing.assert_array_equal(grads[1], [[0, 1, 1], [1, 0, 1]])


def test_grad_of_an_integer_head_is_zero_and_a_bare_head_still_raises():
    x = np.array([[1.0, 3.0, 2.0]], np.float32)
    out = []
    for mx, kw in _both():
        a = mx.nd.array(x, **kw)
        a.attach_grad()
        with mx.autograd.record():
            vals, idx = mx.nd.topk(a, k=2, ret_typ="both", axis=-1)
        out.append(mx.autograd.grad([vals, idx], [a])[0].asnumpy())
    np.testing.assert_array_equal(out[1], out[0])
    for mx, kw in _both():
        with pytest.raises(mx.MXNetError):
            mx.nd.array([1.0], **kw).backward()


# --- C.2: numpy operands ----------------------------------------------------
def test_take_dot_pick_take_numpy_operands():
    a = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    calls = [("take", (np.array([0, 1]),), {}),
             ("take", (np.array([1, 0, 1]),), {"axis": 1}),
             ("dot", (np.eye(2),), {}),
             ("pick", (np.array([0, 1]),), {}),
             ("pick", (np.array([1.0, 0.0], np.float32),), {"axis": 0})]
    for name, extra, attrs in calls:
        got = [getattr(mx.nd, name)(mx.nd.array(a, **kw), *extra,
                                    **attrs).asnumpy()
               for mx, kw in _both()]
        assert got[1].shape == got[0].shape, name
        np.testing.assert_allclose(got[1], got[0], rtol=0, atol=0,
                                   err_msg=name)


# --- C.3: the bfloat16 dtype -----------------------------------------------
def test_bfloat16_dtype_reads_as_the_reference_s():
    names = []
    for mx, kw in _both():
        a = mx.nd.ones((2, 2), **kw)
        b = mx.nd.amp_cast(a, dtype="bfloat16")
        c = mx.nd.ones((2,), dtype="bfloat16", **kw)
        for d in (b.dtype, c.dtype, a.astype("bfloat16").dtype):
            names.append((str(d), d.name, d == "bfloat16",
                          d == np.float32, d != "bfloat16"))
    half = len(names) // 2
    assert names[half:] == names[:half]
    assert names[half:] == [("bfloat16", "bfloat16", True, False, False)] * 3
    bf = P.nd.ones((2,), dtype="bfloat16", ctx=P.cpu()).dtype
    assert bf == torch.bfloat16 and torch.bfloat16 == bf
    assert "bfloat16" == bf and hash(bf) == hash("bfloat16")
    # the dtype object goes back in wherever a dtype goes
    x = P.nd.zeros((3,), dtype=bf, ctx=P.cpu())
    assert x._data.dtype == torch.bfloat16 and x.dtype == bf
    y = P.nd.ones((3,), ctx=P.cpu()).astype(bf)
    assert y._data.dtype == torch.bfloat16
    assert P.nd.cast(y, dtype=bf).dtype == "bfloat16"
    # the kept difference: numpy has no bfloat16 of its own (the
    # reference's comes from JAX's ml_dtypes)
    with pytest.raises(TypeError):
        np.dtype(bf)


def test_bfloat16_sparse_dot_keeps_the_dtype():
    outs = []
    for mx, kw in _both():
        csr = mx.nd.sparse.zeros("csr", (3, 4), dtype="bfloat16", **kw)
        rhs = mx.nd.ones((3, 2), dtype="bfloat16", **kw)
        out = mx.nd.sparse.dot(csr, rhs, transpose_a=True)
        outs.append(str(out.dtype))
    assert outs == ["bfloat16", "bfloat16"]


# --- C.4: the native counters in the scrape --------------------------------
def _native_families(text):
    return [m.group(1) for m in re.finditer(r"^# TYPE (mxnet_native_\S+) "
                                            r"(\S+)$", text, re.M)]


def test_scrape_carries_the_native_counters_under_the_reference_s_names():
    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.obs import prometheus_text
    import mxnet_tpu.obs as RO
    assert native.available(), native.build_log()
    port = prometheus_text([])
    ref = RO.prometheus_text([])
    assert _native_families(port) == _native_families(ref)
    assert "mxnet_native_engine_ops_dispatched_total" in port
    assert re.findall(r"^# TYPE (mxnet_native_\S+ \S+)$", port, re.M) == \
        re.findall(r"^# TYPE (mxnet_native_\S+ \S+)$", ref, re.M)
    assert "mxnet_native_" not in prometheus_text([], include_native=False)


def test_native_decode_counter_moves_in_the_scrape():
    import cv2
    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.obs import prometheus_text
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, size=(32, 40, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    native.decode_profile_reset()
    native.imdecode(buf.tobytes())
    assert "mxnet_native_decode_jpeg_total 1" in prometheus_text()
    native.imdecode(buf.tobytes())
    assert "mxnet_native_decode_jpeg_total 2" in prometheus_text([])
