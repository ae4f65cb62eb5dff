"""INT8 quantization (``ops/quantization.py``, ``contrib/quantization.py``)
against the reference on the CPU.

* The ops: every case of ``OP_SPECS["quantization"]`` through both
  packages on the same seeded int8/uint8/int32/float inputs, bit for bit
  (integer outputs, float ranges and dequantized values; the reference
  runs unjitted, since its jit contracts the uint8 dequantize's
  multiply-add into an FMA), under each name the op is registered by.
* The reference's own ``tests/test_quantization.py`` cases, against the
  port, with their tolerances (int8 against float32: 0.1 to 0.2
  absolute on unit-scale data).
* The flow: ``quantize_model`` on ``examples/int8_quantization.py``'s
  convnet and on a two-stage ResNet (conv, BatchNorm, relu, residual
  adds, pooling, a dense head), with naive and entropy calibration: the
  port's quantized graph has the reference's nodes and attributes (the
  calibrated ranges, read from float32 layer outputs, within 1e-5), its
  quantized parameters equal the reference's bit for bit, and each
  quantized node of the reference's forward, recomputed by the port's
  op on that node's inputs, equals it bit for bit.  The KL threshold
  search equals the reference's on the same histograms.
* ``cuda``: the ops and the quantized ResNet's int8/int32 tensors on
  the card equal the CPU's bit for bit.
"""
import numpy as np
import pytest

import _torch_port as T
from _torch_port import cuda_device  # noqa: F401
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.contrib import quantization as qz

SPECS = T.OP_SPECS["quantization"]
ALIASES = T.alias_cases(SPECS)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_op_bit_for_bit(spec):
    T.check_against_reference(spec, unjitted=True)


@pytest.mark.parametrize("spec,alias", ALIASES, ids=[a for _, a in ALIASES])
def test_alias_bit_for_bit(spec, alias):
    T.check_against_reference(spec, name=alias, unjitted=True)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_card_against_cpu(spec, cuda_device):
    T.check_on_card(spec)


# ---- the reference's tests/test_quantization.py cases, on the port

def test_quantize_dequantize_int8_roundtrip():
    np.random.seed(0)
    x = np.random.uniform(-3, 3, (4, 7)).astype(np.float32)
    q, mn, mx_ = nd.quantize_v2(nd.array(x), out_type="int8")
    assert q.dtype == np.int8
    back = nd.dequantize(q, mn, mx_)
    r = np.max(np.abs(x))
    assert np.max(np.abs(back.asnumpy() - x)) <= r / 127.0 + 1e-6


def test_quantize_uint8():
    x = np.random.uniform(0, 5, (3, 5)).astype(np.float32)
    q, mn, mx_ = nd.quantize(nd.array(x), nd.array(0.0), nd.array(5.0),
                             out_type="uint8")
    assert q.dtype == np.uint8
    back = nd.dequantize(q, mn, mx_)
    assert np.max(np.abs(back.asnumpy() - x)) <= 5.0 / 255.0 + 1e-6


def test_quantized_fully_connected_matches_fp32():
    np.random.seed(1)
    x = np.random.uniform(-1, 1, (8, 16)).astype(np.float32)
    w = np.random.uniform(-1, 1, (4, 16)).astype(np.float32)
    b = np.random.uniform(-1, 1, (4,)).astype(np.float32)
    ref = x @ w.T + b
    qx, mnx, mxx = nd.quantize_v2(nd.array(x), out_type="int8")
    qw, mnw, mxw = nd.quantize_v2(nd.array(w), out_type="int8")
    qb, mnb, mxb = nd.quantize_v2(nd.array(b), out_type="int8")
    out32, mno, mxo = nd.quantized_fully_connected(
        qx, qw, qb, mnx, mxx, mnw, mxw, mnb, mxb, num_hidden=4)
    assert out32.dtype == np.int32
    out = nd.dequantize(out32, mno, mxo).asnumpy()
    assert np.max(np.abs(out - ref)) < 0.1


def test_quantized_conv_matches_fp32():
    np.random.seed(2)
    x = np.random.uniform(-1, 1, (2, 3, 8, 8)).astype(np.float32)
    w = np.random.uniform(-1, 1, (5, 3, 3, 3)).astype(np.float32)
    ref = nd.Convolution(nd.array(x), nd.array(w), kernel=(3, 3),
                         num_filter=5, no_bias=True).asnumpy()
    qx, mnx, mxx = nd.quantize_v2(nd.array(x), out_type="int8")
    qw, mnw, mxw = nd.quantize_v2(nd.array(w), out_type="int8")
    out32, mno, mxo = nd.quantized_conv(
        qx, qw, mnx, mxx, mnw, mxw, kernel=(3, 3), num_filter=5,
        no_bias=True)
    out = nd.dequantize(out32, mno, mxo).asnumpy()
    assert np.max(np.abs(out - ref)) < 0.2


def test_requantize_int32_to_int8():
    x = np.random.uniform(-2, 2, (6, 6)).astype(np.float32)
    q, mn, mx_ = nd.quantize_v2(nd.array(x), out_type="int8")
    q32 = q.astype("int32") * (2 ** 24)
    r = float(mx_.asnumpy())
    mn32 = nd.array(-r * (2 ** 31 - 1) / (127.0 * 2 ** 24))
    mx32 = nd.array(r * (2 ** 31 - 1) / (127.0 * 2 ** 24))
    q8, mn8, mx8 = nd.requantize(q32, mn32, mx32)
    back = nd.dequantize(q8, mn8, mx8).asnumpy()
    assert np.max(np.abs(back - x)) < r / 127.0 * 2 + 1e-5


def test_optimal_threshold_kl():
    np.random.seed(3)
    arr = np.concatenate([np.random.normal(0, 1, 20000), [40.0]])
    coll = qz.LayerHistogramCollector()
    coll.collect("x", arr)
    (lo, hi), = [coll.thresholds()["x"]]
    assert 2.0 < hi < 20.0


def test_minmax_collector():
    coll = qz.LayerOutputMinMaxCollector()
    coll.collect("x", np.array([-1.0, 2.0]))
    coll.collect("x", np.array([-3.0, 1.0]))
    assert coll.thresholds()["x"] == (-3.0, 2.0)


def test_quantized_max_pooling_int8():
    data = nd.array(np.arange(-8, 8, dtype=np.int8).reshape(1, 1, 4, 4),
                    dtype="int8")
    out, mn, mx_ = nd.quantized_pooling(
        data, nd.array([-1.0]), nd.array([1.0]),
        kernel=(2, 2), stride=(2, 2), pool_type="max")
    ref = np.array([[[[-3, -1], [5, 7]]]], dtype=np.int8)
    np.testing.assert_array_equal(out.asnumpy(), ref)


def test_quantized_conv_uint8_activations():
    np.random.seed(4)
    x = np.random.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    w = np.random.uniform(-1, 1, (5, 3, 3, 3)).astype(np.float32)
    ref = nd.Convolution(nd.array(x), nd.array(w), kernel=(3, 3),
                         num_filter=5, no_bias=True).asnumpy()
    qx, mnx, mxx = nd.quantize_v2(nd.array(x), out_type="auto",
                                  min_calib_range=0.0,
                                  max_calib_range=float(x.max()))
    assert qx.dtype == np.uint8
    qw, mnw, mxw = nd.quantize_v2(nd.array(w), out_type="int8")
    out32, mno, mxo = nd.quantized_conv(
        qx, qw, mnx, mxx, mnw, mxw, kernel=(3, 3), num_filter=5,
        no_bias=True)
    out = nd.dequantize(out32, mno, mxo).asnumpy()
    assert np.max(np.abs(out - ref)) < 0.15
    qn, _, _ = nd.quantize_v2(nd.array(x - 0.5), out_type="auto",
                              min_calib_range=-0.5, max_calib_range=0.5)
    assert qn.dtype == np.int8


def test_quantized_uint8_positive_min_zero_point_correct():
    np.random.seed(6)
    x = np.random.uniform(0.5, 1.0, (8, 16)).astype(np.float32)
    w = np.random.uniform(-1, 1, (4, 16)).astype(np.float32)
    ref = x @ w.T
    qx, mnx, mxx = nd.quantize_v2(nd.array(x), out_type="auto",
                                  min_calib_range=0.5, max_calib_range=1.0)
    assert qx.dtype == np.uint8 and float(mnx.asnumpy()) == 0.0
    qw, mnw, mxw = nd.quantize_v2(nd.array(w), out_type="int8")
    out32, mno, mxo = nd.quantized_fully_connected(
        qx, qw, mnx, mxx, mnw, mxw, num_hidden=4, no_bias=True)
    out = nd.dequantize(out32, mno, mxo).asnumpy()
    assert np.max(np.abs(out - ref)) < 0.1
    with pytest.raises(mx.MXNetError):
        nd.quantize_v2(nd.array(w), out_type="uint8",
                       min_calib_range=-1.0, max_calib_range=1.0)


def test_uint8_mode_params_stay_s8():
    np.random.seed(7)
    data = mx.sym.Variable("data")
    w = mx.sym.Variable("w")
    b = mx.sym.Variable("b")
    fc = mx.sym.FullyConnected(data, weight=w, bias=b, num_hidden=4,
                               name="fc")
    qsym = qz.quantize_symbol(fc, offline_params=(),
                              quantized_dtype="uint8")
    x = np.random.uniform(0, 1, (8, 16)).astype(np.float32)
    wv = np.random.uniform(-1, 1, (4, 16)).astype(np.float32)
    bv = np.array([-3.0, -1.0, 1.0, 3.0], np.float32)
    ref = x @ wv.T + bv
    exe = qsym.bind(ctx=mx.cpu(), args={"data": nd.array(x),
                                        "w": nd.array(wv),
                                        "b": nd.array(bv)},
                    grad_req="null")
    out = exe.forward(is_train=False)[0].asnumpy()
    assert np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-6) < 0.1
    found = {n.name: n.attrs.get("out_type") for n in qsym._nodes()
             if n.name in ("w_quantize", "b_quantize")}
    assert found == {"w_quantize": "int8", "b_quantize": "int8"}


def _small_mlp_symbol(S):
    data = S.sym.Variable("data")
    fc1 = S.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = S.sym.Activation(fc1, act_type="relu", name="relu1")
    return S.sym.FullyConnected(act, num_hidden=4, name="fc2")


def _mlp_args(S, rng):
    return {"fc1_weight": rng.uniform(-1, 1, (16, 8)).astype(np.float32),
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.uniform(-1, 1, (4, 16)).astype(np.float32),
            "fc2_bias": np.zeros(4, np.float32)}


@pytest.mark.parametrize("calib_mode", ["none", "naive", "entropy"])
def test_quantize_model_end_to_end(calib_mode):
    rng = np.random.RandomState(4)
    sym = _small_mlp_symbol(mx)
    args = {k: nd.array(v) for k, v in _mlp_args(mx, rng).items()}
    x = rng.uniform(-1, 1, (32, 8)).astype(np.float32)
    ref = sym.bind(ctx=mx.cpu(), args={**args, "data": nd.array(x)},
                   grad_req="null").forward(is_train=False)[0].asnumpy()
    qsym, qargs, _ = qz.quantize_model(
        sym, args, {}, data_names=("data",), ctx=mx.cpu(),
        calib_mode=calib_mode, calib_data=nd.array(x),
        quantized_dtype="int8")
    assert any(k.endswith("_quantize") for k in qargs)
    out = qsym.bind(ctx=mx.cpu(), args={**qargs, "data": nd.array(x)},
                    grad_req="null").forward(is_train=False)[0].asnumpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-6) < 0.1


def test_quantize_model_excluded_layer():
    rng = np.random.RandomState(5)
    args = {k: nd.array(v) for k, v in _mlp_args(mx, rng).items()}
    qsym, qargs, _ = qz.quantize_model(
        _small_mlp_symbol(mx), args, {}, calib_mode="none",
        excluded_sym_names=("fc2",), ctx=mx.cpu())
    assert "fc2_weight" in qargs
    assert not any(k.startswith("fc2_weight_quantize") for k in qargs)
    assert any(k.startswith("fc1_weight_quantize") for k in qargs)


def test_calib_graph_refuses_as_the_reference():
    with pytest.raises(mx.MXNetError, match="pre-rewrite"):
        qz.calib_graph(None, {}, {}, None)


# ---- the flow against the reference

def _convnet(S):
    """``examples/int8_quantization.py``'s convnet."""
    x = S.sym.Variable("data")
    h = S.sym.Convolution(x, kernel=(3, 3), num_filter=8, pad=(1, 1),
                          name="c0")
    h = S.sym.Activation(h, act_type="relu", name="r0")
    h = S.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="p0")
    h = S.sym.Flatten(h, name="fl")
    h = S.sym.FullyConnected(h, num_hidden=4, name="fc")
    return S.sym.SoftmaxOutput(h, name="softmax")


def _convnet_params(rng):
    return {"c0_weight": rng.randn(8, 1, 3, 3).astype(np.float32) * 0.4,
            "c0_bias": rng.randn(8).astype(np.float32) * 0.1,
            "fc_weight": rng.randn(4, 128).astype(np.float32) * 0.1,
            "fc_bias": rng.randn(4).astype(np.float32) * 0.1}, {}


def _bn_unit(S, h, name, nf, stride):
    c = S.sym.Convolution(h, kernel=(3, 3), num_filter=nf, pad=(1, 1),
                          stride=(stride, stride), no_bias=True,
                          name=name + "_conv1")
    c = S.sym.BatchNorm(c, fix_gamma=False, name=name + "_bn1")
    c = S.sym.Activation(c, act_type="relu", name=name + "_relu1")
    c = S.sym.Convolution(c, kernel=(3, 3), num_filter=nf, pad=(1, 1),
                          no_bias=True, name=name + "_conv2")
    c = S.sym.BatchNorm(c, fix_gamma=False, name=name + "_bn2")
    sc = h if stride == 1 else S.sym.Convolution(
        h, kernel=(1, 1), num_filter=nf, stride=(stride, stride),
        no_bias=True, name=name + "_sc")
    return S.sym.Activation(c + sc, act_type="relu", name=name + "_out")


def _resnet(S):
    """A two-stage ResNet: the stem, a unit at 8 channels, a strided unit
    at 16 with a 1x1 shortcut, global pooling and a dense head."""
    x = S.sym.Variable("data")
    h = S.sym.Convolution(x, kernel=(3, 3), num_filter=8, pad=(1, 1),
                          no_bias=True, name="stem")
    h = S.sym.BatchNorm(h, fix_gamma=False, name="stem_bn")
    h = S.sym.Activation(h, act_type="relu", name="stem_relu")
    h = _bn_unit(S, h, "s1", 8, 1)
    h = _bn_unit(S, h, "s2", 16, 2)
    h = S.sym.Pooling(h, kernel=(1, 1), global_pool=True, pool_type="avg",
                      name="gap")
    h = S.sym.Flatten(h, name="flat")
    return S.sym.FullyConnected(h, num_hidden=5, name="head")


def _resnet_params(rng):
    R = _ref()
    with R.name.NameManager():
        sym = _resnet(R)
    shapes, _, aux_shapes = sym.infer_shape(data=(8, 3, 12, 12))
    args, aux = {}, {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n == "data":
            continue
        if n.endswith("gamma"):
            args[n] = (1 + 0.1 * rng.randn(*s)).astype(np.float32)
        else:
            args[n] = (rng.randn(*s) * (0.05 if n.endswith("beta")
                                        or n.endswith("bias")
                                        else np.sqrt(2.0 / np.prod(s[1:])))
                       ).astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = (rng.rand(*s) * 0.2 + (0.9 if n.endswith("var") else -0.1)
                  ).astype(np.float32)
    return args, aux


def _ref():
    import mxnet_tpu
    return mxnet_tpu


def _quantize(S, build, args, aux, calib, mode, ctx):
    with S.name.NameManager():
        sym = build(S)
    nda = {k: S.nd.array(v, ctx=ctx) for k, v in args.items()}
    ndx = {k: S.nd.array(v, ctx=ctx) for k, v in aux.items()}
    it = S.io.NDArrayIter(calib, np.zeros(len(calib), np.float32), 8,
                          label_name="softmax_label")
    return sym, S.contrib.quantization.quantize_model(
        sym, nda, ndx, ctx=ctx, calib_mode=mode, calib_data=it,
        excluded_sym_names=())


def _graph_sig(sym):
    return [(n.name, None if n.is_var else n.op.name,
             sorted(n.attrs.items())) for n in sym._nodes()]


def _same_graph(got, want):
    """The same nodes, ops and attributes; the calibrated ranges (float32
    layer outputs of either package) within 1e-5."""
    assert len(got) == len(want)
    for (n, op, at), (rn, rop, rat) in zip(got, want):
        assert (n, op, [k for k, _ in at]) == (rn, rop, [k for k, _ in rat])
        for (k, v), (_, rv) in zip(at, rat):
            if k.endswith("calib_range"):
                np.testing.assert_allclose(v, rv, rtol=1e-5, err_msg=n)
            else:
                assert v == rv, (n, k)


def _internals(S, qsym, qargs, qaux, x, ctx):
    """Every output of the quantized graph by (node name, slot), numpy."""
    inner = qsym.get_internals()
    args = {k: v.as_in_context(ctx) for k, v in qargs.items()}
    args["data"] = S.nd.array(x, ctx=ctx)
    for n in inner.list_arguments():
        if n not in args:                      # softmax_label
            args[n] = S.nd.zeros((x.shape[0],), ctx=ctx)
    exe = inner.bind(ctx=ctx, args=args, grad_req="null",
                     aux_states={k: v.as_in_context(ctx)
                                 for k, v in qaux.items()})
    outs = exe.forward(is_train=False)
    return {(n.name, s): o.asnumpy()
            for (n, s), o in zip(inner._outputs, outs)}


def replay_quantized_nodes(qsym, vals, ctx):
    """Each ``_contrib_*`` node of ``qsym`` (either package's graph) run
    by the port's op, with the node's attributes, on the recorded values
    of its inputs (``vals``: (node name, slot) -> numpy): (nodes run, the
    node outputs that differ from the recorded ones)."""
    from mxnet_tpu_torch.ops import registry as reg
    ran, bad = 0, []
    for node in qsym._nodes():
        if node.is_var or not node.op.name.startswith("_contrib_"):
            continue
        ins = [mx.nd.array(vals[(n.name, s)], ctx=ctx,
                           dtype=vals[(n.name, s)].dtype)
               for n, s in node.inputs]
        outs = reg.invoke(reg.get_op(node.op.name), ins, node.pos_attrs,
                          dict(node.attrs))
        outs = outs if isinstance(outs, tuple) else (outs,)
        ran += 1
        for k, o in enumerate(outs):
            want = vals[(node.name, k)]
            got = o.asnumpy()
            if got.dtype != want.dtype or got.shape != want.shape or \
                    not np.array_equal(got, want):
                bad.append("%s[%d]" % (node.name, k))
    return ran, bad


def _model(model, rng):
    if model == "convnet":
        return _convnet, _convnet_params(rng), (1, 8, 8)
    return _resnet, _resnet_params(rng), (3, 12, 12)


@pytest.mark.parametrize("mode", ["naive", "entropy"])
@pytest.mark.parametrize("model", ["convnet", "resnet"])
def test_quantize_model_matches_the_reference(model, mode):
    """``quantize_model`` in both packages on the same float model and
    calibration data: the same graph (nodes, ops, attributes; the
    calibrated ranges, read from float32 layer outputs, within 1e-5),
    the quantized parameters bit for bit, and every quantized node of
    the reference's forward (quantize, the int8 products, requantize,
    pooling, relu, flatten, dequantize) recomputed by the port's op from
    that forward's own inputs bit for bit.  The port's own forward gives
    the reference's logits within 2e-2 of their scale (a float32 value
    one ulp apart can round to the next int8 level)."""
    R = _ref()
    rng = np.random.RandomState(11)
    build, (args, aux), shape = _model(model, rng)
    calib = rng.randn(16, *shape).astype(np.float32)
    x = rng.randn(8, *shape).astype(np.float32)
    _, (qs_p, qa_p, qx_p) = _quantize(mx, build, args, aux, calib, mode,
                                      mx.cpu())
    _, (qs_r, qa_r, qx_r) = _quantize(R, build, args, aux, calib, mode,
                                      R.cpu())
    _same_graph(_graph_sig(qs_p), _graph_sig(qs_r))
    assert sorted(qa_p) == sorted(qa_r)
    for k in qa_p:
        a, b = qa_p[k].asnumpy(), np.asarray(qa_r[k].asnumpy())
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    want = _internals(R, qs_r, qa_r, qx_r, x, R.cpu())
    ran, bad = replay_quantized_nodes(qs_r, want, mx.cpu())
    assert ran >= 6 and not bad, bad
    got = _internals(mx, qs_p, qa_p, qx_p, x, mx.cpu())
    head = qs_r._outputs[0]
    g, w = got[(head[0].name, head[1])], want[(head[0].name, head[1])]
    assert np.max(np.abs(g - w)) <= 2e-2 * np.max(np.abs(w))


def test_threshold_search_equals_the_reference_s():
    """The KL search on the same histograms: equal thresholds, searched
    serially and in the forked workers."""
    import mxnet_tpu.contrib.quantization as RQ
    rng = np.random.RandomState(2)
    coll = qz.LayerHistogramCollector(num_bins=801, num_quantized_bins=63)
    rcoll = RQ.LayerHistogramCollector(num_bins=801, num_quantized_bins=63)
    for i in range(9):               # enough layers for the worker pool
        a = rng.standard_t(3 + i, 4000) * (1 + i)
        for c in (coll, rcoll):
            c.collect("l%d" % i, a)
            c.collect("l%d" % i, a * 1.5)
    assert len(coll.hist) >= qz._PARALLEL_FROM
    assert coll.thresholds() == rcoll.thresholds()
