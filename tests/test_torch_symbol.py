"""The port's Symbol API (``mxnet_tpu_torch/symbol/``) against the
reference's (``mxnet_tpu/symbol/``), on the CPU.

Graphs: examples/nmt_bucketing.py's ``sym_gen(L)`` for each bucket, the
MLP of tests/test_symbol_module.py, an exported thumbnail ResNet-18 and
ResNet-50 v1.  Each graph is built under a fresh ``mx.name.NameManager``
and an explicit block prefix in both packages (the auto-name counters
are per process).  What is held:

* ``list_arguments``/``list_auxiliary_states``/``list_outputs`` equal;
* ``tojson()`` equal as parsed JSON, and each package loads the other's
  ``-symbol.json`` to the same graph;
* ``infer_shape``/``infer_type`` of every argument, output and aux state
  of ResNet-50 at 224 x 224 equal (the port runs its op impls on
  ``meta`` tensors, the reference ``jax.eval_shape``);
* symbol arithmetic, ``Group`` and ``get_internals`` give the same
  graphs and the same values (f32, within 1e-6 of 1 + |value|);
* the passes: ``fold_conv_bn`` and ``eliminate_common_expr`` leave the
  reference's node counts and outputs (within 1e-5 of 1 + |value|), and
  ``contrib.amp.convert_symbol`` inserts the reference's cast nodes.
"""
import json
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import nmt_bucketing  # noqa: E402  (the reference's NMT example)

BUCKETS = nmt_bucketing.BUCKETS


def nmt_sym_gen(mx):
    """examples/nmt_bucketing.py's ``sym_gen``: the example's own for the
    reference, restated over the port's ``mx`` for the port."""
    if mx is R:
        return nmt_bucketing.sym_gen

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        emb = mx.sym.Embedding(data, input_dim=32, output_dim=16, name="emb")
        fc = mx.sym.FullyConnected(emb, num_hidden=32, flatten=False,
                                   name="fc")
        out = mx.sym.SoftmaxOutput(fc, preserve_shape=True,
                                   normalization="valid", name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def mlp(mx):
    """tests/test_symbol_module.py's ``_mlp``."""
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax", normalization="batch")


def both(build):
    """``build(mx)`` in each package under a fresh NameManager."""
    out = []
    for mx in (R, P):
        with mx.name.NameManager():
            out.append(build(mx))
    return out


def resnet_graph(mx, name, x, **kw):
    """The model zoo's ``name`` (prefix ``net_``) initialized on the CPU,
    one forward on ``x``, then called on ``sym.Variable("data")``: the
    graph ``export`` writes."""
    np.random.seed(0)
    with mx.name.NameManager():
        net = getattr(mx.gluon.model_zoo.vision, name)(prefix="net_", **kw)
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(x, ctx=mx.cpu()))
        return net(mx.sym.Variable("data"))


@pytest.fixture(scope="module")
def resnet50():
    x = np.zeros((1, 3, 32, 32), np.float32)
    return (resnet_graph(R, "resnet50_v1", x),
            resnet_graph(P, "resnet50_v1", x))


def graphs():
    cases = [("mlp", mlp)]
    cases += [("nmt%d" % L, lambda mx, L=L: nmt_sym_gen(mx)(L)[0])
              for L in BUCKETS]
    cases.append(("resnet18", lambda mx: resnet_graph(
        mx, "resnet18_v1", np.zeros((2, 3, 32, 32), np.float32),
        classes=10, thumbnail=True)))
    return cases


@pytest.mark.parametrize("name,build", graphs(), ids=[c[0] for c in graphs()])
def test_listing_and_json_equal(name, build):
    r, p = both(build)
    assert p.list_arguments() == r.list_arguments()
    assert p.list_auxiliary_states() == r.list_auxiliary_states()
    assert p.list_outputs() == r.list_outputs()
    assert json.loads(p.tojson()) == json.loads(r.tojson())


@pytest.mark.parametrize("name,build", graphs(), ids=[c[0] for c in graphs()])
def test_each_package_loads_the_other(name, build, tmp_path):
    r, p = both(build)
    r.save(str(tmp_path / "r-symbol.json"))
    p.save(str(tmp_path / "p-symbol.json"))
    in_port = P.sym.load(str(tmp_path / "r-symbol.json"))
    in_ref = R.sym.load(str(tmp_path / "p-symbol.json"))
    assert json.loads(in_port.tojson()) == json.loads(r.tojson())
    assert json.loads(in_ref.tojson()) == json.loads(p.tojson())


def test_mlp_infer_shape_and_type():
    r, p = both(mlp)
    assert p.infer_shape(data=(8, 16)) == r.infer_shape(data=(8, 16))
    a, o, _ = p.infer_shape(data=(8, 16))
    assert a[1] == (32, 16) and o[0] == (8, 4)
    assert p.infer_type(data="float32") == r.infer_type(data="float32")
    assert p.infer_shape_partial() == (None, None, None)


def test_nmt_infer_shape_per_bucket():
    for L in BUCKETS:
        r, p = both(lambda mx: nmt_sym_gen(mx)(L)[0])
        shapes = {"data": (32, L), "softmax_label": (32, L)}
        assert p.infer_shape(**shapes) == r.infer_shape(**shapes)


def test_resnet50_infer_shape_and_type_at_224(resnet50):
    r, p = resnet50
    assert len(p._nodes()) == 474
    assert len(p.list_arguments()) == 194
    assert len(p.list_auxiliary_states()) == 106
    got = p.infer_shape(data=(64, 3, 224, 224))
    want = r.infer_shape(data=(64, 3, 224, 224))
    assert got == want
    assert got[1] == [(64, 1000)]
    # infer_type needs every shape known: give data one as an attribute
    shape = (64, 3, 224, 224)
    rt = r(data=R.sym.Variable("data", shape=shape)).infer_type(
        data="float32")
    pt = p(data=P.sym.Variable("data", shape=shape)).infer_type(
        data="float32")
    assert pt[0] is not None
    assert [[str(d) for d in k] for k in pt] == \
        [[str(d) for d in k] for k in rt]


def test_arithmetic_group_and_internals():
    def build(mx):
        x = mx.sym.Variable("x")
        y = mx.sym.Variable("y")
        z = (x * 2 + 1) - y / 4 + (1 - x) * y + 3 / (y + 5) + x ** 2
        return mx.sym.Group([z, mx.sym.exp(x), mx.sym.sqrt(y), -x])

    r, p = both(build)
    assert json.loads(p.tojson()) == json.loads(r.tojson())
    assert len(p.list_outputs()) == 4
    assert p.get_internals().list_outputs() == \
        r.get_internals().list_outputs()
    assert any("fc1" in n for n in both(mlp)[1].get_internals()
               .list_outputs())
    rng = np.random.RandomState(0)
    xv = rng.rand(3, 4).astype(np.float32)
    yv = rng.rand(3, 4).astype(np.float32)
    want = [o.asnumpy() for o in r.eval(ctx=R.cpu(), x=R.nd.array(xv),
                                        y=R.nd.array(yv))]
    got = [o.asnumpy() for o in p.eval(
        ctx=P.cpu(), x=P.nd.array(xv, ctx=P.cpu()),
        y=P.nd.array(yv, ctx=P.cpu()))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    # a multi-output symbol indexes and slices like the reference's
    assert p[1].list_outputs() == r[1].list_outputs()
    assert p[1:3].list_outputs() == r[1:3].list_outputs()


def test_compose_and_attrs():
    def build(mx):
        with mx.AttrScope(ctx_group="dev1"):
            a = mx.sym.Variable("a", shape=(2, 3), lr_mult=2.0)
        net = mx.sym.FullyConnected(mx.sym.Variable("in"), num_hidden=3,
                                    name="fc")
        return net(**{"in": a}), a

    (r, ra), (p, pa) = both(build)
    assert json.loads(p.tojson()) == json.loads(r.tojson())
    assert pa.list_attr() == ra.list_attr()
    assert pa.attr("ctx_group") == "dev1"
    assert p.infer_shape() == r.infer_shape()


def test_unported_op_raises():
    """A name neither registry holds raises ``NotImplementedError`` from
    ``sym``; the INT8 ops, ported since, are symbol functions (the
    ``_np_*`` ops stay out of ``sym``, as in the reference)."""
    with pytest.raises(NotImplementedError, match="not ported"):
        P.sym._np_sum
    with pytest.raises(NotImplementedError, match="not ported"):
        P.sym.no_such_operator
    assert callable(P.sym._contrib_quantize)
    assert callable(P.sym.contrib.quantized_conv)


def _exported_pair(tmp_path):
    """A Conv -> BN -> relu -> pool -> Dense net exported by the
    reference; its symbol and params loaded by both packages."""
    np.random.seed(3)
    with R.name.NameManager():
        net = R.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(R.gluon.nn.Conv2D(4, 3, padding=1), R.gluon.nn.BatchNorm(),
                    R.gluon.nn.Activation("relu"),
                    R.gluon.nn.GlobalAvgPool2D(), R.gluon.nn.Dense(3))
        net.initialize(R.initializer.Xavier())
        x = np.random.RandomState(1).randn(2, 2, 8, 8).astype(np.float32)
        with R.autograd.record():       # move the running statistics
            net(R.nd.array(x))
        prefix = str(tmp_path / "m")
        net.export(prefix)
    r_args, r_aux = R.model.load_params(prefix + "-0000.params")
    p_args, p_aux = P.model.load_params(prefix + "-0000.params")
    return (prefix, x, (R.sym.load(prefix + "-symbol.json"), r_args, r_aux),
            (P.sym.load(prefix + "-symbol.json"), p_args, p_aux))


def _infer(mx, sym, args, aux, x):
    ctx = mx.cpu()
    bound = {k: mx.nd.array(v.asnumpy(), ctx=ctx) for k, v in args.items()}
    bound["data"] = mx.nd.array(x, ctx=ctx)
    exe = sym.bind(ctx=ctx, args=bound, aux_states={
        k: mx.nd.array(v.asnumpy(), ctx=ctx) for k, v in aux.items()})
    return exe.forward()[0].asnumpy()


def test_passes_match_the_reference(tmp_path):
    _, x, (rs, ra, rx), (ps, pa, px) = _exported_pair(tmp_path)
    assert P.sym.passes.list_passes() == R.sym.passes.list_passes()
    for name in ("fold_conv_bn", "eliminate_common_expr", "default"):
        r2, ra2, rx2 = rs.optimize_for(name, ra, rx)
        p2, pa2, px2 = ps.optimize_for(name, pa, px)
        assert len(p2._nodes()) == len(r2._nodes())
        assert [n.op.name for n in p2._nodes() if not n.is_var] == \
            [n.op.name for n in r2._nodes() if not n.is_var]
        assert sorted(pa2) == sorted(ra2) and sorted(px2) == sorted(rx2)
        for k in ra2:
            np.testing.assert_allclose(pa2[k].asnumpy(), ra2[k].asnumpy(),
                                       rtol=1e-6, atol=1e-7)
        want = _infer(R, r2, ra2, rx2, x)
        got = _infer(P, p2, pa2, px2, x)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    folded, _, _ = ps.optimize_for("fold_conv_bn", pa, px)
    assert "BatchNorm" not in [n.op.name for n in folded._nodes()
                               if not n.is_var]


def test_cse_merges_duplicates():
    def build(mx):
        x = mx.sym.Variable("x")
        return mx.sym.Group([mx.sym.exp(x) + mx.sym.exp(x),
                             mx.sym.exp(x) * 2])

    r, p = both(build)
    r2, _, _ = r.optimize_for("eliminate_common_expr")
    p2, _, _ = p.optimize_for("eliminate_common_expr")
    assert len(p2._nodes()) == len(r2._nodes()) < len(p._nodes())
    assert json.loads(p2.tojson()) == json.loads(r2.tojson())


def test_amp_convert_symbol_inserts_the_reference_casts(tmp_path):
    from mxnet_tpu.contrib import amp as ramp
    from mxnet_tpu_torch.contrib import amp as pamp
    _, x, (rs, ra, rx), (ps, pa, px) = _exported_pair(tmp_path)
    rc = ramp.convert_symbol(rs, "bfloat16")
    pc = pamp.convert_symbol(ps, "bfloat16")
    assert json.loads(pc.tojson()) == json.loads(rc.tojson())
    casts = [n.name for n in pc._nodes()
             if not n.is_var and n.op.name == "amp_cast"]
    assert casts and all("_amp_cast_" in c for c in casts)
    r3 = ramp.convert_model(rs, ra, rx, target_dtype="bfloat16")
    p3 = pamp.convert_model(ps, pa, px, target_dtype="bfloat16")
    assert json.loads(p3[0].tojson()) == json.loads(r3[0].tojson())
    assert p3[1] is pa and p3[2] is px
    # the bf16 graph runs, within bf16 rounding of the f32 one
    want = _infer(P, ps, pa, px, x)
    got = _infer(P, p3[0], pa, px, x)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
