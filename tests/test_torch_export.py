"""``HybridBlock.export`` and ``gluon.SymbolBlock`` of the port: twins of
tests/test_export_deploy.py's six cases, and the files crossing between
the packages, on the CPU.

Tolerances (f32): a ``SymbolBlock`` serving an export against the block
that wrote it, within rtol 1e-5, atol 1e-6 (the same ops on the same
weights, one at a time in both); the folded (``fold_conv_bn``) graph
within rtol 1e-4, atol 1e-5 (folding changes the arithmetic); the
port's block and ``SymbolBlock`` against the reference's on the same
exported files within rtol 1e-5, atol 1e-6.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as R
import mxnet_tpu_torch as P
from mxnet_tpu_torch import nd, sym
from mxnet_tpu_torch.gluon import SymbolBlock, nn

CPU = P.cpu()


def _net(mx=P, seed=0):
    np.random.seed(seed)
    with mx.name.NameManager():
        net = mx.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(mx.gluon.nn.Conv2D(4, 3, padding=1),
                    mx.gluon.nn.BatchNorm(), mx.gluon.nn.Activation("relu"),
                    mx.gluon.nn.GlobalAvgPool2D(), mx.gluon.nn.Dense(3))
    if mx is P:
        net.initialize(P.initializer.Xavier(), ctx=CPU)
    else:
        net.initialize(R.initializer.Xavier())
    return net


def _x(seed, n=2):
    return np.random.RandomState(seed).randn(n, 2, 8, 8).astype(np.float32)


def _a(x):
    return nd.array(x, ctx=CPU)


def test_export_writes_real_symbol(tmp_path):
    net = _net()
    net(_a(_x(0)))
    prefix = str(tmp_path / "model")
    net.export(prefix)
    s = sym.load(prefix + "-symbol.json")
    ops = [n.op.name for n in s._nodes() if not n.is_var]
    assert "Convolution" in ops and "BatchNorm" in ops
    assert "FullyConnected" in ops
    loaded = nd.load(prefix + "-0000.params")
    assert any(k.startswith("arg:") for k in loaded)
    assert any(k.startswith("aux:") for k in loaded)


def test_symbolblock_imports_matches_block(tmp_path):
    net = _net()
    x = _a(_x(0))
    with P.autograd.record():       # move the running statistics
        net(x)
    ref = net(x).asnumpy()
    prefix = str(tmp_path / "model")
    net.export(prefix)
    served = SymbolBlock.imports(prefix + "-symbol.json", "data",
                                 prefix + "-0000.params", ctx=CPU)
    np.testing.assert_allclose(served(x).asnumpy(), ref, rtol=1e-5,
                               atol=1e-6)
    # a new batch size, then the same through hybridize()
    x2 = _a(_x(1, n=5))
    assert served(x2).shape == (5, 3)
    want = served(x2).asnumpy()
    served.hybridize()
    np.testing.assert_array_equal(served(x2).asnumpy(), want)
    np.testing.assert_array_equal(served(x2).asnumpy(), want)


def test_exported_graph_optimizes(tmp_path):
    net = _net()
    x = _a(_x(1))
    net(x)
    ref = net(x).asnumpy()
    prefix = str(tmp_path / "model")
    net.export(prefix)
    s = sym.load(prefix + "-symbol.json")
    loaded = nd.load(prefix + "-0000.params")
    args = {k[4:]: v for k, v in loaded.items() if k.startswith("arg:")}
    aux = {k[4:]: v for k, v in loaded.items() if k.startswith("aux:")}
    s2, args2, aux2 = s.optimize_for("fold_conv_bn", args, aux)
    assert "BatchNorm" not in [n.op.name for n in s2._nodes()
                               if not n.is_var]
    ex = s2.bind(ctx=CPU, args=dict(args2, data=x), aux_states=aux2)
    np.testing.assert_allclose(ex.forward()[0].asnumpy(), ref, rtol=1e-4,
                               atol=1e-5)


def test_symbolblock_in_hybrid_parent(tmp_path):
    net = _net()
    net(_a(_x(2)))
    prefix = str(tmp_path / "model")
    net.export(prefix)
    served = SymbolBlock.imports(prefix + "-symbol.json", "data",
                                 prefix + "-0000.params", ctx=CPU)
    out_sym = served(sym.Variable("data"))
    assert "FullyConnected" in [n.op.name for n in out_sym._nodes()
                                if not n.is_var]
    # and it composes inside another block's graph
    with P.name.NameManager():
        parent = nn.HybridSequential(prefix="outer_")
        parent.add(served, nn.Dense(2, prefix="head_"))
    parent[1].initialize(ctx=CPU)
    parent(_a(_x(2)))
    graph = parent(sym.Variable("data"))
    assert graph.list_arguments()[-2:] == ["head_weight", "head_bias"]


def test_symbolblock_inputs_not_mutated(tmp_path):
    net = _net()
    x1, x2 = _a(_x(3)), _a(_x(4))
    net(x1)
    prefix = str(tmp_path / "m")
    net.export(prefix)
    served = SymbolBlock.imports(prefix + "-symbol.json", "data",
                                 prefix + "-0000.params", ctx=CPU)
    x1_copy = x1.asnumpy().copy()
    served(x1)
    served(x2)
    np.testing.assert_array_equal(x1.asnumpy(), x1_copy)


def test_symbolblock_fine_tunes(tmp_path):
    net = _net()
    rng = np.random.RandomState(4)
    x = nd.array(rng.randn(8, 2, 8, 8).astype("float32"), ctx=CPU)
    y = nd.array(rng.randint(0, 3, (8,)).astype("float32"), ctx=CPU)
    net(x)
    prefix = str(tmp_path / "m")
    net.export(prefix)
    served = SymbolBlock.imports(prefix + "-symbol.json", "data",
                                 prefix + "-0000.params", ctx=CPU)
    trainer = P.gluon.Trainer(served.collect_params(), "sgd",
                              {"learning_rate": 0.1})
    loss_fn = P.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(5):
        with P.autograd.record():
            L = loss_fn(served(x), y)
        L.backward()
        trainer.step(8)
        losses.append(float(L.asnumpy().mean()))
    assert losses[-1] < losses[0], losses
    # the running statistics moved once per recorded step
    mm = served.collect_params()["net_batchnorm0_running_mean"]
    assert np.abs(mm.data().asnumpy()).max() > 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_export_crosses_packages(writer, tmp_path):
    """The same net (the reference's weights) exported by either package
    gives the same JSON, and each package serves either package's files
    to the reference block's output."""
    rnet = _net(R)
    x = _x(5)
    with R.autograd.record():
        rnet(R.nd.array(x))
    want = rnet(R.nd.array(x)).asnumpy()
    pnet = _net(P)
    pnet(_a(x))
    for p in pnet.collect_params().values():
        p.set_data(rnet.collect_params()[p.name].data().asnumpy().copy())
    np.testing.assert_allclose(pnet(_a(x)).asnumpy(), want, rtol=1e-5,
                               atol=1e-6)
    prefixes = {}
    for name, net, mx in (("ref", rnet, R), ("port", pnet, P)):
        prefixes[name] = str(tmp_path / name)
        with mx.name.NameManager():
            net.export(prefixes[name])
    files = [json.load(open(p + "-symbol.json")) for p in prefixes.values()]
    assert files[0] == files[1]
    prefix = prefixes[writer]
    rserved = R.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                          prefix + "-0000.params")
    pserved = SymbolBlock.imports(prefix + "-symbol.json", "data",
                                  prefix + "-0000.params", ctx=CPU)
    np.testing.assert_allclose(rserved(R.nd.array(x)).asnumpy(), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pserved(_a(x)).asnumpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_symbolblock_defaults_to_the_card(tmp_path):
    import torch
    net = _net()
    net(_a(_x(0)))
    prefix = str(tmp_path / "m")
    net.export(prefix)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SymbolBlock.imports(prefix + "-symbol.json", "data",
                            prefix + "-0000.params")
