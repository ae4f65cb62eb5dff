"""Port parity: the vision model zoo's names and structure, and the
AlexNet, VGG and SqueezeNet families, against ``mxnet_tpu``.

Every name of the reference's ``get_model`` table builds in the port
with the reference's structural parameter names and declared shapes,
and ``pretrained=True`` raises in every family.  The families run
through ``_torch_zoo.family_parity`` (its docstring states the
limits: outputs within ``1e-5 * max|ref|``, the state after one SGD
step within 1e-6), each at the smallest input its fixed pooling
allows: ``alexnet`` at 64 x 64 and ``vgg11`` at 32 x 32, batch 2, and
``squeezenet1.1`` at 209 x 209, batch 1 (its ``AvgPool2D(13)`` needs a
13 x 13 map at the end; a smaller input leaves the reference an empty
output).  DenseNet, MobileNet and Inception have files of their own,
so that no file runs much over a minute on one worker.
"""
import numpy as np
import pytest

from _torch_zoo import CLASSES, family_parity


def _names():
    from mxnet_tpu.gluon.model_zoo import vision
    return sorted(vision._models)


def test_every_reference_name_builds_with_the_reference_structure():
    """Structural names, declared shapes (0 where deferred), grad_req
    and lr/wd multipliers of every model of the table, in order."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    names = _names()
    assert names == sorted(mx.gluon.model_zoo.vision._models)
    assert len(names) == 34
    for name in names:
        ref = jmx.gluon.model_zoo.vision.get_model(name)
        ref = ref._collect_params_with_prefix()
        got = mx.gluon.model_zoo.get_model(name)._collect_params_with_prefix()
        assert list(got) == list(ref), name
        for k in ref:
            assert (got[k].shape, got[k].grad_req, got[k].lr_mult,
                    got[k].wd_mult) == (ref[k].shape, ref[k].grad_req,
                                        ref[k].lr_mult, ref[k].wd_mult), \
                (name, k)


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "vgg11_bn",
                                  "densenet121", "squeezenet1.0",
                                  "squeezenet1.1", "inceptionv3",
                                  "mobilenet0.25", "mobilenetv2_1.0",
                                  "resnet18_v1"])
def test_pretrained_raises_in_every_family(name):
    """The reference ignores ``pretrained=True`` in five families; the
    port refuses in all of them, naming the missing weights."""
    import mxnet_tpu_torch as mx
    with pytest.raises(mx.MXNetError, match="pretrained"):
        mx.gluon.model_zoo.vision.get_model(name, pretrained=True)


def test_unknown_name_raises():
    import mxnet_tpu_torch as mx
    with pytest.raises(mx.MXNetError, match="not supported"):
        mx.gluon.model_zoo.vision.get_model("lenet")


@pytest.mark.parametrize("name,batch,size", [("alexnet", 2, 64),
                                             ("vgg11", 2, 32),
                                             ("squeezenet1.1", 1, 209)])
def test_family_matches_reference(name, batch, size):
    """Predict- and train-mode forward, then one SGD step."""
    net = family_parity(lambda pkg: pkg.gluon.model_zoo.vision.get_model(
        name, classes=CLASSES), batch, size)
    assert net.collect_params()


def test_hybrid_concurrent_concatenates_its_branches():
    """``HybridConcurrent`` (kept in ``squeezenet``, where Inception and
    DenseNet import it from) against the reference, eager and
    hybridized, with ``axis`` 1 and 2."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import set_block_params
    x = np.random.RandomState(1).randn(2, 3, 5, 5).astype(np.float32)
    for axis in (1, 2):
        nets = []
        for pkg in (jmx, mx):
            c = pkg.gluon.model_zoo.vision.squeezenet.HybridConcurrent(
                axis=axis)
            c.add(pkg.gluon.nn.Conv2D(4, 3, padding=1),
                  pkg.gluon.nn.Conv2D(4 if axis == 2 else 2, 1))
            nets.append(c)
        np.random.seed(2)
        nets[0].initialize(jmx.initializer.Xavier())
        want = nets[0](jmx.nd.array(x)).asnumpy()
        nets[1].initialize(ctx=mx.cpu())
        set_block_params(nets[1], {k: v.data().asnumpy() for k, v in
                                   nets[0]._collect_params_with_prefix()
                                   .items()}, ctx=mx.cpu())
        for hybrid in (False, True):
            nets[1].hybridize(hybrid)
            got = nets[1](mx.nd.array(x, ctx=mx.cpu())).asnumpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
