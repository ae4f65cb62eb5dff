"""Port parity: the space-to-depth ResNet stem and the shape ops under it
(``pad``, ``space_to_depth``, ``depth_to_space``) against the
reference's.

Tolerances.  The shape ops move data only, so they are held bit for
bit.  ``SpaceToDepthStem`` with ``convert_weight`` against the 7x7/s2
convolution, and against the reference's stem on the same weights,
within rtol 1e-5, atol 1e-5 (f32 convolutions summing 147 or 192 taps
in another order), as the reference's own ``test_s2d_stem_exact``
holds it.  A predict-mode ResNet-18 v1 forward with the stem within
1e-5 of its output scale.
"""
import numpy as np
import pytest


def _nd(pkg, a):
    import mxnet_tpu_torch as mx
    if pkg is mx:
        return mx.nd.array(a, ctx=mx.cpu())
    return pkg.nd.array(a)


@pytest.mark.parametrize("op,shape,kw", [
    ("space_to_depth", (2, 3, 8, 6), {"block_size": 2}),
    ("space_to_depth", (1, 2, 9, 6), {"block_size": 3}),
    ("depth_to_space", (2, 12, 4, 3), {"block_size": 2}),
    ("depth_to_space", (1, 18, 2, 3), {"block_size": 3}),
    ("pad", (2, 3, 5, 4), {"mode": "constant", "constant_value": 1.5,
                           "pad_width": (0, 0, 0, 0, 2, 1, 2, 1)}),
    ("pad", (2, 3, 5, 4), {"mode": "constant", "constant_value": 0,
                           "pad_width": (1, 0, 0, 2, 1, 1, 0, 3)}),
    ("pad", (2, 3, 5, 4), {"mode": "edge",
                           "pad_width": (0, 0, 0, 0, 2, 1, 3, 1)}),
    ("pad", (2, 3, 5, 4), {"mode": "reflect",
                           "pad_width": (0, 0, 0, 0, 2, 1, 3, 1)}),
    ("pad", (2, 3, 4, 5, 6), {"mode": "reflect",
                              "pad_width": (0, 0, 0, 0, 1, 2, 3, 1, 2, 2)}),
    ("pad", (2, 3, 5), {"mode": "edge", "pad_width": (0, 0, 2, 0, 1, 3)}),
])
def test_shape_ops_bit_identical(op, shape, kw):
    """The port's op against the reference's, bit for bit, and its
    gradient (the reference's ``autograd``) bit for bit too."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        a = _nd(pkg, x)
        a.attach_grad()
        with pkg.autograd.record():
            y = getattr(pkg.nd, op)(a, **kw)
        y.backward(_nd(pkg, np.arange(np.prod(y.shape), dtype=np.float32)
                       .reshape(y.shape)))
        outs.append((y.asnumpy(), a.grad.asnumpy()))
    (want, want_g), (got, got_g) = outs
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_g, want_g)


def test_space_to_depth_channel_order_and_inverse():
    """Output channel (di*b + dj)*C + c holds pixel (b*y + di, b*x + dj)
    of channel c, and depth_to_space undoes it."""
    import mxnet_tpu_torch as mx
    x = np.random.RandomState(1).randn(2, 3, 4, 6).astype(np.float32)
    z = mx.nd.space_to_depth(_nd(mx, x), block_size=2).asnumpy()
    for di in range(2):
        for dj in range(2):
            np.testing.assert_array_equal(
                z[:, (di * 2 + dj) * 3:(di * 2 + dj + 1) * 3],
                x[:, :, di::2, dj::2])
    back = mx.nd.depth_to_space(_nd(mx, z), block_size=2).asnumpy()
    np.testing.assert_array_equal(back, x)


def test_s2d_stem_exact():
    """Twin of tests/test_gluon.py::test_s2d_stem_exact: the converted
    weights reproduce the 7x7/s2 convolution."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        SpaceToDepthStem
    rng = np.random.RandomState(0)
    with mx.cpu():
        x = mx.nd.array(rng.randn(2, 3, 32, 32).astype("float32"))
        w7 = rng.randn(8, 3, 7, 7).astype("float32") * 0.1
        ref = mx.nd.Convolution(x, mx.nd.array(w7), kernel=(7, 7),
                                stride=(2, 2), pad=(3, 3), num_filter=8,
                                no_bias=True)
        stem = SpaceToDepthStem(8)
        stem.initialize()
        stem(x)
        stem.conv.weight.set_data(
            mx.nd.array(SpaceToDepthStem.convert_weight(w7)))
        out = stem(x)
    assert out.shape == ref.shape == (2, 8, 16, 16)
    np.testing.assert_allclose(out.asnumpy(), ref.asnumpy(), rtol=1e-5,
                               atol=1e-5)


def test_s2d_stem_matches_reference_stem():
    """``convert_weight`` equals the reference's, and the two stems on
    the same converted weights agree."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu.gluon.model_zoo.vision.resnet import \
        SpaceToDepthStem as JStem
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        SpaceToDepthStem as TStem
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 40, 24).astype(np.float32)
    w7 = rng.randn(16, 3, 7, 7).astype(np.float32) * 0.1
    w4 = TStem.convert_weight(w7)
    np.testing.assert_array_equal(w4, JStem.convert_weight(w7))
    outs = []
    for pkg, Stem in ((jmx, JStem), (mx, TStem)):
        stem = Stem(16)
        stem.initialize(ctx=pkg.cpu())
        stem(_nd(pkg, x))
        stem.conv.weight.set_data(_nd(pkg, w4))
        outs.append(stem(_nd(pkg, x)).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("version", [1, 2])
def test_resnet50_s2d_names_match_reference(version):
    """``resnet50_v1/v2(stem_s2d=True)`` build with the reference's
    structural names and declared shapes, so ``set_block_params`` carries
    a reference net's weights across."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    name = "resnet50_v%d" % version
    ref = getattr(jmx.gluon.model_zoo.vision, name)(stem_s2d=True)
    net = getattr(mx.gluon.model_zoo.vision, name)(stem_s2d=True)
    want = ref._collect_params_with_prefix()
    got = net._collect_params_with_prefix()
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    stem = "features.%d.conv.weight" % (version - 1)
    assert got[stem].shape == (64, 12, 4, 4)
    assert [n.split("_", 1)[1] for n in net.collect_params()] == \
        [n.split("_", 1)[1] for n in ref.collect_params()]


def test_resnet18_s2d_forward_matches_reference():
    """Weights carried across; a predict-mode forward of resnet18_v1
    with the stem at 32 x 32 agrees with the reference's."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.convert import set_block_params
    x = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    np.random.seed(3)
    jnet = jmx.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                  stem_s2d=True)
    jnet.initialize(jmx.initializer.Xavier(), ctx=jmx.cpu())
    want = jnet(jmx.nd.array(x)).asnumpy()
    tnet = mx.gluon.model_zoo.vision.resnet18_v1(classes=10, stem_s2d=True)
    set_block_params(tnet, {k: v.data().asnumpy() for k, v in
                            jnet._collect_params_with_prefix().items()},
                     ctx=mx.cpu())
    got = tnet(_nd(mx, x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
