"""The port's convolution, pooling and padding layers
(``gluon/nn/conv_layers.py``) against the reference's, on the CPU, and
the card against the CPU.

Each case of ``_torch_zoo.CONV_CASES`` is built in both packages (the
reference's weights carried across by structural name) and run under
autograd on the same input and head gradient, the port eager and
hybridized: output, input gradient and parameter gradients within
``rtol 1e-5, atol 1e-6`` (f32, as ``test_torch_gluon_layers.py``).  The
cases include in != out channels and groups > 1 (a transposed
convolution's weight is ``(in, out / groups, *kernel)``: a wrong layout
still runs when in == out), strides, dilations, ``output_padding``,
``ceil_mode`` and ``count_include_pad=False``.  The reference's
``Deconvolution`` cannot run with ``num_group > 1`` (its ``IO`` weight
spec meets ``feature_group_count``, ``mxnet_tpu/ops/nn.py:157-164``, and
``jax.lax`` refuses the shapes), so a grouped transposed layer is held
against the reference's ``Deconvolution`` run group by group on the
matching slices of the input and weight, concatenated, plus the bias:
the reference's own arithmetic for each group.  The ``cuda`` cases hold
the card against the CPU from the same weights within the case's
``CARD_TOL`` family (gradients at ``GRAD_FACTOR`` times it).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
from mxnet_tpu_torch.convert import set_block_params
from _torch_port import CARD_TOL, GRAD_FACTOR, cuda_device  # noqa: F401
from _torch_zoo import CONV_CASES, run_block

TOL = dict(rtol=1e-5, atol=1e-6)


def _weights(block):
    return {k: v.data().asnumpy()
            for k, v in block._collect_params_with_prefix().items()}


def _port_twin(make, weights, ctx):
    block = make(P)
    block.initialize(ctx=ctx)
    if weights:
        set_block_params(block, weights, ctx=ctx)
    return block


def _reference_layer(make):
    """The reference's layer; a grouped transposed one runs its
    ``Deconvolution`` group by group (the reference refuses groups)."""
    from _torch_port import reference as R
    layer = make(R)
    g = layer._groups if hasattr(layer, "_groups") else 1
    if getattr(layer, "_op_name", "") != "Deconvolution" or g == 1:
        return layer
    kw = dict(layer._kwargs, num_group=1, no_bias=True,
              num_filter=layer._channels // g)

    def by_group(F, x, weight=None, bias=None):
        cin = x.shape[1] // g
        out = F.concat(*[F.Deconvolution(
            F.slice_axis(x, axis=1, begin=j * cin, end=(j + 1) * cin),
            F.slice_axis(weight, axis=0, begin=j * cin, end=(j + 1) * cin),
            **kw) for j in range(g)], dim=1)
        if bias is not None:
            out = F.broadcast_add(out, bias.reshape(
                (1, -1) + (1,) * (len(out.shape) - 2)))
        return out

    layer.hybrid_forward = by_group
    return layer


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_layer_matches_the_reference(name, hybridize):
    from _torch_port import reference as R
    make, x, _ = CONV_CASES[name]
    np.random.seed(0)
    ref = _reference_layer(make)
    ref.initialize(R.initializer.Uniform(0.5))
    ref(R.nd.array(x))
    want = run_block(R, ref, x, R.cpu())
    port = _port_twin(make, _weights(ref), P.cpu())
    port.hybridize(hybridize)
    got = run_block(P, port, x, P.cpu())
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(a, b, err_msg="%s %d" % (name, k), **TOL)


def test_transpose_weight_layout_and_deferred_shape():
    """``Conv2DTranspose(6, groups=3)`` on 3 input channels: weight
    ``(3, 2, kh, kw)`` from the first input, as the reference infers it
    (``infer_shape``; its forward refuses groups)."""
    from _torch_port import reference as R
    shapes = []
    for pkg, ctx in ((R, R.cpu()), (P, P.cpu())):
        layer = pkg.gluon.nn.Conv2DTranspose(6, (3, 2), groups=3)
        assert layer.weight.shape == (0, 2, 3, 2)
        layer.infer_shape(pkg.nd.array(np.zeros((1, 3, 4, 4), np.float32),
                                       ctx=ctx))
        shapes.append((layer.weight.shape, layer.bias.shape))
    assert shapes[0] == shapes[1] == ((3, 2, 3, 2), (6,))


def test_reflection_pad_int_expands_to_the_last_two_axes():
    layer = P.gluon.nn.ReflectionPad2D(1)
    assert layer._padding == (0, 0, 0, 0, 1, 1, 1, 1)
    x = np.arange(12, dtype=np.float32).reshape(1, 1, 3, 4)
    got = layer(P.nd.array(x, ctx=P.cpu())).asnumpy()
    np.testing.assert_array_equal(
        got, np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="reflect"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_card_matches_cpu(name, cuda_device):
    """The layer on the card against the CPU from the same weights,
    TF32 off, hybridized on the card (a CUDA graph)."""
    make, x, fam = CONV_CASES[name]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    np.random.seed(0)
    cpu = make(P)
    cpu.initialize(P.init.Uniform(0.5), ctx=P.cpu())
    cpu(P.nd.array(x, ctx=P.cpu()))
    card = _port_twin(make, _weights(cpu), P.gpu(0))
    card.hybridize()
    want = run_block(P, cpu, x, P.cpu())
    got = run_block(P, card, x, P.gpu(0))
    rtol, atol = CARD_TOL[fam]
    for k, (a, b) in enumerate(zip(got, want)):
        f = 1.0 if k == 0 else GRAD_FACTOR
        np.testing.assert_allclose(a, b, rtol=rtol * f, atol=atol * f,
                                   err_msg="%s %d" % (name, k))
