"""``mx.npx``: operator extensions beyond the NumPy standard.

Port of ``mxnet_tpu/numpy_extension/__init__.py`` (the neural-net ops,
framework utilities and the ``set_np`` switch).  Each function goes
through the shared op registry, so results are ``mx.np.ndarray`` and
autograd, AMP and hybridize apply as usual.  ``tpu()`` refuses, as
``mx.tpu()`` does in the port.
"""
from __future__ import annotations

from ..ops.registry import get_op, invoke
from ..numpy import _as_np, _to_input
from ..util import set_np, reset_np, is_np_array, use_np  # noqa: F401


def _apply(op_name, *inputs, **attrs):
    ins = [_to_input(i) for i in inputs]
    return _as_np(invoke(get_op(op_name), ins, (), attrs))


# ------------------------------------------------------------- nn activations

def relu(x):
    return _apply("relu", x)


def sigmoid(x):
    return _apply("sigmoid", x)


def softmax(x, axis=-1):
    return _apply("softmax", x, axis=axis)


def log_softmax(x, axis=-1):
    return _apply("log_softmax", x, axis=axis)


def leaky_relu(x, slope=0.25):
    return _apply("LeakyReLU", x, act_type="leaky", slope=slope)


def gelu(x):
    return _apply("LeakyReLU", x, act_type="gelu")


def activation(x, act_type="relu"):
    return _apply("Activation", x, act_type=act_type)


# --------------------------------------------------------------- nn layers

def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    if bias is None:
        no_bias = True
        return _apply("FullyConnected", x, weight, num_hidden=num_hidden,
                      no_bias=True, flatten=flatten)
    return _apply("FullyConnected", x, weight, bias, num_hidden=num_hidden,
                  no_bias=no_bias, flatten=flatten)


def convolution(x, weight, bias=None, **attrs):
    if bias is None:
        return _apply("Convolution", x, weight, no_bias=True, **attrs)
    return _apply("Convolution", x, weight, bias, **attrs)


def pooling(x, **attrs):
    return _apply("Pooling", x, **attrs)


def batch_norm(x, gamma, beta, running_mean, running_var, **attrs):
    return _apply("BatchNorm", x, gamma, beta, running_mean, running_var,
                  **attrs)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    return _apply("LayerNorm", x, gamma, beta, axis=axis, eps=eps)


def dropout(x, p=0.5, **attrs):
    return _apply("Dropout", x, p=p, **attrs)


def embedding(x, weight, input_dim=None, output_dim=None, **attrs):
    return _apply("Embedding", x, weight, input_dim=input_dim,
                  output_dim=output_dim, **attrs)


def one_hot(x, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    return _apply("one_hot", x, depth=depth, on_value=on_value,
                  off_value=off_value, dtype=dtype)


def pick(x, index, axis=-1, mode="clip", keepdims=False):
    return _apply("pick", x, index, axis=axis, mode=mode, keepdims=keepdims)


def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False):
    return _apply("topk", x, axis=axis, k=k, ret_typ=ret_typ,
                  is_ascend=is_ascend)


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    return _apply("batch_dot", a, b, transpose_a=transpose_a,
                  transpose_b=transpose_b)


def gamma(x):
    return _apply("gamma", x)


def gammaln(x):
    return _apply("gammaln", x)


def erf(x):
    return _apply("erf", x)


def erfinv(x):
    return _apply("erfinv", x)


def reshape_like(a, b):
    return _apply("reshape_like", a, b)


def arange_like(a, start=0.0, step=1.0, axis=None):
    from ..numpy import arange
    n = a.shape[axis] if axis is not None else a.size
    return arange(start, start + step * n, step)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if sequence_length is None:
        return _apply("SequenceMask", data, value=value, axis=axis,
                      use_sequence_length=use_sequence_length)
    return _apply("SequenceMask", data, sequence_length, value=value,
                  axis=axis, use_sequence_length=use_sequence_length)


# ----------------------------------------------------------------- utilities

def waitall():
    from ..ndarray import waitall as w
    w()


def seed(s):
    from .. import random
    random.seed(s)


def cpu(device_id=0):
    from ..context import cpu as _cpu
    return _cpu(device_id)


def gpu(device_id=0):
    from ..context import gpu as _gpu
    return _gpu(device_id)


def tpu(device_id=0):
    from ..context import tpu as _tpu
    return _tpu(device_id)


def num_gpus():
    from ..context import num_gpus as n
    return n()


def current_device():
    from ..context import current_context
    return current_context()


# module-level conveniences the reference exposes on npx
from ..ndarray import load, save  # noqa: E402,F401
from ..context import current_context  # noqa: E402,F401
