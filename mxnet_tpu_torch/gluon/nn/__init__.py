"""Gluon layers (port of ``mxnet_tpu/gluon/nn``): the activations, the
basic layers, and the convolution, pooling and padding layers."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
