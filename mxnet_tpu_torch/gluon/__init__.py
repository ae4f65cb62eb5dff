"""Gluon, the imperative NN API (port of ``mxnet_tpu/gluon``): blocks,
parameters, ``SymbolBlock``, layers, losses, the Trainer and the ResNet
model zoo."""
from .parameter import Parameter, ParameterDict, \
    DeferredInitializationError  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, model_zoo  # noqa: F401
