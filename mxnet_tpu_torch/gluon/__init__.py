"""Gluon, the imperative NN API (port of ``mxnet_tpu/gluon``): blocks,
parameters, ``SymbolBlock``, layers, recurrent layers and cells, losses,
utilities, the Trainer and the vision model zoo."""
from .parameter import Parameter, Constant, ParameterDict, \
    DeferredInitializationError  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, rnn, loss, utils, model_zoo  # noqa: F401
from .utils import split_and_load, split_data  # noqa: F401
