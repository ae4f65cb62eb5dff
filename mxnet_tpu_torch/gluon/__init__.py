"""Gluon, the imperative NN API (port of ``mxnet_tpu/gluon``): blocks,
parameters, ``SymbolBlock``, layers, recurrent layers and cells, losses,
utilities, the Trainer, the vision model zoo, ``gluon.data`` (datasets,
samplers, the DataLoader, vision transforms) and ``gluon.contrib`` (the
contrib layers and the Estimator)."""
from .parameter import Parameter, Constant, ParameterDict, \
    DeferredInitializationError  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, rnn, loss, utils, data, model_zoo, contrib  # noqa: F401
from .utils import split_and_load, split_data  # noqa: F401
