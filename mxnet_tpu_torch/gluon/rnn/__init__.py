"""Gluon recurrent layers and cells (port of ``mxnet_tpu/gluon/rnn``)."""
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell,  # noqa: F401
                       LSTMCell, GRUCell, SequentialRNNCell, DropoutCell,
                       ZoneoutCell, ResidualCell, BidirectionalCell,
                       ModifierCell, VariationalDropoutCell)
