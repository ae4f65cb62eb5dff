"""Gluon's fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``.

Port of ``mxnet_tpu/gluon/rnn/rnn_layer.py``: one flat ``parameters``
vector in the fused ``RNN`` op's packing (``ops/rnn_op.py``), its size
deferred to the first input when ``input_size`` is 0; TNC or NTC
layout; the initial states zeros on the input's device unless given,
and ``(out, states)`` returned only when states were passed.
"""
from __future__ import annotations

from ... import ndarray as nd
from ...ops.rnn_op import rnn_param_size
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, prefix=None, params=None,
                 **kwargs):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        with self.name_scope():
            self.parameters = self.params.get(
                "parameters", shape=(rnn_param_size(
                    mode, num_layers, input_size, hidden_size,
                    bidirectional) if input_size else 0,),
                allow_deferred_init=True, init=None)

    def _infer_param_shapes(self, x, *args):
        if self.parameters.shape is None or 0 in self.parameters.shape:
            self._input_size = x.shape[2]
            self.parameters.shape = (rnn_param_size(
                self._mode, self._num_layers, self._input_size,
                self._hidden_size, self._dir == 2),)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"}] * \
            (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def hybrid_forward(self, F, inputs, states=None, parameters=None):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)
        explicit_states = states is not None
        if states is None:
            states = self.begin_state(inputs.shape[1], ctx=inputs.context,
                                      dtype=str(inputs.dtype))
        if not isinstance(states, (list, tuple)):
            states = [states]
        result = F.RNN(inputs, parameters, *states,
                       state_size=self._hidden_size,
                       num_layers=self._num_layers, mode=self._mode,
                       bidirectional=self._dir == 2, p=self._dropout,
                       state_outputs=True)
        out, out_states = result[0], list(result[1:])
        if self._layout == "NTC":
            out = F.swapaxes(out, 0, 1)
        return (out, out_states) if explicit_states else out

    def __repr__(self):
        return "%s(%s -> %s, %s%s)" % (
            type(self).__name__, self._input_size or None,
            self._hidden_size, self._layout,
            ", bidirectional" if self._dir == 2 else "")


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "rnn_" + activation,
                         **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (gates ``[i, f, c, o]``); states ``[h, c]``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (gates ``[r, z, n]``)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
