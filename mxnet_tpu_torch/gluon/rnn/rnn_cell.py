"""Gluon's recurrent cells, stepped one input at a time or unrolled.

Port of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (all twelve names of its
``__all__``): ``RNNCell``, ``LSTMCell`` and ``GRUCell`` with the fused
op's gate orders (``[i, f, c, o]``, ``[r, z, n]``), so a cell's
``i2h``/``h2h`` weights and biases packed into the fused layer's flat
vector give that layer's result; ``unroll`` with ``merge_outputs`` and
``valid_length`` (``SequenceLast`` for the states, ``SequenceMask`` for
the outputs); the modifier cells (dropout, zoneout, residual,
variational dropout with one mask per sequence), ``SequentialRNNCell``
and ``BidirectionalCell``.
"""
from __future__ import annotations

from ... import autograd
from ... import ndarray as nd
from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell", "ModifierCell",
           "VariationalDropoutCell"]


class RecurrentCell(HybridBlock):
    """Base of the cells: ``state_info``, ``begin_state`` and
    ``unroll``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Start a new sequence (the modifiers drop their masks)."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """The initial states, each ``func(shape=..., **kwargs)``."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info, **kwargs)
            states.append(func(shape=info["shape"],
                               **{k: v for k, v in info.items()
                                  if k not in ("shape", "__layout__")}))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell over ``length`` steps of ``inputs`` (axis ``T``
        of ``layout``): (outputs, final states).  With
        ``valid_length`` (one length per sequence) each sequence's
        states are those of its last valid step and its outputs past
        its end are zeros.  ``merge_outputs=False`` returns the outputs
        as a list, else stacked on the time axis."""
        self.reset()
        axis = layout.find("T")
        batch_size = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=inputs.context,
                                           dtype=str(inputs.dtype))
        states = begin_state
        outputs, all_states = [], []
        seq = nd.split(inputs, num_outputs=length, axis=axis,
                       squeeze_axis=True) if length > 1 else \
            [inputs.squeeze(axis=axis)]
        for i in range(length):
            output, states = self(seq[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      valid_length, use_sequence_length=True,
                                      axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(outputs, length,
                                                     valid_length)
        if merge_outputs is False:
            return outputs, states
        return nd.stack(*outputs, axis=axis), states

    def forward_raw(self, inputs, states):
        self._counter += 1
        return super().forward_raw(inputs, states)


def _mask_sequence_variable_length(outputs, length, valid_length):
    masked = nd.SequenceMask(nd.stack(*outputs, axis=0), valid_length,
                             use_sequence_length=True, axis=0)
    return [masked[i] for i in range(length)]


class _GatedCell(RecurrentCell):
    """A cell of ``gates`` gates with ``i2h``/``h2h`` weights and
    biases, the input width deferred when ``input_size`` is 0."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        rows = self._gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(rows, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(rows, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(rows,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(rows,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def _infer_param_shapes(self, inputs, states, *args):
        if 0 in self.i2h_weight.shape:
            self.i2h_weight.shape = (self._gates * self._hidden_size,
                                     inputs.shape[-1])

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    """Elman cell: ``act(W x + b + R h + c)``."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        self._activation = activation
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        prev = states[0] if isinstance(states, (list, tuple)) else states
        i2h, h2h = self._projections(F, inputs, prev, i2h_weight, h2h_weight,
                                     i2h_bias, h2h_bias)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gates ``[i, f, c, o]``; states ``[h, c]``."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None,
                 activation="tanh", recurrent_activation="sigmoid"):
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * 2

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        slices = F.split(i2h + h2h, num_outputs=4, axis=1)
        rec = self._recurrent_activation
        in_gate = F.Activation(slices[0], act_type=rec)
        forget_gate = F.Activation(slices[1], act_type=rec)
        in_transform = F.Activation(slices[2], act_type=self._activation)
        out_gate = F.Activation(slices[3], act_type=rec)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type=self._activation)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gates ``[r, z, n]``."""

    _gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        prev = states[0] if isinstance(states, (list, tuple)) else states
        i2h, h2h = self._projections(F, inputs, prev, i2h_weight, h2h_weight,
                                     i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its own
    slice of the states."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._children.values()
                for info in cell.state_info(batch_size)]

    def begin_state(self, batch_size=0, **kwargs):
        return [s for cell in self._children.values()
                for s in cell.begin_state(batch_size, **kwargs)]

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(state)
        return inputs, next_states

    def forward(self, inputs, states):
        return self.__call__(inputs, states)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class ModifierCell(RecurrentCell):
    """A cell wrapped by another that changes its inputs, outputs or
    states; the base cell is then called only through it."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class _IdentityCell(RecurrentCell):
    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        return inputs, states


class DropoutCell(ModifierCell):
    """Dropout on the base cell's output.  Takes ``DropoutCell(rate)``
    (over an identity cell, the upstream signature) or
    ``DropoutCell(base_cell, rate)``, as the reference."""

    def __init__(self, base_cell=None, rate=0.0, axes=()):
        if not isinstance(base_cell, RecurrentCell):
            rate = base_cell if base_cell is not None else rate
            base_cell = _IdentityCell()
        super().__init__(base_cell)
        self.rate = rate
        self.axes = axes

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        if self.rate > 0:
            output = nd.Dropout(output, p=self.rate, axes=self.axes)
        return output, states


class ZoneoutCell(ModifierCell):
    """Zoneout: each output and state element keeps its previous value
    with probability ``zoneout_outputs`` / ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states

        def mask(p, like):
            return nd.Dropout(nd.ones_like(like), p=p, mode="always")

        prev_output = self._prev_output if self._prev_output is not None \
            else nd.zeros_like(next_output)
        output = nd.where(mask(p_outputs, next_output), next_output,
                          prev_output) if p_outputs != 0. else next_output
        new_states = [nd.where(mask(p_states, ns), ns, s)
                      for ns, s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed,
    outputs concatenated; unrolled only."""

    def __init__(self, l_cell, r_cell):
        super().__init__(prefix=None, params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        l, r = self._children["l_cell"], self._children["r_cell"]
        return l.state_info(batch_size) + r.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        l, r = self._children["l_cell"], self._children["r_cell"]
        return l.begin_state(batch_size, **kwargs) + \
            r.begin_state(batch_size, **kwargs)

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use "
                         "unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        batch_size = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=inputs.context)
        l_cell = self._children["l_cell"]
        r_cell = self._children["r_cell"]
        n_l = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(length, inputs, begin_state[:n_l],
                                        layout, False, valid_length)
        if valid_length is None:
            rev = nd.flip(inputs, axis=axis)
        else:
            rev = nd.SequenceReverse(nd.swapaxes(inputs, 0, axis) if axis
                                     else inputs, valid_length,
                                     use_sequence_length=True, axis=0)
            if axis:
                rev = nd.swapaxes(rev, 0, axis)
        r_out, r_states = r_cell.unroll(length, rev, begin_state[n_l:],
                                        layout, False, valid_length)
        outputs = [nd.concat(lo, ro, dim=1)
                   for lo, ro in zip(l_out, r_out[::-1])]
        return nd.stack(*outputs, axis=axis), l_states + r_states


# the reference's hybridizable base is the same class under this name
HybridRecurrentCell = RecurrentCell


class VariationalDropoutCell(ModifierCell):
    """Variational dropout: one mask per sequence for the inputs, the
    hidden state ``states[0]`` and the outputs, drawn at the first step
    and reused until ``reset``; only in training."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._mask_cache = {}

    def reset(self):
        super().reset()
        self._mask_cache = {}

    def _mask(self, kind, x, rate):
        key = (kind, tuple(x.shape))
        if key not in self._mask_cache:
            self._mask_cache[key] = nd.random_uniform(
                shape=x.shape, ctx=x.context) < 1.0 - rate
        return self._mask_cache[key].astype(x.dtype) / (1.0 - rate)

    def forward(self, inputs, states):
        train = autograd.is_training()
        if train and self.drop_inputs:
            inputs = inputs * self._mask("i", inputs, self.drop_inputs)
        if train and self.drop_states and states:
            # as the reference: only the hidden state h; an LSTM's memory
            # cell c passes unmasked
            states = ([states[0] * self._mask("s", states[0],
                                              self.drop_states)]
                      + list(states[1:]))
        output, states = self.base_cell(inputs, states)
        if train and self.drop_outputs:
            output = output * self._mask("o", output, self.drop_outputs)
        return output, states
