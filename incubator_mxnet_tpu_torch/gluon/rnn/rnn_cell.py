"""Recurrent cells and ``unroll``.

Counterpart: the JAX package's ``gluon/rnn/rnn_cell.py`` (``:51-464``):
``RecurrentCell`` (``begin_state``, ``unroll`` with ``valid_length``
masking), ``RNNCell``, ``LSTMCell``, ``GRUCell``, ``SequentialRNNCell``
(and its alias ``HybridSequentialRNNCell``), ``DropoutCell``,
``ModifierCell``, ``ZoneoutCell``, ``ResidualCell`` and
``BidirectionalCell``, with the same parameter names (``i2h_weight``,
``h2h_bias`` ...). A cell is a ``HybridBlock`` stepped once per call;
``unroll`` loops it over time on NDArrays, or on tensors inside another
block's ``hybrid_forward``. Initial states are zeros made like the input
(its device and dtype), and the ``valid_length`` masks are device ops, so
an unroll inside a captured graph makes nothing on the host. As in the
JAX package, ``BidirectionalCell.unroll`` with ``valid_length`` returns
the right cell's outputs in its own (reversed) order.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "BidirectionalCell", "ResidualCell",
           "ModifierCell", "ZoneoutCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout):
    """``inputs`` as a list of ``length`` steps, and the time axis (JAX
    counterpart: ``rnn_cell.py:31``)."""
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        return list(inputs), axis
    seq = nd.split(inputs, num_outputs=length or inputs.shape[axis],
                   axis=axis, squeeze_axis=True)
    return (list(seq) if isinstance(seq, (list, tuple)) else [seq]), axis


def _zeros(like):
    """``func`` for ``begin_state``: zeros on ``like``'s device and of its
    dtype, an NDArray for an NDArray, a tensor for a tensor."""
    def func(shape, **_):
        if isinstance(like, NDArray):
            return nd.zeros(shape, ctx=like.context, dtype=like.dtype)
        return like.new_zeros(shape)
    return func


def _mask_sequence_variable_length(data, valid_length):
    """Each step's rows past their sequence's length set to zero (JAX
    counterpart: ``rnn_cell.py:121``)."""
    return [nd.squeeze(nd.SequenceMask(
        nd.expand_dims(d, axis=0), sequence_length=valid_length,
        use_sequence_length=True, axis=0), axis=0) for d in data]


class RecurrentCell(HybridBlock):
    """Base recurrent cell (JAX counterpart: ``rnn_cell.py:51``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(shape=..., **kwargs)`` of each
        (default ``mx.nd.zeros``)."""
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(shape=info["shape"], **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """The cell over ``length`` steps of ``inputs`` (an array with
        time on ``layout``'s ``T`` axis, or a list of steps); returns
        ``(outputs, states)`` (JAX counterpart: ``rnn_cell.py:81``). With
        ``valid_length`` each sequence's states are those of its last
        valid step and its later outputs are zeros."""
        self.reset()
        if not isinstance(inputs, (list, tuple)):
            batch_size = inputs.shape[layout.find("N")]
        else:
            batch_size = inputs[0].shape[0]
        inputs, axis = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           func=_zeros(inputs[0]))
        states = begin_state
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(outputs, valid_length)
        if merge_outputs:
            outputs = nd.concat(*[nd.expand_dims(o, axis=axis)
                                  for o in outputs], dim=axis)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell):
    """A cell whose step is a ``hybrid_forward``."""


class _GatedCell(HybridRecurrentCell):
    """The parameters of the single-layer cells: ``i2h``/``h2h`` weights
    of ``gates * hidden`` rows and their biases."""

    _num_gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        rows = self._num_gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(rows, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(rows, self._recurrent_size()),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(rows,), init=i2h_bias_initializer,
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(rows,), init=h2h_bias_initializer,
                allow_deferred_init=True)

    def _recurrent_size(self) -> int:
        """The width of the state that ``h2h_weight`` multiplies."""
        return self._hidden_size

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._num_gates * self._hidden_size,
                                 int(x.shape[-1]))

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        rows = self._num_gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=rows),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=rows))


class RNNCell(_GatedCell):
    """Elman cell, ``activation(i2h + h2h)`` (JAX counterpart:
    ``rnn_cell.py:134``)."""

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell; states ``[h, c]`` (JAX counterpart: ``rnn_cell.py:178``).
    """

    _num_gates = 4

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        sg = F.split(i2h + h2h, num_outputs=4, axis=-1)
        in_gate = F.Activation(sg[0], act_type="sigmoid")
        forget_gate = F.Activation(sg[1], act_type="sigmoid")
        in_transform = F.Activation(sg[2], act_type="tanh")
        out_gate = F.Activation(sg[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell (JAX counterpart: ``rnn_cell.py:228``)."""

    _num_gates = 3

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h, h2h = self._projections(F, inputs, prev_h, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h = F.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h = F.split(h2h, num_outputs=3, axis=-1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells applied in order at each step (JAX counterpart:
    ``rnn_cell.py:277``)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._children.values(), **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        next_states, p = [], 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)


#: the hybridizable name of :class:`SequentialRNNCell`, as in the JAX package
HybridSequentialRNNCell = SequentialRNNCell


class DropoutCell(HybridRecurrentCell):
    """Dropout of the input at each step, under ``autograd.is_training()``
    (JAX counterpart: ``rnn_cell.py:309``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        from ... import autograd
        if self._rate > 0 and autograd.is_training():
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes,
                               training=True)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """A cell wrapping ``base_cell``, sharing its parameters (JAX
    counterpart: ``rnn_cell.py:333``)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout: under ``autograd.is_training()`` each output and state
    unit keeps its previous value with probability ``zoneout_*`` (JAX
    counterpart: ``rnn_cell.py:362``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        from ... import autograd
        next_output, next_states = self.base_cell(inputs, states)
        if not autograd.is_training():
            return next_output, next_states
        p_out, p_st = self._zoneout_outputs, self._zoneout_states

        def mask(p, like):
            return F.Dropout(torch.ones_like(like), p=p, training=True)

        prev_output = self._prev_output if self._prev_output is not None \
            else torch.zeros_like(next_output)
        output = (F.where(mask(p_out, next_output), next_output,
                          prev_output) if p_out != 0.0 else next_output)
        new_states = ([F.where(mask(p_st, ns), ns, s)
                       for ns, s in zip(next_states, states)]
                      if p_st != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input (JAX counterpart:
    ``rnn_cell.py:402``)."""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """One cell forward and one backward over the sequence, their outputs
    concatenated; unroll only (JAX counterpart: ``rnn_cell.py:415``)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def forward(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        if not isinstance(inputs, (list, tuple)):
            batch_size = inputs.shape[layout.find("N")]
        else:
            batch_size = inputs[0].shape[0]
        inputs, axis = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size,
                                           func=_zeros(inputs[0]))
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_outputs = list(reversed(r_outputs))
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = nd.concat(*[nd.expand_dims(o, axis=axis)
                                  for o in outputs], dim=axis)
        return outputs, l_states + r_states
