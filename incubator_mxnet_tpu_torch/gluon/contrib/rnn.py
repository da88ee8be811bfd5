"""Experimental recurrent cells (JAX counterpart: ``gluon/contrib/rnn.py``):
``VariationalDropoutCell`` (one dropout mask per unroll for inputs,
states and outputs), ``LSTMPCell`` (an LSTM whose recurrent state is a
projection of its hidden state) and the convolutional cells
``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``, whose gates are convolutions of the
input and of the state (channel-first layouts; stride 1 and odd
recurrent kernels keep the spatial size)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ...base import MXNetError
from ..rnn.rnn_cell import HybridRecurrentCell, ModifierCell, _GatedCell

__all__ = ["VariationalDropoutCell", "LSTMPCell",
           "Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


class VariationalDropoutCell(ModifierCell):
    """Dropout with one mask per unroll for the inputs, the first state
    and the outputs, drawn at the first step after ``reset()`` (JAX
    counterpart: ``gluon/contrib/rnn.py:23``)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self._mask_i = self._mask_s = self._mask_o = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._mask_i = self._mask_s = self._mask_o = None

    @staticmethod
    def _mask(F, like, p):
        return F.Dropout(torch.ones_like(like), p=p, training=True)

    def hybrid_forward(self, F, inputs, states):
        from ... import autograd
        training = autograd.is_training()
        if training and self._drop_inputs:
            if self._mask_i is None:
                self._mask_i = self._mask(F, inputs, self._drop_inputs)
            inputs = inputs * self._mask_i
        if training and self._drop_states:
            if self._mask_s is None:
                self._mask_s = self._mask(F, states[0], self._drop_states)
            states = [states[0] * self._mask_s] + list(states[1:])
        output, states = self.base_cell(inputs, states)
        if training and self._drop_outputs:
            if self._mask_o is None:
                self._mask_o = self._mask(F, output, self._drop_outputs)
            output = output * self._mask_o
        return output, states


class LSTMPCell(_GatedCell):
    """LSTM with a projected recurrent state ``r = W_r h`` of
    ``projection_size``; states ``[r, c]`` (JAX counterpart:
    ``gluon/contrib/rnn.py:70``)."""

    _num_gates = 4

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        self._projection_size = projection_size
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        with self.name_scope():
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _recurrent_size(self) -> int:
        return self._projection_size

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias, h2r_weight):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        sg = F.split(i2h + h2h, num_outputs=4, axis=-1)
        in_gate = F.Activation(sg[0], act_type="sigmoid")
        forget_gate = F.Activation(sg[1], act_type="sigmoid")
        in_transform = F.Activation(sg[2], act_type="tanh")
        out_gate = F.Activation(sg[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]


def _tup(v, n: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    if len(t) != n:
        raise MXNetError(f"expected {n}-d value, got {t}")
    return t


class _ConvRNNCellBase(HybridRecurrentCell):
    """The gates' pre-activations as convolutions of the input (i2h) and
    the state (h2h) (JAX counterpart: ``gluon/contrib/rnn.py:141``)."""

    _num_gates = 1

    def __init__(self, input_shape: Sequence[int], hidden_channels: int,
                 i2h_kernel, h2h_kernel, i2h_pad=None, dims: int = 2,
                 conv_layout: str = None, activation: str = "tanh",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._dims = dims
        expected = ("NCW", "NCHW", "NCDHW")[dims - 1]
        if conv_layout is not None and conv_layout != expected:
            raise MXNetError(f"conv_layout {conv_layout!r} unsupported: "
                             f"only the channel-first {expected} layout")
        self._input_shape = tuple(input_shape)      # (C_in, *spatial)
        if len(self._input_shape) != dims + 1:
            raise MXNetError(
                f"input_shape must be (channels, {dims} spatial dims), got "
                f"{self._input_shape}")
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise MXNetError(f"h2h_kernel must be odd to preserve spatial "
                             f"dims, got {self._h2h_kernel}")
        self._i2h_pad = _tup(i2h_pad, dims) if i2h_pad is not None \
            else tuple(k // 2 for k in self._i2h_kernel)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        rows = self._num_gates * hidden_channels
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(rows, self._input_shape[0])
                + self._i2h_kernel, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(rows, hidden_channels)
                + self._h2h_kernel, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(rows,), init="zeros",
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(rows,), init="zeros",
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._input_shape[1:]
        return [{"shape": shape,
                 "__layout__": "NC" + "DHW"[3 - self._dims:]}]

    def _convs(self, F, inputs, state, i2h_weight, h2h_weight, i2h_bias,
               h2h_bias):
        rows = self._num_gates * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=rows)
        h2h = F.Convolution(state, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=rows)
        return i2h, h2h


class _ConvRNNCell(_ConvRNNCellBase):
    _num_gates = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class _ConvLSTMCell(_ConvRNNCellBase):
    _num_gates = 4

    def _alias(self):
        return "conv_lstm"

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2        # (h, c)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        sg = F.split(i2h + h2h, num_outputs=4, axis=1)
        in_gate = F.Activation(sg[0], act_type="sigmoid")
        forget_gate = F.Activation(sg[1], act_type="sigmoid")
        in_transform = F.Activation(sg[2], act_type=self._activation)
        out_gate = F.Activation(sg[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type=self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_ConvRNNCellBase):
    _num_gates = 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_t = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_t = F.split(h2h, num_outputs=3, axis=1)
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        cand = F.Activation(i2h_t + reset * h2h_t,
                            act_type=self._activation)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]


def _make(base, dims, kind):
    def __init__(self, input_shape, hidden_channels, i2h_kernel=3,
                 h2h_kernel=3, i2h_pad=None, activation="tanh",
                 prefix=None, params=None):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, i2h_pad=i2h_pad, dims=dims,
                      activation=activation, prefix=prefix, params=params)
    cls = type(f"Conv{dims}D{kind}Cell", (base,), {"__init__": __init__,
                                                    "__module__": __name__})
    cls.__doc__ = (f"{dims}-D convolutional {kind} cell; input_shape = "
                   f"(channels, {dims} spatial dims) (JAX counterpart: "
                   f"``gluon/contrib/rnn.py``, Conv{dims}D{kind}Cell).")
    return cls


Conv1DRNNCell = _make(_ConvRNNCell, 1, "RNN")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "RNN")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "RNN")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "LSTM")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "LSTM")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "LSTM")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "GRU")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "GRU")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "GRU")
