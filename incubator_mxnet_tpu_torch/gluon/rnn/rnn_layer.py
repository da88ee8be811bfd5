"""The fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``.

Counterpart: the JAX package's ``gluon/rnn/rnn_layer.py`` (``:19-173``).
Parameters are registered per layer and direction under the JAX names
(``l0_i2h_weight``, ``r0_h2h_bias`` ...), so ``convert.params_from_jax``
and ``.params`` files carry them across, and passed as they are, per layer
and direction, to the ``RNN`` op (:func:`..ops.nn.rnn`, a loop over time
in plain torch), which the JAX layer feeds one flat vector. ``layout`` is ``"TNC"`` or ``"NTC"``. Called
without states, the layer starts from zeros made on the input's device
and returns the output alone; with states, ``(output, states)``.
Under ``hybridize()`` the layer's forward and backward replay CUDA graphs
on the card (:mod:`..block`): the time loop reads nothing back to the
host. ``dropout`` is passed to the op as ``p``, which, as in the JAX
package, does not apply it.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """The shared layer (JAX counterpart: ``rnn_layer.py:19``)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        self._mode = mode
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][:self._dir]:
                    self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                         i2h_weight_initializer)
                    self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                         h2h_weight_initializer)
                    self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                         i2h_bias_initializer)
                    self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                         h2h_bias_initializer)
                ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def _alias(self):
        return self._mode

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}] \
            * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: ``func(shape=..., **kwargs)`` of each
        (default ``mx.nd.zeros``, on ``ctx=``)."""
        if func is None:
            from ... import ndarray as nd
            func = nd.zeros
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def infer_shape(self, inputs, *args):
        ni = int(inputs.shape[-1])
        nh, ng = self._hidden_size, self._gates
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, f"{j}{i}_i2h_weight").shape = (ng * nh, ni)
            ni = nh * self._dir

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        skip_states = states is None
        if skip_states:
            # zeros on the input's device: nothing made on the host, so a
            # captured graph holds them
            states = [inputs.new_zeros(info["shape"]) for info in
                      self.state_info(inputs.shape[1])]
        if not isinstance(states, (list, tuple)):
            states = [states]
        weights = [tuple(params[f"{j}{i}_{name}"] for name in (
            "i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"))
            for i in range(self._num_layers) for j in ["l", "r"][:self._dir]]
        outs = F.RNN(inputs, weights, *states, state_size=self._hidden_size,
                     num_layers=self._num_layers, mode=self._mode,
                     bidirectional=self._dir == 2, p=self._dropout,
                     state_outputs=True)
        outputs, states = outs[0], list(outs[1:])
        if self._layout == "NTC":
            outputs = outputs.transpose(0, 1)
        if skip_states:
            return outputs
        return outputs, states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN, ``relu`` or ``tanh`` (JAX counterpart:
    ``rnn_layer.py:116``)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM; states ``[h, c]`` (JAX counterpart:
    ``rnn_layer.py:135``)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (JAX counterpart: ``rnn_layer.py:155``)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
