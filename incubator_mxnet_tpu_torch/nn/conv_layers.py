"""Convolution, pooling and padding layers (JAX counterpart:
``gluon/nn/conv_layers.py``).

NC(DHW) layouts, as in the reference; convolution weights are
``(channels, in_channels / groups, *kernel)``, transposed ones ``(in_channels,
channels / groups, *kernel)``. ``in_channels=0`` defers the weight's shape
to the first forward, as ``Dense`` defers ``in_units``. ``activation=``
adds an :class:`~.activations.Activation` child after the convolution.
``ceil_mode`` pools with MXNet's ``"full"`` convention.
"""
from __future__ import annotations

from ..gluon.block import HybridBlock
from .activations import Activation

__all__ = [
    "Conv1D", "Conv2D", "Conv3D",
    "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
    "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D",
    "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
    "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
    "ReflectionPad2D",
]


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    """Convolution or transposed convolution (JAX counterpart:
    ``gluon/nn/conv_layers.py:34``)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        ndim = len(kernel_size)
        self._kwargs = {
            "kernel": kernel_size,
            "stride": _tup(strides, ndim),
            "dilate": _tup(dilation, ndim),
            "pad": _tup(padding, ndim),
            "num_filter": channels,
            "num_group": groups,
            "layout": layout,
        }
        if adj is not None:
            self._kwargs["adj"] = _tup(adj, ndim)
        self._op_name = op_name
        with self.name_scope():
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups) + tuple(
                    kernel_size)
            else:
                wshape = (in_channels, channels // groups) + tuple(
                    kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation else None

    def infer_shape(self, x, *args):
        in_c = int(x.shape[1])
        k = tuple(self._kwargs["kernel"])
        g = self._kwargs["num_group"]
        if self._op_name == "Convolution":
            self.weight.shape = (self._channels, in_c // g) + k
        else:
            self.weight.shape = (in_c, self._channels // g) + k

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, no_bias=bias is None, **self._kwargs)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        return (f"{type(self).__name__}({self._channels}, "
                f"kernel_size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']})")


def _conv_class(name, ndim, layout, transpose):
    """``Conv{n}D`` / ``Conv{n}DTranspose`` with the reference's
    signature (JAX counterpart: ``gluon/nn/conv_layers.py:92-165``)."""
    one = 1 if ndim == 1 else (1,) * ndim
    zero = 0 if ndim == 1 else (0,) * ndim

    if transpose:
        def __init__(self, channels, kernel_size, strides=one, padding=zero,
                     output_padding=zero, dilation=one, groups=1,
                     layout=layout, activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kwargs):
            _Conv.__init__(self, channels, _tup(kernel_size, ndim), strides,
                           padding, dilation, groups, layout, in_channels,
                           activation, use_bias, weight_initializer,
                           bias_initializer, op_name="Deconvolution",
                           adj=output_padding, **kwargs)
        doc = f"Transposed {ndim}-D convolution over {layout} data."
    else:
        def __init__(self, channels, kernel_size, strides=one, padding=zero,
                     dilation=one, groups=1, layout=layout, activation=None,
                     use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, **kwargs):
            _Conv.__init__(self, channels, _tup(kernel_size, ndim), strides,
                           padding, dilation, groups, layout, in_channels,
                           activation, use_bias, weight_initializer,
                           bias_initializer, **kwargs)
        doc = f"{ndim}-D convolution over {layout} data."
    return type(name, (_Conv,), {"__init__": __init__, "__doc__": doc,
                                 "__module__": __name__})


Conv1D = _conv_class("Conv1D", 1, "NCW", False)
Conv2D = _conv_class("Conv2D", 2, "NCHW", False)
Conv3D = _conv_class("Conv3D", 3, "NCDHW", False)
Conv1DTranspose = _conv_class("Conv1DTranspose", 1, "NCW", True)
Conv2DTranspose = _conv_class("Conv2DTranspose", 2, "NCHW", True)
Conv3DTranspose = _conv_class("Conv3DTranspose", 3, "NCDHW", True)


class _Pooling(HybridBlock):
    """Pooling by ``F.Pooling`` (JAX counterpart:
    ``gluon/nn/conv_layers.py:168``); ``strides`` defaults to the pool
    size."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        ndim = len(pool_size)
        self._kwargs = {
            "kernel": pool_size,
            "stride": _tup(strides, ndim),
            "pad": _tup(padding, ndim),
            "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']})")


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _pool_class(name, ndim, pool_type):
    """``MaxPool{n}D`` / ``AvgPool{n}D`` (JAX counterpart:
    ``gluon/nn/conv_layers.py:194-246``)."""
    size = 2 if ndim == 1 else (2,) * ndim
    layout = _LAYOUTS[ndim]
    if pool_type == "max":
        def __init__(self, pool_size=size, strides=None, padding=0,
                     layout=layout, ceil_mode=False, **kwargs):
            _Pooling.__init__(self, _tup(pool_size, ndim), strides, padding,
                              ceil_mode, False, "max", layout, **kwargs)
    else:
        def __init__(self, pool_size=size, strides=None, padding=0,
                     layout=layout, ceil_mode=False, count_include_pad=True,
                     **kwargs):
            _Pooling.__init__(self, _tup(pool_size, ndim), strides, padding,
                              ceil_mode, False, "avg", layout,
                              count_include_pad, **kwargs)
    doc = f"{'Max' if pool_type == 'max' else 'Average'} pooling over " \
          f"{layout} data."
    return type(name, (_Pooling,), {"__init__": __init__, "__doc__": doc,
                                    "__module__": __name__})


def _global_pool_class(name, ndim, pool_type):
    """``Global{Max,Avg}Pool{n}D``: one value per channel (JAX
    counterpart: ``gluon/nn/conv_layers.py:248-288``)."""
    layout = _LAYOUTS[ndim]

    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * ndim, None, 0, True, True, pool_type,
                          layout, **kwargs)
    doc = f"Global {pool_type} pooling over {layout} data."
    return type(name, (_Pooling,), {"__init__": __init__, "__doc__": doc,
                                    "__module__": __name__})


MaxPool1D = _pool_class("MaxPool1D", 1, "max")
MaxPool2D = _pool_class("MaxPool2D", 2, "max")
MaxPool3D = _pool_class("MaxPool3D", 3, "max")
AvgPool1D = _pool_class("AvgPool1D", 1, "avg")
AvgPool2D = _pool_class("AvgPool2D", 2, "avg")
AvgPool3D = _pool_class("AvgPool3D", 3, "avg")
GlobalMaxPool1D = _global_pool_class("GlobalMaxPool1D", 1, "max")
GlobalMaxPool2D = _global_pool_class("GlobalMaxPool2D", 2, "max")
GlobalMaxPool3D = _global_pool_class("GlobalMaxPool3D", 3, "max")
GlobalAvgPool1D = _global_pool_class("GlobalAvgPool1D", 1, "avg")
GlobalAvgPool2D = _global_pool_class("GlobalAvgPool2D", 2, "avg")
GlobalAvgPool3D = _global_pool_class("GlobalAvgPool3D", 3, "avg")


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the spatial axes of NCHW data; an int pads
    all four sides (JAX counterpart: ``gluon/nn/conv_layers.py:290``)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
