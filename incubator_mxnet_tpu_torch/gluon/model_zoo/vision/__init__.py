"""Vision model zoo of the port (JAX counterpart:
``gluon/model_zoo/vision/__init__.py``).

Every family of the JAX zoo, under its names: ResNet v1 and v2 (18, 34,
50, 101, 152), AlexNet, VGG 11/13/16/19 with and without BatchNorm,
SqueezeNet 1.0/1.1, DenseNet 121/161/169/201, Inception v3 and MobileNet
v1/v2 at the multipliers 1.0, 0.75, 0.5 and 0.25 (``mobilenet0.25``,
``mobilenetv2_1.0`` ...). Parameter names are the reference's, so
``convert.params_from_jax`` and ``.params`` files line up name for name.
All models are NCHW ``HybridBlock``\\ s; pretrained weights are not
downloaded (load a ``.params`` file instead).
"""
from __future__ import annotations

from .resnet import (  # noqa: F401
    BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2, ResNetV1,
    ResNetV2, get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
    resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
    resnet101_v2, resnet152_v2, resnet_sharding_rules,
)
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import (  # noqa: F401
    VGG, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
)
from .inception import Inception3, inception_v3  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNet, MobileNetV2, mobilenet1_0, mobilenet0_75, mobilenet0_5,
    mobilenet0_25, mobilenet_v2_1_0, mobilenet_v2_0_75, mobilenet_v2_0_5,
    mobilenet_v2_0_25,
)

#: the reference's names (JAX ``__init__.py:34-52``)
NAMES = ("resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
         "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
         "resnet101_v2", "resnet152_v2", "alexnet", "vgg11", "vgg13",
         "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn",
         "squeezenet1.0", "squeezenet1.1", "densenet121", "densenet161",
         "densenet169", "densenet201", "inceptionv3", "mobilenet1.0",
         "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
         "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
         "mobilenetv2_0.25")


def _attr(name: str) -> str:
    attr = name.replace(".", "_").replace("mobilenetv2", "mobilenet_v2")
    return attr.replace("inceptionv3", "inception_v3")


_MODELS = {name: globals()[_attr(name)] for name in NAMES}


def get_model(name: str, **kwargs):
    """The zoo's model ``name`` built with ``kwargs`` (JAX counterpart:
    ``gluon/model_zoo/vision/__init__.py:55``)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(f"Model {name!r} is not in the zoo. Available: "
                         f"{sorted(_MODELS)}")
    return _MODELS[name](**kwargs)
