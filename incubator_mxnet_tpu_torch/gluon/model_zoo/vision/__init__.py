"""Vision model zoo of the port (JAX counterpart:
``gluon/model_zoo/vision/__init__.py``).

Ported so far: ResNet v1 and v2 at 18, 34, 50, 101 and 152 layers, with
the reference's parameter names, so ``convert.params_from_jax`` and
``.params`` files line up name for name. The other families of the JAX
zoo (AlexNet, VGG, SqueezeNet, DenseNet, Inception, MobileNet) are not
ported yet: :func:`get_model` refuses their names with the list of what
is. All models are NCHW ``HybridBlock``\\ s; pretrained weights are not
downloaded (load a ``.params`` file instead).
"""
from __future__ import annotations

from .resnet import (  # noqa: F401
    BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2, ResNetV1,
    ResNetV2, get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
    resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
    resnet101_v2, resnet152_v2,
)

_MODELS = {name: globals()[name] for name in (
    "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
    "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
    "resnet101_v2", "resnet152_v2")}


def get_model(name: str, **kwargs):
    """The zoo's model ``name`` built with ``kwargs`` (JAX counterpart:
    ``gluon/model_zoo/vision/__init__.py:55``)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(f"Model {name!r} is not in the port's zoo yet. "
                         f"Available: {sorted(_MODELS)}")
    return _MODELS[name](**kwargs)
