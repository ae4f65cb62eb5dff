"""Vision model zoo (port of ``mxnet_tpu/gluon/model_zoo/vision``, the
ResNet family); ``get_model`` names any other reference model as not
ported."""
from .resnet import *  # noqa: F401,F403
from . import resnet
from ....base import MXNetError, not_ported

_models = {name: getattr(resnet, name) for name in resnet.__all__
           if name.startswith("resnet")}
_REFERENCE_ONLY = ("vgg", "alexnet", "densenet", "squeezenet", "inception",
                   "mobilenet")


def get_model(name, **kwargs):
    name = name.lower()
    if name in _models:
        return _models[name](**kwargs)
    if name.startswith(_REFERENCE_ONLY):
        raise not_ported("model %r" % name,
                         "mxnet_tpu.gluon.model_zoo.vision.get_model")
    raise MXNetError("Model %s is not supported. Available: %s"
                     % (name, sorted(_models)))
