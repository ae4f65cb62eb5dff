"""Image API (port of ``mxnet_tpu/image/``; upstream
``python/mxnet/image/``)."""
from .image import *
from .detection import *
from . import detection
