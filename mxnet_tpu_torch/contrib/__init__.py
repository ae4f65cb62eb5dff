"""``mx.contrib``: automatic mixed precision (``contrib.amp``) and
post-training INT8 quantization (``contrib.quantization``).

Port of ``mxnet_tpu/contrib/__init__.py``; ONNX is not ported.
"""
from . import amp  # noqa: F401
from . import quantization  # noqa: F401
