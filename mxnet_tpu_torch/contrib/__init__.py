"""``mx.contrib``: automatic mixed precision (``contrib.amp``).

Port of ``mxnet_tpu/contrib/__init__.py``; quantization and ONNX are not
ported.
"""
from . import amp  # noqa: F401
