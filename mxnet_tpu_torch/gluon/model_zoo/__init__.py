"""Gluon model zoo (port of ``mxnet_tpu/gluon/model_zoo``)."""
from . import vision  # noqa: F401
