"""Optimizers (port of ``mxnet_tpu/optimizer``)."""
from .optimizer import (Optimizer, SGD, Updater, get_updater, create,
                        register)
