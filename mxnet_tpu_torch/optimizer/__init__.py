"""Optimizers (port of ``mxnet_tpu/optimizer``)."""
from .optimizer import (Optimizer, SGD, Adam, AdaGrad, RMSProp, FTRL, NAG,
                        Signum, LAMB, LARS, AdaDelta, Adamax, Nadam, Test,
                        Updater, get_updater, create, register, state_zeros)
