"""``gluon.contrib``: the Estimator fit loop and the contrib layers
(port of ``mxnet_tpu/gluon/contrib``)."""
from . import estimator  # noqa: F401
from . import nn  # noqa: F401
