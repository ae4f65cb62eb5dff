"""The operator library (port of ``mxnet_tpu/ops``): importing this
package registers every ported op."""
from . import registry  # noqa: F401
from .registry import get_op, list_ops, invoke, register, OpDef  # noqa: F401
from . import elemwise, creation_ops, reduce, shape_ops, nn  # noqa: F401
from . import random_ops, linalg, optimizer_ops, contrib_misc  # noqa: F401
from . import rnn_op, vision, vision_ext  # noqa: F401
from . import quantization  # noqa: F401
from .. import operator  # noqa: F401,E402  (the reference binds it here too)
