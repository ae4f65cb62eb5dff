"""The operator library (port of ``mxnet_tpu/ops``): importing this
package registers every ported op."""
from . import registry  # noqa: F401
from . import elemwise, reduce, shape_ops, nn, optimizer_ops  # noqa: F401
