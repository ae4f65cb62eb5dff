"""``mx.contrib.amp``: automatic mixed precision (bf16 first).

Port of ``mxnet_tpu/contrib/amp/__init__.py``.
"""
from .amp import (init, is_initialized, disable, init_trainer,  # noqa: F401
                  scale_loss, convert_symbol, convert_model)
from .loss_scaler import LossScaler  # noqa: F401
from . import lists  # noqa: F401
