"""Dynamic loss scaling.

Port of ``mxnet_tpu/contrib/amp/loss_scaler.py``.  bfloat16 has
float32's exponent range, so scaling is a no-op there; the dynamic
scaler is for float16.
"""
from __future__ import annotations

import torch


class LossScaler:
    def __init__(self, init_scale=2. ** 16, scale_factor=2.,
                 scale_window=2000, tolerance=0.):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0

    def has_overflow(self, params) -> bool:
        """True if any gradient of ``params`` holds an inf or a NaN (the
        reference's ``multi_all_finite`` over the gradients): one
        reduction on the device, one value read back."""
        grads = [g._data for p in params
                 if getattr(p, "grad_req", "write") != "null"
                 and p._grad is not None for g in p._grad.values()]
        if not grads:
            return False
        finite = torch.stack([torch.isfinite(g).all() for g in grads])
        return not bool(finite.all())

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped == self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
