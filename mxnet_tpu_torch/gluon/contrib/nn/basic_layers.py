"""Contrib layers.

Port of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``: ``Concurrent``
and ``HybridConcurrent`` (children on one input, outputs concatenated
on ``axis``, ``-1`` by default; the model zoo's own
``HybridConcurrent`` in ``squeezenet.py`` keeps ``axis=1``),
``Identity``, ``SparseEmbedding`` (an ``Embedding`` with a
``row_sparse`` gradient), ``SyncBatchNorm`` (on one card,
``BatchNorm`` over axis 1) and ``PixelShuffle2D``.
"""
from __future__ import annotations

from .... import ndarray as nd
from ....base import MXNetError
from ...block import Block, HybridBlock
from ...nn.basic_layers import BatchNorm, Embedding, HybridSequential, \
    Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle2D"]


class Concurrent(Sequential):
    """Children run on the same input; their outputs are concatenated
    on ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable :class:`Concurrent`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Passes its input through (a skip branch of
    :class:`HybridConcurrent`)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """An embedding whose weight gradient is ``row_sparse``: the Trainer
    updates only the rows a batch's gradient reaches."""

    def __init__(self, input_dim, output_dim, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        self._inner = Embedding(input_dim, output_dim, dtype=dtype,
                                sparse_grad=True)
        self.register_child(self._inner)

    def forward(self, x):
        return self._inner(x)

    def __repr__(self):
        return repr(self._inner).replace("Embedding", "SparseEmbedding", 1)


class SyncBatchNorm(BatchNorm):
    """Cross-device synchronized BatchNorm.  With one device the batch
    statistics are the device's own, so it is ``BatchNorm`` over axis 1;
    ``num_devices`` is kept for the reference's signature."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         in_channels=in_channels, **kwargs)
        self.num_devices = num_devices


class PixelShuffle2D(HybridBlock):
    """``(N, C*f1*f2, H, W)`` to ``(N, C, H*f1, W*f2)``."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        try:
            self._factors = (int(factor),) * 2
        except TypeError:
            self._factors = tuple(int(f) for f in factor)
            if len(self._factors) != 2:
                raise MXNetError("factor must be int or pair")

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        n, c, h, w = x.shape
        if c % (f1 * f2):
            raise MXNetError("channels %d not divisible by %d" %
                             (c, f1 * f2))
        co = c // (f1 * f2)
        out = F.reshape(x, (n, co, f1, f2, h, w))
        out = F.transpose(out, (0, 1, 4, 2, 5, 3))
        return F.reshape(out, (n, co, h * f1, w * f2))

    def __repr__(self):
        return "PixelShuffle2D(%s)" % (self._factors,)
