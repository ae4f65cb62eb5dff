"""Contrib layers (port of ``mxnet_tpu/gluon/contrib/nn``)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           SparseEmbedding, SyncBatchNorm, PixelShuffle2D)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle2D"]
