"""Gluon data (port of ``mxnet_tpu/gluon/data``): datasets, samplers,
the DataLoader and the vision datasets and transforms."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,  # noqa: F401
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,  # noqa: F401
                      BatchSampler, FilterSampler, IntervalSampler)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
