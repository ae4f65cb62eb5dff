"""DataLoader with multiprocess workers.

Port of ``mxnet_tpu/gluon/data/dataloader.py``.  Samples are read and
batched on the host: with ``num_workers > 0`` a forked pool gets the
dataset once (its initializer) and sends back numpy batches, which the
consumer wraps as CPU NDArrays (page-locked with ``pin_memory=True``).
Batches move to the card once, on the consumer side (the Estimator's
``as_in_context``), so a worker never touches CUDA: a forked child of a
process that has initialized CUDA cannot use it.  Each worker runs
torch's CPU ops on one thread, as torch's own loader does.
"""
from __future__ import annotations

import multiprocessing

import numpy as _np
import torch

from ...base import MXNetError
from ... import ndarray as nd
from ...context import cpu, cpu_pinned
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch on the host: NDArrays where the
    samples lie, everything else as CPU NDArrays."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data)
    if isinstance(data[0], _np.ndarray):
        return nd.array(_np.stack(data), ctx=cpu())
    if isinstance(data[0], (tuple, list)):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    return nd.array(_np.asarray(data), ctx=cpu())


def default_mp_batchify_fn(data):
    """Worker-side batchify: numpy (cheap to send), wrapped by the
    consumer."""
    if isinstance(data[0], NDArray):
        return _np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], _np.ndarray):
        return _np.stack(data)
    if isinstance(data[0], (tuple, list)):
        data = zip(*data)
        return [default_mp_batchify_fn(i) for i in data]
    return _np.asarray(data)


def _as_nd(data, pin=False):
    """A batch as host NDArrays, page-locked when ``pin``."""
    if isinstance(data, _np.ndarray):
        return nd.array(data, ctx=cpu_pinned() if pin else cpu())
    if isinstance(data, NDArray):
        return data.copyto(cpu_pinned()) if pin and \
            not data._data.is_pinned() else data
    if isinstance(data, (list, tuple)):
        return [_as_nd(d, pin) for d in data]
    return data


_worker_dataset = None


def _worker_initializer(dataset):
    global _worker_dataset
    _worker_dataset = dataset
    torch.set_num_threads(1)


def _worker_fn(samples, batchify_fn, dataset=None):
    ds = dataset if dataset is not None else _worker_dataset
    return batchify_fn([ds[i] for i in samples])


class DataLoader:
    """Mini-batches of a Dataset.

    ``num_workers > 0`` forks a pool that gets the dataset once and
    keeps ``prefetch`` batches (default ``2 * num_workers``) in flight;
    a batch not back within ``timeout`` seconds raises.  ``thread_pool``
    uses threads instead.  ``pin_memory`` hands out page-locked host
    batches, whose copy to the card is faster."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 pin_device_id=0, prefetch=None, thread_pool=False,
                 timeout=120):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._timeout = timeout

        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError(
                    "shuffle must not be specified if sampler is "
                    "specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise MXNetError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")

        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch)
                             if prefetch is not None
                             else 2 * self._num_workers)
        if batchify_fn is None:
            if self._num_workers > 0:
                self._batchify_fn = default_mp_batchify_fn
            else:
                self._batchify_fn = default_batchify_fn
        else:
            self._batchify_fn = batchify_fn
        self._thread_pool = thread_pool
        self._pool = None
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.pool import ThreadPool
                self._pool = ThreadPool(self._num_workers)
            else:
                ctx = multiprocessing.get_context("fork")
                self._pool = ctx.Pool(
                    self._num_workers,
                    initializer=_worker_initializer,
                    initargs=(self._dataset,))

    def close(self):
        """Stop the workers."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:   # interpreter teardown: the pool may be gone
            pass

    def __iter__(self):
        if self._pool is None:
            def same_process_iter():
                for batch in self._batch_sampler:
                    samples = [self._dataset[i] for i in batch]
                    fn = default_batchify_fn \
                        if self._batchify_fn is default_mp_batchify_fn \
                        else self._batchify_fn
                    yield _as_nd(fn(samples), self._pin_memory)
            return same_process_iter()
        return _MultiWorkerIter(self._pool, self._batchify_fn,
                                self._batch_sampler,
                                prefetch=self._prefetch,
                                dataset=None if not self._thread_pool
                                else self._dataset,
                                timeout=self._timeout,
                                pin=self._pin_memory)

    def __len__(self):
        return len(self._batch_sampler)


class _MultiWorkerIter:
    def __init__(self, pool, batchify_fn, batch_sampler, prefetch=4,
                 dataset=None, timeout=120, pin=False):
        self._pool = pool
        self._batchify_fn = batchify_fn
        self._batch_sampler = batch_sampler
        self._data_buffer = {}
        self._rcvd_idx = 0
        self._sent_idx = 0
        self._iter = iter(self._batch_sampler)
        self._dataset = dataset
        self._timeout = timeout
        self._pin = pin
        for _ in range(max(1, prefetch)):
            self._push_next()

    def _push_next(self):
        r = next(self._iter, None)
        if r is None:
            return
        async_ret = self._pool.apply_async(
            _worker_fn, (r, self._batchify_fn, self._dataset))
        self._data_buffer[self._sent_idx] = async_ret
        self._sent_idx += 1

    def __next__(self):
        self._push_next()
        if self._rcvd_idx == self._sent_idx:
            assert not self._data_buffer, \
                "Data buffer should be empty at this moment"
            raise StopIteration
        ret = self._data_buffer.pop(self._rcvd_idx)
        batch = ret.get(self._timeout)
        self._rcvd_idx += 1
        return _as_nd(batch, self._pin)

    def next(self):
        return self.__next__()

    def __iter__(self):
        return self
