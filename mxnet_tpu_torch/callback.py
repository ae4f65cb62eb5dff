"""Training callbacks.

Port of ``BatchEndParam``, ``Speedometer``, ``do_checkpoint`` and
``log_train_metric`` from ``mxnet_tpu/callback.py`` (upstream
``python/mxnet/callback.py``).  ``Speedometer`` logs samples/s every
``frequent`` batches and, given an ``obs.MetricsRegistry``, publishes
it as the ``training_samples_per_sec`` gauge.
"""
from __future__ import annotations

import logging
import time

__all__ = ["BatchEndParam", "Speedometer", "do_checkpoint",
           "log_train_metric"]


class BatchEndParam:
    """Namespace passed to batch-end callbacks (reference: the namedtuple
    of the same fields)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class Speedometer:
    """Logs training speed and (optionally) metrics every ``frequent``
    batches (reference ``callback.Speedometer``)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True,
                 registry=None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.last_speed = None
        self._speed_gauge = None
        if registry is not None:
            self._speed_gauge = registry.gauge(
                "training_samples_per_sec",
                "Speedometer throughput at the last log tick")

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                self.last_speed = speed
                if self._speed_gauge is not None:
                    self._speed_gauge.set(speed)
                if param.eval_metric is not None:
                    nv = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s"
                    logging.info(msg, param.epoch, count, speed,
                                 "\t".join("%s=%f" % kv for kv in nv))
                else:
                    logging.info(
                        "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback that checkpoints the module every ``period``
    epochs (reference ``callback.do_checkpoint``)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param: BatchEndParam):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            nv = param.eval_metric.get_name_value()
            logging.info("Iter[%d] Batch[%d] Train-%s", param.epoch,
                         param.nbatch,
                         "\t".join("%s=%f" % kv for kv in nv))
            if auto_reset:
                param.eval_metric.reset()
    return _callback
