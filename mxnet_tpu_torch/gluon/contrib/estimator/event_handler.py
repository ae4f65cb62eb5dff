"""Event handlers for the Estimator fit loop.

Port of ``mxnet_tpu/gluon/contrib/estimator/event_handler.py``: the six
event mixins and the built-in handlers (stopping, metrics, validation,
logging, checkpoints with resume, early stopping, and the optimizer step
itself as a handler).  Handlers run on the host between steps; the
metrics read their arrays back there.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler", "GradientUpdateHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after ``max_epoch`` epochs or ``max_batch`` batches
    (reference: ``StoppingHandler``)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch is not None and \
                self.current_batch >= self.max_batch:
            self.stop_training = True
        return self.stop_training

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch is not None and \
                self.current_epoch >= self.max_epoch:
            self.stop_training = True
        return self.stop_training


class MetricHandler(EpochBegin, BatchEnd):
    """Reset train metrics per epoch; update them per batch
    (reference: ``MetricHandler``)."""

    def __init__(self, metrics, priority=-1000):
        self.metrics = metrics
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs["pred"]
        label = kwargs["label"]
        loss = kwargs["loss"]
        for metric in self.metrics:
            if "loss" in metric.name.lower():
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every ``epoch_period`` epochs / ``batch_period``
    batches (reference: ``ValidationHandler``)."""

    def __init__(self, val_data, eval_fn, epoch_period=1,
                 batch_period=None, priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.priority = priority
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and \
                self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Log throughput + metric values (reference: ``LoggingHandler``;
    the per-batch samples/sec line is the reference's ``Speedometer``)."""

    def __init__(self, log_interval="epoch", metrics=None, priority=np.inf):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.priority = priority
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        self.logger = logging.getLogger(__name__)

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        t = time.time() - self.train_start
        msgs = ["Train finished in %.3fs: " % t]
        msgs += ["%s: %.4f" % m.get() for m in self.metrics]
        self.logger.info(" ".join(msgs))

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0
        self.processed_samples = 0

    def epoch_end(self, estimator, *args, **kwargs):
        t = time.time() - self.epoch_start
        msgs = ["[Epoch %d] finished in %.3fs: " % (self.current_epoch, t)]
        msgs += ["%s: %.4f" % m.get() for m in self.metrics]
        self.logger.info(" ".join(msgs))
        self.current_epoch += 1

    def batch_end(self, estimator, *args, **kwargs):
        batch = kwargs.get("batch")
        if batch is not None:
            data = batch[0] if isinstance(batch, (list, tuple)) else batch
            try:
                self.processed_samples += data.shape[0]
            except Exception:
                pass
        self.batch_index += 1
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            t = time.time() - self.epoch_start
            speed = self.processed_samples / max(t, 1e-9)
            msgs = ["[Epoch %d][Batch %d] speed: %.2f samples/sec "
                    % (self.current_epoch, self.batch_index, speed)]
            msgs += ["%s: %.4f" % m.get() for m in self.metrics]
            self.logger.info(" ".join(msgs))


class GradientUpdateHandler(BatchEnd):
    """Apply the optimizer step (reference: ``GradientUpdateHandler`` —
    keeping the update as a handler lets users reorder it, e.g. after
    gradient accumulation)."""

    def __init__(self, priority=-2000):
        self.priority = priority

    def batch_end(self, estimator, *args, **kwargs):
        loss = kwargs["loss"]
        batch_size = 0
        if not isinstance(loss, (list, tuple)):
            loss = [loss]
        for l in loss:
            batch_size += l.shape[0]
        estimator.trainer.step(batch_size)


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save params (+ trainer states) periodically and track the best
    model by a monitored metric (reference: ``CheckpointHandler``)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.verbose = verbose
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.current_epoch = 0
        self.current_batch = 0
        self.saved_checkpoints = []
        self.logger = logging.getLogger(__name__)
        if save_best and monitor is None:
            raise ValueError("save_best requires a monitor metric")
        if mode == "auto":
            mode = "max" if (monitor is not None and
                             "acc" in monitor.name.lower()) else "min"
        self.mode = mode
        self.best = -np.inf if mode == "max" else np.inf

    def _find_latest(self):
        """Newest ``<prefix>-epochN.params`` in ``model_dir``, or None."""
        import re
        best_n, best_path = -1, None
        if not os.path.isdir(self.model_dir):
            return None, -1
        pat = re.compile(re.escape(self.model_prefix) +
                         r"-epoch(\d+)\.params$")
        for f in os.listdir(self.model_dir):
            m = pat.match(f)
            if m and int(m.group(1)) > best_n:
                best_n = int(m.group(1))
                best_path = os.path.join(self.model_dir, f)
        return best_path, best_n

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        if self.resume_from_checkpoint:
            path, epoch = self._find_latest()
            if path is not None:
                estimator.net.load_parameters(path, ctx=estimator.context)
                states = path.replace(".params", ".states")
                if estimator.trainer is not None and \
                        os.path.exists(states):
                    estimator.trainer.load_states(states)
                self.current_epoch = epoch + 1
                if self.verbose:
                    self.logger.info("Resumed from %s (epoch %d)",
                                     path, epoch)
            elif self.verbose:
                self.logger.info("resume_from_checkpoint: nothing to "
                                 "resume in %s", self.model_dir)

    def _save(self, estimator, tag):
        path = os.path.join(self.model_dir,
                            "%s-%s.params" % (self.model_prefix, tag))
        estimator.net.save_parameters(path)
        if estimator.trainer is not None:
            estimator.trainer.save_states(
                path.replace(".params", ".states"))
        self.saved_checkpoints.append(path)
        while len(self.saved_checkpoints) > self.max_checkpoints:
            old = self.saved_checkpoints.pop(0)
            for f in (old, old.replace(".params", ".states")):
                if os.path.exists(f):
                    os.remove(f)
        return path

    def _maybe_save_best(self, estimator):
        if not self.save_best:
            return
        _, value = self.monitor.get()
        improved = value > self.best if self.mode == "max" \
            else value < self.best
        if improved:
            self.best = value
            path = os.path.join(self.model_dir,
                                "%s-best.params" % self.model_prefix)
            estimator.net.save_parameters(path)

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and \
                self.current_batch % self.batch_period == 0:
            self._save(estimator, "batch%d" % self.current_batch)

    def epoch_end(self, estimator, *args, **kwargs):
        if self.epoch_period and \
                (self.current_epoch + 1) % self.epoch_period == 0:
            self._save(estimator, "epoch%d" % self.current_epoch)
            self._maybe_save_best(estimator)
        self.current_epoch += 1


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric stops improving (reference:
    ``EarlyStoppingHandler``)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        self.logger = logging.getLogger(__name__)
        if mode == "auto":
            mode = "max" if "acc" in monitor.name.lower() else "min"
        self.mode = mode

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        self.best = self.baseline if self.baseline is not None else (
            -np.inf if self.mode == "max" else np.inf)

    def _improved(self, value):
        if self.mode == "max":
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def epoch_end(self, estimator, *args, **kwargs):
        _, value = self.monitor.get()
        if isinstance(value, str):
            return self.stop_training
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                self.stop_training = True
        self.current_epoch += 1
        return self.stop_training

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch:
            self.logger.info("Early stop at epoch %d: %s = %s",
                             self.stopped_epoch, self.monitor.name,
                             self.best)
