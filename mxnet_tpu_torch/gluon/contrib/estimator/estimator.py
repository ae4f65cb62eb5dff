"""The Estimator fit loop.

Port of ``mxnet_tpu/gluon/contrib/estimator/estimator.py``: the Gluon
training step (forward and loss under ``autograd.record``, backward)
with every extension point (metrics, validation, logging,
checkpointing, early stopping, the optimizer step) an event handler.
A batch moves to the estimator's context once, here, with
``as_in_context``: a ``DataLoader`` hands out host batches (pinned with
``pin_memory=True``).
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

from .... import metric as metric_mod
from ....base import MXNetError
from ... import loss as gluon_loss
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            GradientUpdateHandler, LoggingHandler,
                            MetricHandler, StoppingHandler, TrainBegin,
                            TrainEnd, ValidationHandler)

__all__ = ["Estimator"]


def _batch_data_label(batch, ctx):
    """Split a DataLoader tuple / DataBatch into (data, label) on ctx
    (one host-to-device copy each when they are elsewhere)."""
    if hasattr(batch, "data"):  # io.DataBatch
        data, label = batch.data[0], batch.label[0]
    else:
        data, label = batch[0], batch[1]
    if ctx is not None:
        data = data.as_in_context(ctx)
        label = label.as_in_context(ctx)
    return data, label


class Estimator:
    """High-level train/validate loop over a Gluon block
    (reference: ``estimator.Estimator``).

    Parameters mirror the reference: ``net``, ``loss`` (a gluon Loss),
    ``train_metrics``/``val_metrics`` (EvalMetric or list), ``trainer``
    (default: SGD lr=0.001), ``context`` (default: current context).
    """

    logger = None

    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 initializer=None, trainer=None, context=None,
                 val_loss=None, val_net=None):
        from .... import context as _ctx_mod
        self.net = net
        self.val_net = val_net if val_net is not None else net
        if not isinstance(loss, gluon_loss.Loss):
            raise MXNetError("loss must be a gluon.loss.Loss")
        self.loss = loss
        self.val_loss = val_loss if val_loss is not None else loss
        self.context = context if context is not None \
            else _ctx_mod.current_context()
        self.logger = logging.getLogger("Estimator")

        def _as_list(m):
            if m is None:
                return []
            return list(m) if isinstance(m, (list, tuple)) else [m]

        self.train_metrics = _as_list(train_metrics)
        self.val_metrics = _as_list(val_metrics)
        if not self.train_metrics:
            self.train_metrics = [metric_mod.Accuracy()]
        if not self.val_metrics:
            import copy
            self.val_metrics = [copy.deepcopy(m)
                                for m in self.train_metrics]
            for m in self.val_metrics:
                m.reset()
        self.train_loss_metric = metric_mod.Loss(
            "train " + (loss.name if hasattr(loss, "name") else "loss"))
        self.val_loss_metric = metric_mod.Loss("validation loss")

        if initializer is not None:
            self.net.initialize(initializer, ctx=self.context)
        if trainer is None:
            trainer = Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.001})
        if not isinstance(trainer, Trainer):
            raise MXNetError("trainer must be a gluon.Trainer")
        self.trainer = trainer

    # -- evaluation -------------------------------------------------------

    def evaluate_batch(self, batch, batch_axis=0):
        data, label = _batch_data_label(batch, self.context)
        pred = self.val_net(data)
        loss = self.val_loss(pred, label)
        return data, label, pred, loss

    def evaluate(self, val_data, batch_axis=0, event_handlers=None):
        """Run validation, updating ``val_metrics`` +
        ``val_loss_metric``.  ``event_handlers`` get
        ``batch_begin``/``batch_end`` per validation batch (reference
        semantics)."""
        handlers = list(event_handlers or [])
        batch_begin = [h for h in handlers if isinstance(h, BatchBegin)]
        batch_end = [h for h in handlers if isinstance(h, BatchEnd)]
        for m in self.val_metrics:
            m.reset()
        self.val_loss_metric.reset()
        for batch in val_data:
            for h in batch_begin:
                h.batch_begin(self, batch=batch)
            _, label, pred, loss = self.evaluate_batch(batch, batch_axis)
            for m in self.val_metrics:
                m.update(label, pred)
            self.val_loss_metric.update(0, loss)
            for h in batch_end:
                h.batch_end(self, batch=batch, pred=pred, label=label,
                            loss=loss)
        if hasattr(val_data, "reset"):
            val_data.reset()

    # -- training ---------------------------------------------------------

    def fit_batch(self, batch, batch_axis=0):
        from .... import autograd
        data, label = _batch_data_label(batch, self.context)
        with autograd.record():
            pred = self.net(data)
            loss = self.loss(pred, label)
        loss.backward()
        return data, label, pred, loss

    def fit(self, train_data, val_data=None, epochs=None,
            event_handlers: Optional[Sequence] = None, batches=None,
            batch_axis=0):
        """Train until ``epochs`` epochs or ``batches`` batches
        (reference semantics: exactly one of them, default 1 epoch)."""
        if epochs is None and batches is None:
            epochs = 1
        if (epochs is not None and epochs <= 0) or \
                (batches is not None and batches <= 0):
            return
        self.max_epoch = epochs
        self.max_batch = batches

        handlers = self._prepare_handlers(val_data, event_handlers)
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = self._categorize(handlers)

        for h in train_begin:
            h.train_begin(self)

        stop = False
        while not stop:
            for h in epoch_begin:
                h.epoch_begin(self)
            n_batches = 0
            for batch in train_data:
                n_batches += 1
                for h in batch_begin:
                    h.batch_begin(self, batch=batch)
                _, label, pred, loss = self.fit_batch(batch, batch_axis)
                for h in batch_end:
                    if h.batch_end(self, batch=batch, pred=pred,
                                   label=label, loss=loss):
                        stop = True
                if stop:
                    break
            if hasattr(train_data, "reset"):
                train_data.reset()
            if not stop:
                for h in epoch_end:
                    if h.epoch_end(self):
                        stop = True
            if n_batches == 0 and not stop:
                # empty/exhausted loader (e.g. a one-shot generator): no
                # handler can ever fire again — bail instead of spinning.
                self.logger.warning(
                    "fit: train_data yielded no batches this epoch and no "
                    "stop condition fired; stopping to avoid an infinite "
                    "loop (is train_data a one-shot generator?)")
                stop = True

        for h in train_end:
            h.train_end(self)

    # -- handler plumbing -------------------------------------------------

    def _prepare_handlers(self, val_data, event_handlers):
        handlers: List = list(event_handlers or [])
        added_default = []

        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(self.max_epoch,
                                            self.max_batch))
        if not any(isinstance(h, GradientUpdateHandler) for h in handlers):
            handlers.append(GradientUpdateHandler())
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(
                self.train_metrics + [self.train_loss_metric]))
            added_default.append("MetricHandler")
        if val_data is not None and \
                not any(isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
            added_default.append("ValidationHandler")
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(
                metrics=self.train_metrics + [self.train_loss_metric]))
            added_default.append("LoggingHandler")
        if added_default:
            self.logger.info("Added default handlers: %s",
                             ", ".join(added_default))

        # stable order: more negative priority runs first within an event
        handlers.sort(key=lambda h: getattr(h, "priority", 0))
        return handlers

    @staticmethod
    def _categorize(handlers):
        return ([h for h in handlers if isinstance(h, TrainBegin)],
                [h for h in handlers if isinstance(h, EpochBegin)],
                [h for h in handlers if isinstance(h, BatchBegin)],
                [h for h in handlers if isinstance(h, BatchEnd)],
                [h for h in handlers if isinstance(h, EpochEnd)],
                [h for h in handlers if isinstance(h, TrainEnd)])
