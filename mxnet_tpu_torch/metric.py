"""Evaluation metrics.

Port of ``mxnet_tpu/metric.py`` (upstream ``python/mxnet/metric.py``),
kept as the reference's host numpy code, line for line, so that every
metric gives the reference's value exactly: an update copies the
outputs to the host (``asnumpy``, which waits for the card) and
computes there.
"""
from __future__ import annotations

import math
import numpy as _np

from .base import Registry, MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE",
           "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "BLEU", "PearsonCorrelation", "Loss",
           "CompositeEvalMetric", "CustomMetric", "create", "np"]

_REG = Registry("metric")
register = _REG.register


def _as_numpy(x):
    from .ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if isinstance(labels, (list, tuple)) and isinstance(preds, (list, tuple)):
        if len(labels) != len(preds):
            raise MXNetError("labels and predictions have different lengths")
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


class EvalMetric:
    """Base metric (reference: ``mxnet.metric.EvalMetric``)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _add(self, metric, inst):
        self.sum_metric += metric
        self.num_inst += inst
        self.global_sum_metric += metric
        self.global_num_inst += inst

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


@register("acc", aliases=["accuracy"])
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").reshape(-1)
            label = label.astype("int32").reshape(-1)
            n = min(len(label), len(pred))
            self._add(float((pred[:n] == label[:n]).sum()), n)


@register("top_k_accuracy", aliases=["top_k_acc"])
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Use Accuracy if top_k is 1"
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32")
            assert pred.ndim == 2, "Predictions should be 2 dims"
            idx = _np.argsort(pred, axis=1)[:, -self.top_k:]
            n = pred.shape[0]
            correct = (idx == label.reshape(-1, 1)).any(axis=1).sum()
            self._add(float(correct), n)


class _BinaryClassificationHelper:
    def __init__(self):
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        pred = _as_numpy(pred)
        label = _as_numpy(label).astype("int32").reshape(-1)
        if pred.ndim > 1 and pred.shape[-1] > 1:
            pred_label = pred.argmax(axis=-1).reshape(-1)
        else:
            pred_label = (pred.reshape(-1) > 0.5).astype("int32")
        if label.max() > 1:
            raise MXNetError("F1/MCC currently only supports binary "
                             "classification.")
        self.tp += int(((pred_label == 1) & (label == 1)).sum())
        self.fp += int(((pred_label == 1) & (label == 0)).sum())
        self.tn += int(((pred_label == 0) & (label == 0)).sum())
        self.fn += int(((pred_label == 0) & (label == 1)).sum())

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def fscore(self):
        d = self.precision + self.recall
        return 2 * self.precision * self.recall / d if d else 0.0

    @property
    def matthewscc(self):
        terms = [(self.tp + self.fp), (self.tp + self.fn),
                 (self.tn + self.fp), (self.tn + self.fn)]
        denom = 1.0
        for t in terms:
            denom *= t if t else 1.0
        return ((self.tp * self.tn) - (self.fp * self.fn)) / \
            math.sqrt(denom)

    @property
    def total_examples(self):
        return self.tp + self.fp + self.tn + self.fn


@register("f1")
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self._helper = _BinaryClassificationHelper()

    def reset(self):
        super().reset()
        if hasattr(self, "_helper"):
            self._helper.reset_stats()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self._helper.update(label, pred)
        if self.average == "micro":
            self.sum_metric = self._helper.fscore * \
                self._helper.total_examples
            self.num_inst = self._helper.total_examples
        else:
            self.sum_metric = self._helper.fscore
            self.num_inst = 1
        self.global_sum_metric = self.sum_metric
        self.global_num_inst = self.num_inst


@register("mcc")
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._helper = _BinaryClassificationHelper()

    def reset(self):
        super().reset()
        if hasattr(self, "_helper"):
            self._helper.reset_stats()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self._helper.update(label, pred)
        self.sum_metric = self._helper.matthewscc
        self.num_inst = 1
        self.global_sum_metric = self.sum_metric
        self.global_num_inst = 1


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._add(float(_np.abs(label - pred).mean()), 1)


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._add(float(((label - pred) ** 2.0).mean()), 1)


@register("rmse")
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self._add(float(_np.sqrt(((label - pred) ** 2.0).mean())), 1)


@register("ce", aliases=["cross-entropy"])
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype("int64")
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), label]
            self._add(float((-_np.log(prob + self.eps)).sum()),
                      label.shape[0])


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super(CrossEntropy, self).__init__(name, output_names, label_names)
        self.eps = eps


@register("perplexity")
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype("int64")
            pred = _as_numpy(pred)
            label = label.reshape(-1)
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                prob = _np.where(ignore, 1.0, prob)
                num -= int(ignore.sum())
            loss -= float(_np.log(_np.maximum(1e-10, prob)).sum())
            num += label.shape[0]
        self._add(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register("bleu")
class BLEU(EvalMetric):
    """Corpus-level BLEU over token-id sequences (reference:
    Sockeye/GluonNLP evaluation — BASELINE.md "BLEU/F1 parity" row;
    Papineni et al. 2002: modified n-gram precision, geometric mean,
    brevity penalty).

    ``update(labels, preds)``: ``labels`` = reference sequences
    (batch, len) of token ids; ``preds`` = hypothesis token ids
    (batch, len), or per-token scores (batch, len, vocab) which are
    argmax-decoded first.  ``pad_token`` (and anything after
    ``eos_token`` when given) is stripped before matching.

    Counts accumulate corpus-wide (NOT per-sentence averages), so
    ``get()`` is true corpus BLEU; ``smooth`` adds +1 smoothing to the
    higher-order precisions (Lin & Och 2004) for short corpora."""

    def __init__(self, max_n=4, pad_token=None, eos_token=None,
                 smooth=False, name="bleu", output_names=None,
                 label_names=None):
        self.max_n = int(max_n)
        self.pad_token = pad_token
        self.eos_token = eos_token
        self.smooth = smooth
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._match = [0] * getattr(self, "max_n", 4)
        self._total = [0] * getattr(self, "max_n", 4)
        self._hyp_len = 0
        self._ref_len = 0

    def _clean(self, seq):
        toks = [int(t) for t in seq]
        if self.eos_token is not None and self.eos_token in toks:
            toks = toks[:toks.index(self.eos_token)]
        if self.pad_token is not None:
            toks = [t for t in toks if t != self.pad_token]
        return toks

    def update(self, labels, preds):
        from collections import Counter
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim == label.ndim + 1:
                pred = pred.argmax(axis=-1)
            label = label.reshape(-1, label.shape[-1])
            pred = pred.reshape(-1, pred.shape[-1])
            for ref_row, hyp_row in zip(label, pred):
                ref = self._clean(ref_row)
                hyp = self._clean(hyp_row)
                self._hyp_len += len(hyp)
                self._ref_len += len(ref)
                for n in range(1, self.max_n + 1):
                    hg = Counter(tuple(hyp[i:i + n])
                                 for i in range(len(hyp) - n + 1))
                    rg = Counter(tuple(ref[i:i + n])
                                 for i in range(len(ref) - n + 1))
                    self._match[n - 1] += sum(
                        min(c, rg[g]) for g, c in hg.items())
                    self._total[n - 1] += max(len(hyp) - n + 1, 0)
                self.num_inst += 1

    def get(self):
        if self.num_inst == 0 or self._hyp_len == 0:
            return (self.name, float("nan"))
        logp = 0.0
        for n in range(self.max_n):
            m, t = self._match[n], self._total[n]
            if self.smooth and n > 0:
                m, t = m + 1, t + 1
            if m == 0 or t == 0:
                return (self.name, 0.0)
            logp += math.log(m / t)
        logp /= self.max_n
        bp = 0.0 if self._hyp_len >= self._ref_len else \
            1.0 - self._ref_len / self._hyp_len
        return (self.name, float(math.exp(bp + logp)))


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            self._add(float(_np.corrcoef(pred, label)[0, 1]), 1)


@register("loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            loss = float(_as_numpy(pred).sum())
            self._add(loss, _as_numpy(pred).size)


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) if isinstance(i, str) else i
                        for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 output_names=None, label_names=None):
        super().__init__("custom(%s)" % name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, wrap=True)
        else:
            labels, preds = check_label_shapes(labels, preds, wrap=True)
        for pred, label in zip(preds, labels):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self._add(sum_metric, num_inst)
            else:
                self._add(reval, 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a CustomMetric (reference: ``metric.np``)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name or numpy_feval.__name__,
                        allow_extra_outputs)


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _REG.create(metric, *args, **kwargs)


@register("torch")
class Torch(Loss):
    """Legacy alias of :class:`Loss` kept for reference parity
    (``metric.Torch`` — mean of raw outputs)."""

    def __init__(self, name="torch", **kwargs):
        super().__init__(name=name, **kwargs)


@register("caffe")
class Caffe(Torch):
    """Legacy alias of :class:`Loss` (``metric.Caffe``)."""

    def __init__(self, name="caffe", **kwargs):
        super().__init__(name=name, **kwargs)
