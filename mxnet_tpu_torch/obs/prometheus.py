"""Prometheus text exposition over every metrics surface in the
process.  Port of ``mxnet_tpu/obs/prometheus.py``.

``prometheus_text()`` renders, in one scrape body, the process
**default registry**, every live **engine registry** (each
``ServingEngine(metrics=True)`` registers its own, weakly: a collected
engine drops out of the scrape) and, where the native runtime library
(``native.py``) loads, its counters under the reference's names: the
dependency engine's, the image decoder's and the host storage pool's.

The format is Prometheus text v0.0.4: HELP/TYPE headers, cumulative
``_bucket{le=...}`` rows with a ``+Inf`` tail, and ``_sum``/``_count``
for histograms.
"""
from __future__ import annotations

import threading
import weakref
from typing import Iterable, Optional

from .metrics import MetricsRegistry

__all__ = ["default_registry", "register_engine_registry",
           "engine_registries", "prometheus_text"]

_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()
# live engine registries (weak: an engine going away unscrapes itself)
_engine_regs: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()


def default_registry() -> MetricsRegistry:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricsRegistry()
    return _default


def register_engine_registry(reg: MetricsRegistry):
    _engine_regs.add(reg)


def engine_registries():
    return list(_engine_regs)


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join('%s="%s"' % (k, str(v).replace('"', '\\"'))
                    for k, v in sorted(items.items()))
    return "{%s}" % body


def _render_families(regs, lines: list):
    """Group series by metric family ACROSS registries first, then
    render each family as one contiguous block (HELP/TYPE header +
    every labeled series): the text format requires all lines of a
    family to form a single group — two engines exposing
    ``serving_steps_total{engine="0"|"1"}`` must share one header, not
    repeat the family."""
    families: dict = {}
    order = []
    for reg in regs:
        for inst in reg.instruments():
            fam = families.get(inst.name)
            if fam is None:
                families[inst.name] = fam = {
                    "kind": inst.kind, "help": inst.help, "series": []}
                order.append(inst.name)
            elif fam["kind"] != inst.kind:
                lines.append(
                    "# skipped %s from a registry: kind %s conflicts "
                    "with %s" % (inst.name, inst.kind, fam["kind"]))
                continue
            fam["series"].append((reg.labels, inst))
    for name in order:
        fam = families[name]
        if fam["help"]:
            lines.append("# HELP %s %s" % (name, fam["help"]))
        lines.append("# TYPE %s %s" % (name, fam["kind"]))
        for labels, inst in fam["series"]:
            if fam["kind"] in ("counter", "gauge"):
                lines.append("%s%s %s" % (name, _fmt_labels(labels),
                                          _fmt_value(inst.value)))
            else:                               # histogram
                cum = 0
                for bound, c in zip(inst.bounds, inst.counts):
                    cum += c
                    lines.append("%s_bucket%s %d" % (
                        name,
                        _fmt_labels(labels,
                                    {"le": _fmt_value(bound)}),
                        cum))
                lines.append("%s_bucket%s %d" % (
                    name, _fmt_labels(labels, {"le": "+Inf"}),
                    inst.count))
                lines.append("%s_sum%s %s" % (name,
                                              _fmt_labels(labels),
                                              _fmt_value(inst.sum)))
                lines.append("%s_count%s %d" % (name,
                                                _fmt_labels(labels),
                                                inst.count))


def _native_lines(lines: list):
    """Fold the native runtime's counters in (an absent library, or one
    that cannot answer, contributes nothing)."""
    try:
        from .. import native
        if not native.available():
            return
    except Exception:
        return
    try:
        es = native.engine_stats()
        for key, kind in (("ops_dispatched", "counter"),
                          ("ops_executed", "counter"),
                          ("worker_wakeups", "counter")):
            name = "mxnet_native_engine_%s_total" % key
            lines.append("# TYPE %s %s" % (name, kind))
            lines.append("%s %d" % (name, es[key]))
        for key in ("queue_depth", "outstanding", "workers"):
            name = "mxnet_native_engine_%s" % key
            lines.append("# TYPE %s gauge" % name)
            lines.append("%s %d" % (name, es[key]))
    except Exception:
        pass
    try:
        ds = native.decode_profile_stats()
        for key in ("jpeg", "png", "dct_scaled", "errors"):
            name = "mxnet_native_decode_%s_total" % key
            lines.append("# TYPE %s counter" % name)
            lines.append("%s %d" % (name, ds[key]))
    except Exception:
        pass
    try:
        ss = native.storage_stats()
        for key in ("allocated", "pooled"):
            name = "mxnet_native_host_pool_%s_bytes" % key
            lines.append("# TYPE %s gauge" % name)
            lines.append("%s %d" % (name, ss[key]))
    except Exception:
        pass


def prometheus_text(registries: Optional[Iterable[MetricsRegistry]]
                    = None, include_native: bool = True) -> str:
    """Render the scrape body.  ``registries=None`` → default registry
    + every live engine registry; pass an explicit iterable to scope
    the scrape (tests).  ``include_native=False`` drops the native
    collectors."""
    if registries is None:
        regs = [default_registry()] + engine_registries()
    else:
        regs = list(registries)
    lines: list = []
    _render_families(regs, lines)
    if include_native:
        _native_lines(lines)
    return "\n".join(lines) + "\n"
