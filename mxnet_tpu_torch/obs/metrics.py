"""Lock-cheap metric instruments: Counter, Gauge and fixed-bucket
Histogram behind a ``MetricsRegistry``.  Port of
``mxnet_tpu/obs/metrics.py`` (pure Python; the port keeps its own copy).

* **No per-sample retained allocation on the hot path.**
  ``Histogram.observe`` bumps one slot of a preallocated ``array('q')``
  and two running scalars; nothing grows with traffic.
* **Lock-cheap.**  Instrument updates are single read-modify-writes on
  ints and array slots; the registry takes its lock only on instrument
  creation and on ``snapshot()``.
* **Histogram percentiles** are estimated as Prometheus does:
  cumulative bucket counts with linear interpolation inside the target
  bucket, clamped to the last finite edge for the overflow bucket.

The serving engine keeps one registry per engine, labelled
``{engine="<n>"}``; ``obs.prometheus_text()`` renders the default
registry and every live engine registry on one surface.
"""
from __future__ import annotations

import re
import threading
from array import array
from bisect import bisect_left
from typing import Dict, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_MS_BUCKETS", "sanitize_name"]

# Log-ish spaced latency buckets in milliseconds: sub-ms token intervals
# on chip through multi-second admission waits under overload.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
    500.0, 1000.0, 2000.0, 5000.0, 10000.0, 30000.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Coerce an arbitrary label (layer names, op names) into the
    Prometheus metric-name alphabet ``[a-zA-Z0-9_:]``."""
    out = _NAME_RE.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


class Counter:
    """Monotonic counter."""
    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    """Set-to-current-value instrument."""
    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v):
        self.value = v

    def inc(self, n=1):
        self.value += n

    def dec(self, n=1):
        self.value -= n


class Histogram:
    """Fixed-bucket histogram with Prometheus bucket semantics.

    ``bounds`` are the finite upper edges (ascending); an implicit
    +Inf overflow bucket follows.  ``counts[i]`` is the number of
    observations with ``value <= bounds[i]`` falling in bucket i
    (non-cumulative internally; rendered cumulatively for Prometheus).
    """
    __slots__ = ("name", "help", "bounds", "counts", "count", "sum")
    kind = "histogram"

    def __init__(self, name: str, bounds=DEFAULT_MS_BUCKETS,
                 help: str = ""):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError("Histogram: bounds must be ascending and "
                             "non-empty, got %r" % (bounds,))
        self.name = name
        self.help = help
        self.bounds = bounds
        # preallocated int64 slots: len(bounds) finite buckets + overflow
        self.counts = array("q", [0] * (len(bounds) + 1))
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float):
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0..100) by linear interpolation
        inside the containing bucket; overflow clamps to the last
        finite edge (Prometheus ``histogram_quantile`` convention).
        Returns 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i >= len(self.bounds):       # overflow bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * (target - cum) / c
            cum += c
        return self.bounds[-1]

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Named instrument registry with get-or-create semantics.

    ``labels`` (e.g. ``{"engine": "0"}``) are attached to every
    instrument of this registry at Prometheus render time, so multiple
    registries (one per serving engine) can share one exposition
    without aliasing.
    """

    def __init__(self, labels: Optional[Dict[str, str]] = None):
        self.labels = dict(labels or {})
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, *args, **kwargs):
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise TypeError(
                    "metric %r already registered as %s, requested %s"
                    % (name, type(inst).__name__, cls.__name__))
            return inst
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    "metric %r already registered as %s, requested %s"
                    % (name, type(inst).__name__, cls.__name__))
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, bounds=DEFAULT_MS_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, bounds, help)

    def instruments(self):
        with self._lock:
            return list(self._instruments.values())

    def snapshot(self) -> dict:
        """JSON-able state: counters/gauges by value, histograms by
        count/sum/p50/p95/p99."""
        out = {"labels": dict(self.labels), "counters": {},
               "gauges": {}, "histograms": {}}
        for inst in self.instruments():
            if inst.kind == "counter":
                out["counters"][inst.name] = inst.value
            elif inst.kind == "gauge":
                out["gauges"][inst.name] = inst.value
            else:
                out["histograms"][inst.name] = inst.summary()
        return out

    def reset(self):
        """Drop all instruments (tests / re-baselining)."""
        with self._lock:
            self._instruments.clear()

    def reset_values(self):
        """Zero every instrument IN PLACE — bound handles (e.g. the
        serving engine's) stay valid.  Used to drop warmup samples
        (compile time would otherwise own the TTFT tail)."""
        for inst in self.instruments():
            if inst.kind == "histogram":
                for i in range(len(inst.counts)):
                    inst.counts[i] = 0
                inst.count = 0
                inst.sum = 0.0
            else:
                inst.value = 0
