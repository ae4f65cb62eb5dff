"""Structured observability for the serving engine.  Port of
``mxnet_tpu/obs`` (pure Python; the port keeps its own copy of each
module and imports nothing of the reference).

* ``metrics``: lock-cheap Counter / Gauge / fixed-bucket Histogram
  instruments in a ``MetricsRegistry`` (no per-sample retained
  allocation on the hot path).
* ``trace``: request-lifecycle chrome-trace spans on the clock and pid
  convention of ``profiler.py``'s op events, so one dump interleaves
  operator timing with per-request admission, prefill, decode,
  preempt and retire swimlanes.
* ``prometheus``: text exposition of the default registry, every live
  ``ServingEngine`` registry and the native runtime's counters.
* ``flight``: the crash-durable flight recorder, an mmap ring of the
  last events of a process, readable after the process died.

Serving metrics are off by default: ``ServingEngine(..., metrics=True)``
or ``MXNET_SERVING_METRICS=1`` turns them on.  The disabled path is one
``is None`` branch per call site: no dormant instruments, no
allocation.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_MS_BUCKETS, sanitize_name)
from .prometheus import (default_registry, engine_registries,
                         prometheus_text, register_engine_registry)
from .trace import (RequestTraceEmitter, REQ_TID_BASE, SpanBuffer,
                    MergedTraceEmitter, LANE_PID_BASE)
from .flight import (FlightRecorder, flight_path, read_flight,
                     flight_recover, flight_sweep)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_MS_BUCKETS", "sanitize_name",
    "default_registry", "engine_registries", "prometheus_text",
    "register_engine_registry",
    "RequestTraceEmitter", "REQ_TID_BASE",
    "SpanBuffer", "MergedTraceEmitter", "LANE_PID_BASE",
    "FlightRecorder", "flight_path", "read_flight",
    "flight_recover", "flight_sweep",
]
