"""Profiler: chrome-trace op and event recording and aggregate
statistics.  Port of ``mxnet_tpu/profiler.py`` (reference
``src/profiler/profiler.cc`` and ``python/mxnet/profiler.py``): the
engine wraps every operator in start/stop events, ``dump`` writes
``chrome://tracing`` JSON and ``dumps`` the aggregate per-op table;
user scopes (Task/Frame/Event/Marker/Counter); configuration through
``set_config`` / ``set_state``, with the reference's key names.

The imperative layer hooks the engine's choke point
(``engine.Engine.add_op_hook``), as the reference does.  Device time
comes from a ``torch.profiler`` session with CUDA activity, started
beside the op hook when ``xla_profile=True`` (the reference starts
``jax.profiler`` there); it writes its chrome trace under
``xla_trace_dir`` when the profiler stops.  With ``profile_memory=True``
the dump gains counter tracks of live NDArray bytes and of each CUDA
device's allocator (``torch.cuda.memory_stats()``, where the reference
reads PjRt's ``memory_stats()``), and ``dumps`` a memory table.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from .base import MXNetError
from .engine import Engine

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "memory_stats", "Task", "Frame", "Event", "Counter",
           "Marker", "now_us", "is_recording", "record_events",
           "events_generation"]

_lock = threading.Lock()
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": False,
    "xla_profile": False,
    "xla_trace_dir": os.path.join(tempfile.gettempdir(),
                                  "mxnet_torch_trace"),
}
_events: List[dict] = []
_agg: Dict[str, List[float]] = defaultdict(list)
_state = {"running": False, "paused": False, "hook": None,
          "xla_running": False, "generation": 0, "torch_prof": None}
_starts = threading.local()


def _now_us() -> float:
    return time.perf_counter() * 1e6


def now_us() -> float:
    """The shared trace clock: ``time.perf_counter()`` in microseconds.
    Every event in a dump — op events, memory counters, user scopes,
    and the serving layer's request-lifecycle spans (``obs/trace.py``)
    — carries a ``ts`` on THIS clock, so they interleave correctly in
    one chrome://tracing view."""
    return _now_us()


def is_recording() -> bool:
    """True while collection is active (set_state('run'), not paused) —
    external emitters (the obs layer) gate their trace writes on this
    exactly like the op hook does."""
    return _state["running"] and not _state["paused"]


def record_events(events) -> bool:
    """Append pre-formed chrome-trace event dicts (``ts``/``dur`` on the
    ``now_us()`` clock) into the profiler's event stream.  Returns False
    without touching the stream when not recording; the obs layer
    batches a whole engine step's spans into one call so the lock is
    taken once per step, not per event."""
    if not is_recording():
        return False
    with _lock:
        _events.extend(events)
    return True


def _op_hook(event: str, name: str):
    if _state["paused"] or not _state["running"]:
        return
    if event == "start":
        if not hasattr(_starts, "stack"):
            _starts.stack = []
        _starts.stack.append((name, _now_us()))
    elif event == "stop":
        stack = getattr(_starts, "stack", None)
        if not stack:
            return
        n, t0 = stack.pop()
        dur = _now_us() - t0
        with _lock:
            _events.append({
                "name": n, "ph": "X", "ts": t0, "dur": dur,
                "pid": os.getpid(), "tid": threading.get_ident(),
                "cat": "operator",
            })
            if _config["aggregate_stats"]:
                _agg[n].append(dur)
            if _MEM["enabled"]:
                # peak-by-op attribution: the live-bytes high-water
                # mark observed at each op's completion (reference:
                # storage_profiler.h entries keyed by the operator
                # whose execution allocated them)
                _mem_drain_locked()
                rec = _agg_mem.get(n)
                if rec is None:
                    _agg_mem[n] = [1, _MEM["live"]]
                else:
                    rec[0] += 1
                    if _MEM["live"] > rec[1]:
                        rec[1] = _MEM["live"]
        if _MEM["enabled"] and _MEM["device"]:
            _mem_sample_device()


# ---------------------------------------------------------------------------
# Memory profiling (reference ``src/profiler/storage_profiler.h``): (a)
# NDArray buffers, every tensor an NDArray takes, hooked through
# weakref finalizers; (b) each CUDA device's allocator counters,
# ``torch.cuda.memory_stats()``, where the reference reads PjRt's
# ``memory_stats()``.  dump() gains counter tracks, dumps() a memory
# table.
# ---------------------------------------------------------------------------

_MEM = {"enabled": False, "live": 0, "peak": 0, "n_alloc": 0,
        "device": False, "last_dev_sample": 0.0, "session": 0}
_agg_mem: Dict[str, List[int]] = {}   # op name -> [calls, peak live bytes]
_mem_live_bufs: Dict[int, int] = {}   # id(buffer) -> nbytes
# freed-buffer keys land here from weakref finalizers and are drained
# under _lock later: a finalizer can fire from GC INSIDE a section that
# already holds the (non-reentrant) _lock, so it must never take it —
# deque.append is atomic under the GIL
_mem_freed = None  # collections.deque, created lazily
_DEV_SAMPLE_US = 50_000.0  # throttle device sampling to 20 Hz


def _mem_free(key: int, session: int):
    dq = _mem_freed
    if dq is not None:
        dq.append((key, session))


def _mem_drain_locked():
    """Apply deferred finalizer frees.  Caller holds _lock."""
    dq = _mem_freed
    if not dq:
        return
    while True:
        try:
            key, session = dq.popleft()
        except IndexError:
            break
        if session != _MEM["session"]:
            continue                  # buffer from a previous session
        _MEM["live"] -= _mem_live_bufs.pop(key, 0)


def _mem_note(buf):
    """Account one NDArray tensor (called from the NDArray layer when
    memory profiling is active)."""
    key = id(buf)
    nbytes = buf.numel() * buf.element_size()
    import weakref
    with _lock:
        _mem_drain_locked()
        if key in _mem_live_bufs:
            return
        try:
            weakref.finalize(buf, _mem_free, key, _MEM["session"])
        except TypeError:
            return  # buffer type without weakref support
        _mem_live_bufs[key] = nbytes
        _MEM["live"] += nbytes
        _MEM["n_alloc"] += 1
        if _MEM["live"] > _MEM["peak"]:
            _MEM["peak"] = _MEM["live"]
        if _state["running"] and not _state["paused"]:
            _events.append({
                "name": "ndarray_live_bytes", "ph": "C",
                "ts": _now_us(), "pid": os.getpid(),
                "args": {"bytes": _MEM["live"]},
            })


def _device_stats():
    """{"gpu:<i>": (bytes_in_use, peak_bytes_in_use)} of every CUDA
    device, from its caching allocator's counters."""
    out = {}
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        out["gpu:%d" % i] = (st.get("allocated_bytes.all.current", 0),
                             st.get("allocated_bytes.all.peak", 0))
    return out


def _mem_sample_device():
    """Emit per-device bytes_in_use counters (throttled to 20 Hz)."""
    now = _now_us()
    if now - _MEM["last_dev_sample"] < _DEV_SAMPLE_US:
        return
    _MEM["last_dev_sample"] = now
    for name, (used, peak) in _device_stats().items():
        with _lock:
            _events.append({
                "name": "%s bytes_in_use" % name,
                "ph": "C", "ts": now, "pid": os.getpid(),
                "args": {"bytes": used, "peak": peak},
            })


def _mem_start():
    import collections
    global _mem_freed
    _MEM["device"] = torch.cuda.is_available()
    with _lock:
        # re-baseline: a second profiling session must not inherit the
        # previous run's peak/live or see frees of its buffers
        _MEM["session"] += 1
        _MEM["live"] = 0
        _MEM["peak"] = 0
        _MEM["n_alloc"] = 0
        _mem_live_bufs.clear()
        _agg_mem.clear()
        _mem_freed = collections.deque()
    _MEM["enabled"] = True
    from .ndarray import ndarray as _ndmod
    _ndmod._MEM_HOOK = _mem_note


def _mem_stop():
    _MEM["enabled"] = False
    from .ndarray import ndarray as _ndmod
    _ndmod._MEM_HOOK = None


def memory_stats() -> dict:
    """Current framework-level memory accounting: NDArray live/peak
    bytes, allocation count and, on CUDA, each device's allocator
    bytes in use and peak."""
    with _lock:
        _mem_drain_locked()
        out = {"ndarray_live_bytes": _MEM["live"],
               "ndarray_peak_bytes": _MEM["peak"],
               "ndarray_allocs": _MEM["n_alloc"], "devices": {}}
    if _MEM["device"]:
        for name, (used, peak) in _device_stats().items():
            out["devices"][name] = {"bytes_in_use": used,
                                    "peak_bytes_in_use": peak}
    return out


def set_config(**kwargs):
    """Configure the profiler (reference: MXSetProcessProfilerConfig)."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise MXNetError("profiler.set_config: unknown keys %s" % unknown)
    _config.update(kwargs)
    if _config["profile_all"]:
        _config["profile_imperative"] = True
        _config["profile_symbolic"] = True


def _start_device_trace():
    """The counterpart of the reference's ``jax.profiler.start_trace``:
    a ``torch.profiler`` session recording the CPU and, where there is
    one, the CUDA device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_device_trace(prof):
    """Stop the session and write its chrome trace under
    ``xla_trace_dir`` (one ``trace_<pid>_<n>.json`` a session)."""
    prof.stop()
    d = _config["xla_trace_dir"]
    os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        d, "trace_%d_%d.json" % (os.getpid(), _state["generation"])))


def set_state(state_name: str = "stop"):
    """'run' starts collection, 'stop' ends it (reference parity).  Env
    ``MXNET_PROFILER_AUTOSTART=1`` arms it at import (see bottom)."""
    if state_name == "run":
        if not _state["running"]:
            hook = _op_hook
            Engine.get().add_op_hook(hook)
            _state["hook"] = hook
            _state["running"] = True
            if _config["profile_memory"]:
                _mem_start()
            if _config["xla_profile"] and not _state["xla_running"]:
                _state["torch_prof"] = _start_device_trace()
                _state["xla_running"] = True
    elif state_name == "stop":
        if _state["running"]:
            Engine.get().remove_op_hook(_state["hook"])
            _state["running"] = False
            if _MEM["enabled"]:
                _mem_stop()
            if _state["xla_running"]:
                _stop_device_trace(_state["torch_prof"])
                _state["torch_prof"] = None
                _state["xla_running"] = False
    else:
        raise MXNetError("set_state expects 'run' or 'stop'")


def state() -> str:
    return "run" if _state["running"] else "stop"


def pause():
    _state["paused"] = True


def resume():
    _state["paused"] = False


def dump(finished: bool = True, filename: Optional[str] = None):
    """Write chrome-trace JSON (load in chrome://tracing / Perfetto)."""
    fname = filename or _config["filename"]
    with _lock:
        trace = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
    with open(fname, "w") as f:
        json.dump(trace, f)
    if finished:
        with _lock:
            _events.clear()
            # a new trace begins: emitters holding per-trace state
            # (the obs layer's swimlane thread_name metadata) key off
            # this to re-emit into the next dump
            _state["generation"] += 1
    return fname


def events_generation() -> int:
    """Bumped every time a dump() clears the event stream — one value
    per trace file.  External emitters re-send per-trace metadata
    (ph "M" events) when it changes."""
    return _state["generation"]


def dumps(reset: bool = False) -> str:
    """Aggregate per-op stats table (reference: aggregate_stats.cc)."""
    lines = ["Profile Statistics:",
             "%-40s %8s %12s %12s %12s %12s" % (
                 "Name", "Calls", "Total(us)", "Min(us)", "Max(us)",
                 "Avg(us)")]
    with _lock:
        for name in sorted(_agg, key=lambda n: -sum(_agg[n])):
            ds = _agg[name]
            lines.append("%-40s %8d %12.1f %12.1f %12.1f %12.1f" % (
                name, len(ds), sum(ds), min(ds), max(ds),
                sum(ds) / len(ds)))
        if reset:
            _agg.clear()
    if _config["profile_memory"] and (_MEM["n_alloc"] or _agg_mem):
        # memory_stats() drains deferred finalizer frees under _lock
        # FIRST, so every row below reports the same post-drain state
        ms = memory_stats()
        lines.append("")
        lines.append("Memory Statistics:")
        lines.append("%-40s %16s" % ("Counter", "Bytes"))
        lines.append("%-40s %16d" % ("ndarray_live",
                                     ms["ndarray_live_bytes"]))
        lines.append("%-40s %16d" % ("ndarray_peak",
                                     ms["ndarray_peak_bytes"]))
        lines.append("%-40s %16d" % ("ndarray_allocs",
                                     ms["ndarray_allocs"]))
        for dev, st in sorted(ms.get("devices", {}).items()):
            lines.append("%-40s %16d" % (
                dev + " bytes_in_use", st["bytes_in_use"]))
            lines.append("%-40s %16d" % (
                dev + " peak_bytes_in_use", st["peak_bytes_in_use"]))
        lines.append("")
        lines.append("Peak live bytes by operator:")
        lines.append("%-40s %8s %16s" % ("Name", "Calls", "Peak(bytes)"))
        with _lock:
            for name in sorted(_agg_mem, key=lambda n: -_agg_mem[n][1]):
                calls, peak = _agg_mem[name]
                lines.append("%-40s %8d %16d" % (name, calls, peak))
            if reset:
                _agg_mem.clear()
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Custom user scopes (reference: profiler.Task/Frame/Event/Counter)
# ---------------------------------------------------------------------------

class _Scope:
    _cat = "user"

    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = _now_us()
        return self

    def stop(self):
        if self._t0 is None:
            return
        with _lock:
            _events.append({
                "name": self.name, "ph": "X", "ts": self._t0,
                "dur": _now_us() - self._t0, "pid": os.getpid(),
                "tid": threading.get_ident(), "cat": self._cat,
            })
        self._t0 = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class Task(_Scope):
    _cat = "task"


class Frame(_Scope):
    _cat = "frame"


class Event(_Scope):
    _cat = "event"


class Marker:
    """Instant event (reference: profiler.Marker)."""

    def __init__(self, name: str):
        self.name = name

    def mark(self, scope="process"):
        with _lock:
            _events.append({
                "name": self.name, "ph": "i", "ts": _now_us(),
                "pid": os.getpid(), "tid": threading.get_ident(),
                "s": "p" if scope == "process" else "t",
            })


class Counter:
    """Named counter series (reference: profiler.Counter)."""

    def __init__(self, name: str, value: float = 0):
        self.name = name
        self._value = value
        self._emit()

    def _emit(self):
        with _lock:
            _events.append({
                "name": self.name, "ph": "C", "ts": _now_us(),
                "pid": os.getpid(),
                "args": {self.name: self._value},
            })

    def set_value(self, value: float):
        self._value = value
        self._emit()

    def increment(self, delta: float = 1):
        self.set_value(self._value + delta)

    def decrement(self, delta: float = 1):
        self.set_value(self._value - delta)


if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    set_config(profile_all=True)
    set_state("run")
