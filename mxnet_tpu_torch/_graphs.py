"""CUDA-graph capture shared by the port's compiled steps.

The reference compiles three hot paths into one program each with
``jax.jit``: the serving step (``mxnet_tpu/serving/engine.py:487``), the
transformer train step (``models/transformer.py:896``) and a hybridized
block (``gluon/block.py`` ``_CachedOp``).  On the card the port captures
each as a CUDA graph, keyed and reused as the reference keys its jitted
program, and replays it.  This module holds what the three share:

* :class:`Program` — one body over static buffers.  On a CUDA device it
  is captured once and every call replays it; on the CPU nothing is
  captured and every call runs the body eagerly, so the static-buffer
  and signature code around it runs in the CPU tests too.  A capture
  that fails raises; nothing falls back to an eager run.
* :func:`warm_up` — the eager runs torch needs before a capture (cuBLAS
  workspaces, each kernel's one-time ``cudaFuncSetAttribute``, an
  optimizer's lazy state), on a side stream.  The caller restores what
  they touch (:func:`kept_launches` for the counters, a snapshot for the
  rest), so a warm-up leaves no trace and replay 1 is step 1: capture
  itself executes nothing.
* launch accounting — a replay runs no Python, so a kernel wrapper's
  ``launches += 1`` would stop counting.  While a body is captured,
  :func:`recorded_launches` takes the change of every counter in the
  kernels' registry (``kernels/_counters.py``) and puts the counters
  back; each replay adds that change again (:class:`LaunchCounts`).
  The counters then mean what they mean in an eager run: launches that
  did work on the path.  Launches of a warm-up or a capture are not
  counted.
* :class:`GraphCache` — an owner's programs by signature, captured into
  one memory pool per device, freed with the owner.
* :data:`CAPTURE_LOCK` — held around every capture and every counter
  window (:func:`kept_launches`, so :func:`recorded_launches` and
  :func:`warm_up` too); a thread that launches kernels op by op beside
  the captured one (``io.DevicePrefetchIter``'s worker) holds it around
  that work, so no launch counter moves inside a window but by the
  window's own work: the worker's launches are neither taken into a
  capture's change (which each replay would add again) nor undone with a
  warm-up's.
* replays beside a capture — the serving cluster's replicas each
  replay their own graph on a stream of their own while another replica
  captures.  A capture runs in ``thread_local`` error mode (CUDA refuses
  only the capturing thread's unsafe calls, not another thread's
  replays, event waits and copies), and a replay does not take
  :data:`CAPTURE_LOCK`: while another thread holds a counter window, its
  :meth:`LaunchCounts.add` is kept aside and applied when the window
  closes, so the window's change and the counters' totals both stay
  exact.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from .kernels._counters import registered

__all__ = ["LaunchCounts", "kept_launches",
           "recorded_launches", "warm_up", "no_collection", "Program",
           "GraphCache", "CAPTURE_LOCK"]

CAPTURE_LOCK = threading.RLock()

# the open counter window: its thread, its depth, and the replays of
# other threads kept aside until it closes (all under _COUNTS)
_COUNTS = threading.Lock()
_WINDOW = {"owner": None, "depth": 0, "aside": []}


class LaunchCounts:
    """The change of a set of launch counters over some run, which
    :meth:`add` applies again."""

    def __init__(self, changes):
        self.changes = changes          # [(holder, attribute, delta)]

    def add(self):
        with _COUNTS:
            owner = _WINDOW["owner"]
            if owner is not None and owner != threading.get_ident():
                _WINDOW["aside"].append(self)
                return
            self._apply()

    def _apply(self):
        for holder, attr, delta in self.changes:
            setattr(holder, attr, getattr(holder, attr) + delta)


@contextlib.contextmanager
def kept_launches(counters=None):
    """Every launch counter as it was on entry, again on exit, with
    :data:`CAPTURE_LOCK` held in between (other threads' replays in
    between are counted after)."""
    counters = registered() if counters is None else counters
    with CAPTURE_LOCK:
        with _COUNTS:
            _WINDOW["owner"] = threading.get_ident()
            _WINDOW["depth"] += 1
        before = [getattr(h, a) for h, a in counters]
        try:
            yield counters, before
        finally:
            for (h, a), v in zip(counters, before):
                setattr(h, a, v)
            with _COUNTS:
                _WINDOW["depth"] -= 1
                if _WINDOW["depth"] == 0:
                    _WINDOW["owner"] = None
                    aside, _WINDOW["aside"] = _WINDOW["aside"], []
                    for counts in aside:
                        counts._apply()


def recorded_launches(fn, counters=None):
    """``(fn(), LaunchCounts)``: what ``fn`` returned and how it moved
    each counter, the counters left as they were before the call."""
    with kept_launches(counters) as (counters, before):
        out = fn()
        changes = [(h, a, getattr(h, a) - v)
                   for (h, a), v in zip(counters, before)
                   if getattr(h, a) != v]
    return out, LaunchCounts(changes)


def warm_up(fn, runs=1):
    """Run ``fn`` ``runs`` times on a side stream, ordered after the
    current stream's work and before its next (torch's recipe before a
    capture), launch counters kept."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with kept_launches(), torch.cuda.stream(side):
        for _ in range(runs):
            fn()
    torch.cuda.current_stream().wait_stream(side)


@contextlib.contextmanager
def no_collection():
    """Around a capture: collect garbage first, then keep Python's cycle
    collector off.  An owner (engine, train step, hybridized block)
    sits in a reference cycle with its programs, so the collector frees
    it; freeing a graph while another one is being captured is a CUDA
    call that invalidates that capture.  Collecting first also returns
    dead owners' graph memory before the new capture takes its own."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class Program:
    """``body()`` over static buffers: captured on a CUDA ``device`` into
    ``pool`` (with ``generators`` registered, so that each replay
    advances them as an eager run would) and replayed by every call;
    run eagerly by every call on the CPU.  A call returns what the body
    returned: on CUDA the captured (static) tensors, which the next
    replay overwrites.  Called on a stream other than the default one
    (a serving cluster's replica), it captures on that stream, else on
    torch's shared capture stream: graphs that replay at once on
    different streams must be captured on different streams, since a
    graph keeps the cuBLAS workspace of the stream it was captured
    on."""

    def __init__(self, body, device, pool=None, generators=()):
        self.body = body
        self.graph = None
        self.out = None
        self.launches = None
        if device.type != "cuda":
            return
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        stream = torch.cuda.current_stream(device)
        if stream == torch.cuda.default_stream(device):
            stream = None

        def capture():
            with CAPTURE_LOCK, no_collection(), \
                    torch.cuda.graph(graph, pool=pool, stream=stream,
                                     capture_error_mode="thread_local"):
                return body()

        self.out, self.launches = recorded_launches(capture)
        self.graph = graph

    def __call__(self):
        if self.graph is None:
            return self.body()
        self.graph.replay()
        self.launches.add()
        return self.out


class GraphCache:
    """One owner's programs by signature, sharing one memory pool per
    CUDA device (``torch.cuda.graph_pool_handle``).  Dropping the cache
    (or its owner) frees the graphs and their pools; :meth:`clear`
    frees them and drops the pools (torch refuses to capture into a
    pool whose graphs are all gone)."""

    def __init__(self, device=None):
        self.device = device
        self.entries = {}
        self.pools = {}

    def get(self, key):
        return self.entries.get(key)

    def put(self, key, entry):
        self.entries[key] = entry
        return entry

    def clear(self):
        self.entries.clear()
        self.pools.clear()

    def pool(self, device=None):
        """The pool of ``device`` (default: the owner's), taken at its
        first use; None off CUDA."""
        device = torch.device(self.device if device is None else device)
        if device.type != "cuda":
            return None
        if device not in self.pools:
            self.pools[device] = torch.cuda.graph_pool_handle()
        return self.pools[device]

    def __len__(self):
        return len(self.entries)
