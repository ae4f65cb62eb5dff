"""The registry of kernel launch counters.

Each kernel wrapper keeps a count of its launches in an attribute
(``flash_fwd.launches``, each ``rtc.CudaKernel``'s ``launches``) and
registers it here when it is defined.  A CUDA-graph replay runs no
Python, so ``_graphs`` takes the change of every registered counter
while a graph is captured and adds it again at each replay; a counter
registered here is counted under replay without any edit there.
"""
from __future__ import annotations

import threading
import weakref

__all__ = ["register", "registered"]

_lock = threading.Lock()
_counters = []          # [(weak reference to the holder, attribute)]


def register(holder, *attrs):
    """Set each counter ``attrs`` of ``holder`` to 0 and register it;
    returns ``holder``.  The registry holds ``holder`` weakly."""
    ref = weakref.ref(holder)
    with _lock:
        for attr in attrs:
            setattr(holder, attr, 0)
            _counters.append((ref, attr))
    return holder


def registered():
    """(holder, attribute) of every registered counter whose holder is
    alive."""
    with _lock:
        _counters[:] = [(r, a) for r, a in _counters if r() is not None]
        live = [(r(), a) for r, a in _counters]
    return [(h, a) for h, a in live if h is not None]
