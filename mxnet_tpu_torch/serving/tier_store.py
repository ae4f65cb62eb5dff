"""Host-DRAM KV page tier: spill instead of drop, install instead of
recompute.  Port of ``mxnet_tpu/serving/tier_store.py``.

When the pool runs short, a refcount-0 prefix chain evicted under
pressure would be dropped and paid again as a full prefill on its next
hit, and a preemption victim's pages would be discarded and paid again
as a recompute at resume: both O(prefill), for bytes that existed,
exactly, in the pool the moment before.

:class:`HostTierStore` is the second tier under the pool: a
byte-budgeted LRU of **exact pool-layout page content** on the host,
the ``PageContent`` blocks ``PagedKVCache.export_pages`` makes and
``install_pages`` consumes (pinned host memory on CUDA).  Spilling a
page is one gather and one copy to the host; restoring it one copy to
the device and one scatter: O(transfer) against O(prefill).

Two entry families share the budget:

* ``("prefix", chain_key)``: one refcount-0 prefix-cache page, spilled
  by ``PrefixCache._drop`` under pool pressure and restored by
  ``PrefixCache.match`` as a **warm hit** (the outcome between hot hit
  and miss).  Which spilled keys are reachable stays in
  ``PrefixCache``; this store holds bytes only.
* ``("swap", rid)``: a preemption victim's written pages (positions
  ``[0, n_cached)``) and its resume meta (``n_cached``, ``pending``),
  swapped out by ``ServingEngine._preempt_victim`` and back in by
  ``_admit`` as an **install-exact** resume.  A swap entry LRU-evicted
  before the victim resumes falls back to recompute: exactness never
  depends on the tier.

Eviction is strict LRU over both families.  ``evict_cb(key)`` fires
AFTER the entry has left the store, so the callback may ``pop`` other
keys (``PrefixCache`` drops a spilled chain's unreachable descendants
this way).  Everything here is host state, called under the owning
engine's lock; budget and LRU accounting use each entry's pool bytes
(``content_nbytes``), so a ``put`` never waits for its copy.  The
movement counters (``spilled_pages_total`` ...) are plain ints that
the engine's ``_EngineObs.sync_tier`` folds into the
``serving_tier_{spills,installs,bytes}_total`` counters and the
occupancy gauges.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["HostTierStore", "content_nbytes"]


def content_nbytes(content) -> int:
    """Host bytes of an ``export_pages``-layout content block: a
    ``PageContent`` (its pool bytes, known before its copy lands) or
    the per-layer list of ``{"kv": array, ("s": array)}`` dicts (numpy
    arrays or tensors)."""
    if hasattr(content, "nbytes"):
        return int(content.nbytes)
    return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor)
               else np.asarray(a).nbytes
               for layer in content for a in layer.values())


class _TierEntry:
    __slots__ = ("content", "n_pages", "nbytes", "meta")

    def __init__(self, content, n_pages, nbytes, meta):
        self.content = content            # export_pages layout (host)
        self.n_pages = n_pages
        self.nbytes = nbytes
        self.meta: Optional[dict] = meta  # swap entries: resume state


class HostTierStore:
    """Byte-budgeted LRU of exact pool-layout page bytes in host DRAM.

    ``put`` refuses (returns False) rather than evicting the world
    when a single entry exceeds the whole budget; the caller then
    falls back to the pre-tier behavior (drop / recompute).  ``get``
    and ``peek`` touch LRU recency; ``pop`` removes.  All host-side,
    called under the owning engine's lock.
    """

    def __init__(self, budget_bytes: int,
                 evict_cb: Optional[Callable[[Any], None]] = None):
        if budget_bytes < 1:
            raise ValueError("HostTierStore: budget_bytes must be "
                             ">= 1 (use tier_bytes=None to disable "
                             "the tier)")
        self.budget_bytes = int(budget_bytes)
        self.evict_cb = evict_cb
        self._entries: "OrderedDict[Any, _TierEntry]" = OrderedDict()
        # occupancy is maintained INCREMENTALLY at the five mutation
        # sites: the engine's per-step gauge sync reads these on the
        # hot scheduling thread, where an O(entries) scan would price
        # every step by the tier's size
        self.bytes_held = 0
        self.pages_held = 0
        # host ints, delta-folded into the obs registry (sync_tier)
        self.spilled_pages_total = 0      # pages put (device -> host)
        self.installed_pages_total = 0    # pages popped for install
        self.bytes_moved_total = 0        # bytes through, both ways
        self.evicted_pages_total = 0      # pages LRU-dropped
        self.evictions_total = 0          # entries LRU-dropped

    # ------------------------------------------------------ queries --
    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    # ------------------------------------------------------- put/get --
    def put(self, key, content, n_pages: int,
            meta: Optional[dict] = None) -> bool:
        """Admit one entry, LRU-evicting until it fits.  Returns False
        (nothing stored, nothing evicted) when the entry alone
        overflows the budget — the caller keeps the pre-tier drop/
        recompute behavior.  Re-putting a live key replaces it."""
        nbytes = content_nbytes(content)
        if nbytes > self.budget_bytes:
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_held -= old.nbytes
            self.pages_held -= old.n_pages
        while self.bytes_held + nbytes > self.budget_bytes \
                and self._entries:
            self._evict_lru()
        self._entries[key] = _TierEntry(content, int(n_pages), nbytes,
                                        meta)
        self.bytes_held += nbytes
        self.pages_held += int(n_pages)
        self.spilled_pages_total += int(n_pages)
        self.bytes_moved_total += nbytes
        return True

    def peek(self, key) -> Optional[_TierEntry]:
        """Entry without install accounting; touches LRU recency (a
        peeked entry is about to be used — ``_admit`` peeks before it
        can afford the pool pages, and the pressure spills that alloc
        triggers must not evict the entry being resumed)."""
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
        return e

    def get(self, key) -> Optional[_TierEntry]:
        """Entry for a host-side read (``spilled_content``): touches
        recency and counts the bytes as moved, entry stays stored."""
        e = self.peek(key)
        if e is not None:
            self.bytes_moved_total += e.nbytes
        return e

    def pop(self, key) -> Optional[_TierEntry]:
        """Remove and return an entry for install (host -> device);
        None if missing (evicted meanwhile — callers degrade to the
        pre-tier path)."""
        e = self._entries.pop(key, None)
        if e is None:
            return None
        self.bytes_held -= e.nbytes
        self.pages_held -= e.n_pages
        self.installed_pages_total += e.n_pages
        self.bytes_moved_total += e.nbytes
        return e

    def drop(self, key) -> bool:
        """Remove without install accounting (the content is being
        discarded, not moved: a cancelled swap, an unreachable spilled
        descendant)."""
        e = self._entries.pop(key, None)
        if e is None:
            return False
        self.bytes_held -= e.nbytes
        self.pages_held -= e.n_pages
        return True

    # ----------------------------------------------------- eviction --
    def _evict_lru(self):
        key, e = self._entries.popitem(last=False)
        self.bytes_held -= e.nbytes
        self.pages_held -= e.n_pages
        self.evicted_pages_total += e.n_pages
        self.evictions_total += 1
        if self.evict_cb is not None:
            # AFTER removal so the callback may pop()/drop() other
            # keys (a spilled chain's descendants) reentrantly
            self.evict_cb(key)

    def clear(self):
        """Drop everything without eviction callbacks (engine
        teardown; the trie bookkeeping is being dropped wholesale by
        the same caller)."""
        self._entries.clear()
        self.bytes_held = 0
        self.pages_held = 0

    def reset_telemetry(self):
        """Zero the movement counters (warmup exclusion in benches;
        held entries and occupancy are untouched)."""
        self.spilled_pages_total = 0
        self.installed_pages_total = 0
        self.bytes_moved_total = 0
        self.evicted_pages_total = 0
        self.evictions_total = 0

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries),
                "pages_held": self.pages_held,
                "bytes_held": self.bytes_held,
                "budget_bytes": self.budget_bytes,
                "spilled_pages_total": self.spilled_pages_total,
                "installed_pages_total": self.installed_pages_total,
                "bytes_moved_total": self.bytes_moved_total,
                "evicted_pages_total": self.evicted_pages_total,
                "evictions_total": self.evictions_total}
