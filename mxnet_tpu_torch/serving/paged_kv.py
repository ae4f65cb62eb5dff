"""Paged KV cache: fixed-size pages in one preallocated pool per layer.
Port of ``mxnet_tpu/serving/paged_kv.py``.

Layout (per decoder layer), as in the reference:

    kv pool : (num_pages, page_size, H, 2*dh)   compute dtype | int8
    s pool  : (num_pages, 2, page_size, H)      f32 scale planes (int8)

A page holds ``page_size`` consecutive positions of one sequence, all
heads, k and v halves fused on the last axis; a request's cache is its
block table of page ids.  Page 0 is the SCRATCH page: unallocated
block-table entries and dead rows point at it, and it is never read
under the position mask.  The allocator is a host-side free list of
plain ints; the pools are torch tensors that the engine's step writes
in place.  Freed pages are not zero-filled: a sequence only attends to
positions it has written itself.

``pressure_cb`` (the reference's hook, ``paged_kv.py:238``): when
``alloc`` would fail, the callback is asked to surrender pages first;
the engine's ``PrefixCache`` frees LRU refcount-0 chains there, so
cached but unreferenced prefixes never starve a live request.
:meth:`PagedKVCache.copy_page` is the whole-page copy of a
copy-on-write (the reference engine's ``_make_copy``), in place.

Page export/install (disaggregated serving) and the tensor-parallel
``mesh`` layout of the reference are not ported yet.
"""
from __future__ import annotations

from collections import deque

import torch

from .. import resolve_device
from ..models.transformer import torch_dtype

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Preallocated per-layer page pools + the host-side allocator.
    ``pools`` is a list (one dict per layer) of ``{"kv"[, "s"]}``."""

    def __init__(self, cfg, num_pages, page_size, kv_int8=False,
                 device=None):
        if num_pages < 2:
            raise ValueError("PagedKVCache: need >= 2 pages (page 0 "
                             "is scratch)")
        if page_size < 1:
            raise ValueError("PagedKVCache: page_size must be >= 1")
        dev = resolve_device(device)
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_int8 = bool(kv_int8)
        self.device = dev
        H = cfg.n_heads
        dh = cfg.d_model // H
        kv_dt = torch.int8 if kv_int8 else torch_dtype(cfg.dtype)
        self.pools = []
        for _ in range(cfg.n_layers):
            pool = {"kv": torch.zeros(num_pages, page_size, H, 2 * dh,
                                      dtype=kv_dt, device=dev)}
            if kv_int8:
                pool["s"] = torch.zeros(num_pages, 2, page_size, H,
                                        dtype=torch.float32, device=dev)
            self.pools.append(pool)
        self._free = deque(range(1, num_pages))    # page 0 is scratch
        self._in_use = 0
        self.pressure_cb = None

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self._in_use

    def alloc(self, n):
        """Allocate n pages; a list of page ids, or None when the pool
        cannot satisfy the request (never a partial allocation)."""
        if n < 0:
            raise ValueError("alloc: n must be >= 0")
        if n > len(self._free) and self.pressure_cb is not None:
            self.pressure_cb(n - len(self._free))
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        self._in_use += n
        return out

    def free(self, pages):
        """Recycle pages (no zero-fill — see the module docstring)."""
        for p in pages:
            if not 1 <= p < self.num_pages:
                raise ValueError("free: bad page id %r" % (p,))
        self._free.extend(pages)
        self._in_use -= len(pages)

    def copy_page(self, src, dst):
        """Copy page ``src`` into page ``dst`` in every layer's pools,
        in place on the current stream: the storage the engine's
        captured step reads is never rebound."""
        for pool in self.pools:
            for t in pool.values():
                t[dst].copy_(t[src])
