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
the engine's ``PrefixCache`` frees (or, with a host tier, spills) LRU
refcount-0 chains there, so cached but unreferenced prefixes never
starve a live request.  The allocator counts its calls, pages handed
out and recycled and refused allocations in plain ints, which the
engine's metrics read (``reset_telemetry`` zeroes them).

Page transfer, the unit of the host-DRAM tier: :meth:`export_pages`
gathers N pages of every layer pool into host memory and
:meth:`install_pages` scatters such content into allocated pages, in
place (``index_copy_`` into ``pools[l][k]``: the storage the engine's
captured step reads is never rebound; the reference instead reassigns
its donated pools).  The content layout is the reference's: per layer
``{"kv": (n, ps, H, 2dh)[, "s": (n, 2, ps, H) f32]}``, here as views
into one host buffer that is page-major (a page's layers lie
together, so single-page spills concatenate into one install).  On
CUDA the buffer is pinned and filled by one asynchronous copy whose
event every host read waits on (:class:`PageContent`).
:meth:`copy_page` is the whole-page copy of a copy-on-write (the
reference engine's ``_make_copy``), in place.

With ``deferred = True`` (the engine sets it) copies, exports and
installs are queued in the order they are asked for and run by
:meth:`run_transfers` on the caller's stream: the engine runs the
queue on its own thread just before it stages a step, so the
scheduler (possibly a planner thread) never touches the device, and
an export of a page the same plan frees and hands out again still
reads the old bytes.  Otherwise each runs at once.  Consecutive
queued exports run as one (one gather a pool, one copy to the host,
one event; each content a slice of the shared buffer): a transfer's
cost on the host is per call, not per page, and pressure spills one
page at a time.

The tensor-parallel ``mesh`` layout of the reference is not ported yet.
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np
import torch

from .. import resolve_device
from ..models.transformer import torch_dtype

__all__ = ["PagedKVCache", "PageContent", "contiguous_kv_bytes"]

_ALIGN = 16          # byte alignment of each pool's slice of a page


def contiguous_kv_bytes(cfg, batch, total, kv_int8=False):
    """Device bytes a contiguous (batch, total) KV cache would hold:
    2 * dh elements per row, head and token of every layer, plus the
    f32 scale pair per row and token when int8 (the baseline the paged
    pool is compared with)."""
    dh = cfg.d_model // cfg.n_heads
    rows = batch * cfg.n_heads * total
    per_row = 2 * dh * (1 if kv_int8 else torch.empty(
        0, dtype=torch_dtype(cfg.dtype)).element_size())
    if kv_int8:
        per_row += 2 * 4
    return rows * per_row * cfg.n_layers


class PageContent:
    """``n_pages`` pages of every layer pool in host memory, in the
    reference's ``export_pages`` layout: ``content[l]`` is the dict
    ``{"kv": (n, ps, H, 2dh)[, "s": (n, 2, ps, H)]}`` of layer l (views
    into one page-major buffer, ``host``).  ``nbytes`` counts the pool
    bytes (``n_pages * bytes_per_page``), as the reference's arrays'.

    An export's content is filled when its transfer runs (at once, or
    at the engine's next dispatch when the cache defers); on CUDA by an
    asynchronous copy into pinned memory.  Indexing waits for both
    (:meth:`wait`); the budget of a tier needs only ``nbytes``, and an
    install reads ``host`` on the same stream, after the copy."""

    __slots__ = ("cache", "n_pages", "nbytes", "ids", "host", "event")

    def __init__(self, cache, n_pages, ids=None, host=None):
        self.cache = cache
        self.n_pages = n_pages
        self.nbytes = n_pages * cache.bytes_per_page
        self.ids = ids                # page ids of a pending export
        self.host = host              # (n_pages * stride,) uint8
        self.event = None             # CUDA event after the D2H copy

    def wait(self):
        """The per-layer dicts, once the export has run and landed."""
        if self.host is None:
            self.cache.run_transfers()
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.cache._views(self.host, self.n_pages)

    def __len__(self):
        return len(self.cache.pools)

    def __getitem__(self, layer):
        return self.wait()[layer]

    def __iter__(self):
        return iter(self.wait())


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
        # allocator telemetry: plain ints the engine's metrics read
        self.alloc_calls = 0
        self.alloc_pages_total = 0
        self.freed_pages_total = 0
        self.alloc_failures = 0
        # one page's slice of each pool in a PageContent buffer:
        # (layer, key, byte offset, bytes, dtype, page shape)
        self._layout = []
        off = 0
        for layer, pool in enumerate(self.pools):
            for key, t in pool.items():
                nb = t[0].numel() * t.element_size()
                self._layout.append((layer, key, off, nb, t.dtype,
                                     tuple(t.shape[1:])))
                off += -(-nb // _ALIGN) * _ALIGN
        self._stride = off
        self.deferred = False
        self._queue = []                 # deferred transfers, in order
        self._queue_lock = threading.Lock()
        self._run_lock = threading.Lock()

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
        self.alloc_calls += 1
        if n > len(self._free) and self.pressure_cb is not None:
            self.pressure_cb(n - len(self._free))
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        out = [self._free.popleft() for _ in range(n)]
        self._in_use += n
        self.alloc_pages_total += n
        return out

    def reset_telemetry(self):
        """Zero the allocator counters (the free list and in-use count
        are untouched)."""
        self.alloc_calls = 0
        self.alloc_pages_total = 0
        self.freed_pages_total = 0
        self.alloc_failures = 0

    def free(self, pages):
        """Recycle pages (no zero-fill — see the module docstring)."""
        for p in pages:
            if not 1 <= p < self.num_pages:
                raise ValueError("free: bad page id %r" % (p,))
        self._free.extend(pages)
        self._in_use -= len(pages)
        self.freed_pages_total += len(pages)

    # ------------------------------------------------ page transfer --
    def _submit(self, op):
        """Run ``op`` (a callable, or the :class:`PageContent` of an
        export) now, or queue it when deferred."""
        if not self.deferred:
            self._run([op])
            return
        with self._queue_lock:
            self._queue.append(op)

    def run_transfers(self):
        """Run the queued copies, exports and installs in the order
        they were asked for, on the current stream (the engine calls
        this on its thread before staging a step)."""
        with self._run_lock:             # one runner at a time, in order
            with self._queue_lock:
                ops, self._queue = self._queue, []
            self._run(ops)

    def _run(self, ops):
        i = 0
        while i < len(ops):
            if isinstance(ops[i], PageContent):
                j = i + 1
                while j < len(ops) and isinstance(ops[j], PageContent):
                    j += 1
                self._export(ops[i:j])
                i = j
            else:
                ops[i]()
                i += 1

    def copy_page(self, src, dst):
        """Copy page ``src`` into page ``dst`` in every layer's pools,
        in place: the storage the engine's captured step reads is never
        rebound."""
        def op():
            for pool in self.pools:
                for t in pool.values():
                    t[dst].copy_(t[src])
        self._submit(op)

    def _views(self, flat, n):
        """Per-layer dicts of ``(n,) + page shape`` views of a
        page-major buffer of ``n`` pages (host or device)."""
        rows = flat.view(n, self._stride)
        out = [{} for _ in self.pools]
        for layer, key, off, nb, dtype, shape in self._layout:
            out[layer][key] = rows[:, off:off + nb].view(dtype) \
                .view((n,) + shape)
        return out

    def _index(self, page_ids):
        idx = torch.tensor(list(page_ids), dtype=torch.long)
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def export_pages(self, page_ids):
        """The content of ``page_ids`` across every layer pool, as a
        :class:`PageContent` (the reference's layout, in ``page_ids``
        order).  One gather a pool into a device buffer and, on CUDA,
        one asynchronous copy into pinned host memory."""
        page_ids = [int(p) for p in page_ids]
        content = PageContent(self, len(page_ids), ids=page_ids)
        if not page_ids:
            content.host = torch.zeros(0, dtype=torch.uint8)
            return content
        self._submit(content)
        return content

    def _export(self, contents):
        """Run the exports of ``contents`` as one: gather their pages
        into one device buffer, copy it to the host, and give each
        content its page-major slice."""
        ids = [p for c in contents for p in c.ids]
        n = len(ids)
        stage = torch.empty(n * self._stride, dtype=torch.uint8,
                            device=self.device)
        idx = self._index(ids)
        views = self._views(stage, n)
        for layer, pool in enumerate(self.pools):
            for key, t in pool.items():
                torch.index_select(t, 0, idx, out=views[layer][key])
        event = None
        if self.device.type == "cuda":
            host = torch.empty(stage.numel(), dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(stage, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = stage
        off = 0
        for c in contents:
            size = c.n_pages * self._stride
            c.host, c.event = host[off:off + size], event
            off += size

    def content_from(self, layers):
        """A :class:`PageContent` holding ``layers``, content in the
        reference's layout (per layer ``{"kv", ("s")}`` numpy arrays or
        tensors of n pages), checked against this pool's page shapes
        and dtypes."""
        if len(layers) != len(self.pools):
            raise ValueError(
                "install_pages: %d layers of content for a %d-layer pool"
                % (len(layers), len(self.pools)))
        n = None
        for layer, pool in zip(layers, self.pools):
            for key, ref in pool.items():
                a = layer[key]
                dt = a.dtype if isinstance(a, torch.Tensor) else \
                    torch.from_numpy(np.zeros(0, a.dtype)).dtype
                n = a.shape[0] if n is None else n
                want = (n,) + tuple(ref.shape[1:])
                if tuple(a.shape) != want or dt != ref.dtype:
                    raise ValueError(
                        "install_pages: content %s %r/%s does not match "
                        "pool page shape %r/%s" % (key, tuple(a.shape),
                                                    dt, want, ref.dtype))
        host = torch.empty(n * self._stride, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        views = self._views(host, n)
        for layer, lay in enumerate(layers):
            for key, a in lay.items():
                views[layer][key].copy_(
                    a if isinstance(a, torch.Tensor) else
                    torch.from_numpy(np.array(a)))
        return PageContent(self, n, host=host)

    def install_pages(self, page_ids, content):
        """Scatter ``content`` into this pool's ``page_ids`` (already
        allocated by the caller), in place.  ``content`` is a
        :class:`PageContent`, a list of them (installed as one, in
        order: the pages of a chain spilled one by one), or the
        reference's layout (checked by :meth:`content_from`).  One
        copy to the device a part and one ``index_copy_`` a pool."""
        page_ids = [int(p) for p in page_ids]
        if isinstance(content, PageContent):
            parts = [content]
        elif len(content) and isinstance(content[0], PageContent):
            parts = list(content)
        else:
            parts = [self.content_from(content)]
        n = len(page_ids)
        if sum(p.n_pages for p in parts) != n:
            raise ValueError("install_pages: %d pages of content for %d "
                             "page ids" % (sum(p.n_pages for p in parts), n))
        if n == 0:
            return

        def op():
            if self.device.type == "cuda":
                stage = torch.empty(n * self._stride, dtype=torch.uint8,
                                    device=self.device)
                off = 0
                for p in parts:
                    stage[off:off + p.host.numel()].copy_(p.host,
                                                          non_blocking=True)
                    off += p.host.numel()
            else:
                stage = torch.cat([p.host for p in parts])
            idx = self._index(page_ids)
            views = self._views(stage, n)
            for layer, pool in enumerate(self.pools):
                for key, t in pool.items():
                    t.index_copy_(0, idx, views[layer][key])
        self._submit(op)

    # ---------------------------------------------------- accounting --
    @property
    def bytes_per_page(self):
        """Device bytes one page costs across all layers."""
        return sum(nb for _, _, _, nb, _, _ in self._layout)

    @property
    def bytes_held(self):
        """Device bytes held by allocated (non-scratch, non-free)
        pages."""
        return self._in_use * self.bytes_per_page

    @property
    def bytes_pool(self):
        """Device bytes of the whole preallocated pool."""
        return self.num_pages * self.bytes_per_page

    @property
    def bytes_held_per_device(self):
        """``bytes_held`` on each device: the pool lies on one card."""
        return self.bytes_held

    @property
    def bytes_pool_per_device(self):
        """``bytes_pool`` on each device: the pool lies on one card."""
        return self.bytes_pool
