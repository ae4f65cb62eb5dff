"""KV-page streaming between disaggregated serving processes.  Port of
``mxnet_tpu/serving/page_streamer.py``.

The prefill worker owns a :class:`PageStreamer`: after every engine
step it exports the pages a handoff request has newly completed
(``n_cached`` crossed another page boundary) and frames them for the
decode worker, so page transfer is pipelined with the prefill chunks.
The decode worker owns a :class:`PageReceiver`: arriving pages are
installed into its ``PagedKVCache`` as the pool allows, and a request
is admitted once its last page and its handoff metadata are in.

Wire layout (the ``pages`` frame): raw buffers in pool order, for each
layer the ``kv`` page block then, under int8 KV, the ``s`` scale
block; shapes follow from the receiver's own pool config (both sides
were built from one engine config), and byte lengths are checked on
install.  The bytes are exact pool bytes, so under f32 the handed-off
decode is bit-identical to one engine's, and int8 pages and their f32
scales transfer losslessly.

On this port an export is a ``PageContent`` (``PagedKVCache.
export_pages``): a pinned host buffer, filled on CUDA by an
asynchronous copy that reading it waits for.  An install copies the
received bytes once into a pinned staging buffer of the cache
(``PagedKVCache.content_from``) before it returns, and queues the
scatter onto the device; the engine runs it at its next dispatch,
outside the replay of its captured step (a capture refuses host
copies).  So a frame's buffers, a put segment's mapping included, are
released right after ``install_pages`` returns: nothing on the device
reads them.  A frame the pool cannot take yet is held as received,
with no copy, and released when it is installed or aborted.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .transport import raw_bytes, tensor_from_bytes

__all__ = ["PageStreamer", "PageReceiver", "pages_to_bufs",
           "bufs_to_pages", "page_wire_bytes", "merge_page_content"]


def _page_shapes(cfg, page_size, kv_int8):
    H = cfg.n_heads
    dh = cfg.d_model // H
    out = [("kv", (page_size, H, 2 * dh),
            "int8" if kv_int8 else str(cfg.dtype))]
    if kv_int8:
        out.append(("s", (2, page_size, H), "float32"))
    return out


def _release(bufs):
    """Release transport-owned buffers (a put segment has a ``release``
    hook; socket bytearrays have none)."""
    rel = getattr(bufs, "release", None)
    if rel is not None:
        rel()


def pages_to_bufs(content) -> List:
    """Exported page content (a ``PageContent``, or the reference's
    list of per-layer ``{"kv"[, "s"]}`` arrays) as ordered raw
    buffers."""
    bufs = []
    for layer in content:
        bufs.append(raw_bytes(layer["kv"]))
        if "s" in layer:
            bufs.append(raw_bytes(layer["s"]))
    return bufs


def bufs_to_pages(cache, n: int, bufs: List):
    """Ordered raw buffers as ``install_pages`` content for ``cache``:
    per layer ``{"kv"[, "s"]}`` CPU tensors over the buffers (shapes and
    dtypes from the cache's own pool config; lengths checked here)."""
    shapes = _page_shapes(cache.cfg, cache.page_size, cache.kv_int8)
    want = cache.cfg.n_layers * len(shapes)
    if len(bufs) != want:
        raise ValueError("page frame: %d buffers, expected %d "
                         "(n_layers x pool keys)" % (len(bufs), want))
    out, i = [], 0
    for _ in range(cache.cfg.n_layers):
        layer = {}
        for key, shape, dtype in shapes:
            t = tensor_from_bytes(bufs[i], "uint8", (-1,))
            size = torch.empty(0, dtype=getattr(torch, dtype)) \
                .element_size()
            if t.numel() != n * size * int(np.prod(shape)):
                raise ValueError(
                    "page frame: buffer %d holds %d bytes, expected %d"
                    % (i, t.numel(), n * size * int(np.prod(shape))))
            layer[key] = tensor_from_bytes(bufs[i], dtype,
                                           (n,) + shape)
            i += 1
        out.append(layer)
    return out


def page_wire_bytes(cache, n: int) -> int:
    """The bytes ``n`` pages cost on the wire (their pool bytes)."""
    return n * cache.bytes_per_page


def _cat(xs):
    if any(isinstance(x, torch.Tensor) for x in xs):
        return torch.cat([torch.as_tensor(x) for x in xs])
    return np.concatenate(xs)


def merge_page_content(parts: List) -> List:
    """Several exported content blocks as one along the page axis (a
    fetch reply may join hot pages from the pool with pages off the
    host tier)."""
    if len(parts) == 1:
        return parts[0]
    return [{k: _cat([p[li][k] for p in parts]) for k in parts[0][li]}
            for li in range(len(parts[0]))]


class PageStreamer:
    """Prefill side, per request: which pages were sent, and which are
    newly ready after a step."""

    def __init__(self, engine):
        self.engine = engine
        self._sent: Dict[int, int] = {}          # rid -> pages sent
        self.pages_streamed_total = 0
        self.bytes_streamed_total = 0

    def pending(self, rid: int) -> int:
        return self._sent.get(rid, 0)

    def pump(self, rid: int, n_cached: int, pages: List[int],
             final: bool = False) -> Optional[Tuple[int, int, List]]:
        """Export the request's newly completed pages (``pages`` and
        ``n_cached`` come from the caller: at handoff the engine has
        already retired the request, and they come from its retire-time
        snapshot).  ``(start_page, n_pages, bufs)``, or None when
        nothing new is ready.  ``final=True`` takes the trailing partial
        page too (its positions past ``n_cached`` are never read)."""
        ps = self.engine.page_size
        ready = (n_cached + ps - 1) // ps if final else n_cached // ps
        ready = min(ready, len(pages))
        start = self._sent.get(rid, 0)
        if ready <= start:
            return None
        content = self.engine.cache.export_pages(pages[start:ready])
        self._sent[rid] = ready
        n = ready - start
        self.pages_streamed_total += n
        self.bytes_streamed_total += page_wire_bytes(self.engine.cache, n)
        return start, n, pages_to_bufs(content)

    def drop(self, rid: int):
        self._sent.pop(rid, None)


class _Staged:
    __slots__ = ("installed", "held", "next_idx", "total", "meta")

    def __init__(self):
        self.installed: List[int] = []    # local page ids, in order
        self.held: List = []              # frames waiting for pool space
        self.next_idx = 0                 # next page index expected
        self.total: Optional[int] = None  # set by the handoff frame
        self.meta: Optional[dict] = None  # handoff metadata


class PageReceiver:
    """Decode side: install arriving pages at once (pipelined with the
    prefill's tail), hold frames while the pool is dry, admit when the
    request is complete."""

    def __init__(self, engine):
        self.engine = engine
        self._staged: Dict[object, _Staged] = {}
        self.pages_installed_total = 0

    def on_pages(self, rid, start: int, n: int, bufs: List):
        """A ``pages`` frame arrived: stage it and, pool permitting,
        install it.  Pages ride one in-order stream, so a gap is a
        protocol error."""
        st = self._staged.setdefault(rid, _Staged())
        expect = st.next_idx + sum(h[0] for h in st.held)
        if start != expect:
            raise RuntimeError(
                "page stream for rid %r out of order: got start %d, "
                "expected %d" % (rid, start, expect))
        st.held.append((n, bufs))
        self._try_install(st)

    def on_handoff(self, rid, total_pages: int, meta: dict):
        st = self._staged.setdefault(rid, _Staged())
        st.total = total_pages
        st.meta = meta
        self._try_install(st)

    def _try_install(self, st: _Staged):
        while st.held:
            n, bufs = st.held[0]
            ids = self.engine.cache.alloc(n)
            if ids is None:
                return                    # pool dry: hold as received
            # copies the bytes into pinned staging before it returns;
            # the device scatter runs at the engine's next dispatch
            self.engine.cache.install_pages(
                ids, bufs_to_pages(self.engine.cache, n, bufs))
            st.installed.extend(ids)
            st.next_idx += n
            st.held.pop(0)
            self.pages_installed_total += n
            _release(bufs)

    def ready(self, rid) -> bool:
        """Every page installed and the handoff metadata in?"""
        st = self._staged.get(rid)
        return (st is not None and st.total is not None
                and not st.held and st.next_idx == st.total)

    def retry_installs(self):
        """Pool pressure may have eased: install held frames."""
        for st in self._staged.values():
            self._try_install(st)

    def take(self, rid) -> Tuple[List[int], dict]:
        """A ready request's installed pages and handoff meta (for
        ``engine.admit_prefilled``); the staging record goes, the pages
        now belong to the engine request."""
        st = self._staged.pop(rid)
        return st.installed, st.meta

    def abort(self, rid) -> int:
        """Drop a partly streamed request (its prefill worker died, or
        the router resubmitted it): free its installed pages, release
        its held frames.  Returns the pages freed."""
        st = self._staged.pop(rid, None)
        if st is None:
            return 0
        if st.installed:
            self.engine.cache.free(st.installed)
        for _, bufs in st.held:
            _release(bufs)
        return len(st.installed)

    @property
    def staged_rids(self):
        return list(self._staged)
