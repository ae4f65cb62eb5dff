"""Refcounted shared-prefix KV page reuse for ``PagedKVCache``.  Port
of ``mxnet_tpu/serving/prefix_cache.py`` (pure Python and numpy; the
port keeps its own copy) without its host tier and cluster index.

Real serving traffic shares prompt prefixes (system prompts, few-shot
headers).  The k/v content of a page is a function of the token prefix
ending at that page alone — position ``t``'s k/v depends on tokens
``0..t`` and nothing else — so pages computed for one request are valid
for any other request whose prompt starts with the same tokens (the
argument that makes preemption recompute-exact: one step program,
per-row arithmetic).

The cache is a **trie of page entries** keyed by token content, never
by hash alone: an entry's dict key is ``(parent_entry_id,
token_block_bytes)``, so a lookup compares the actual tokens.  Entry
``j`` of a chain holds the page covering positions ``[j*page_size,
(j+1)*page_size)`` of every prompt that reaches it.

Ownership and refcounts:

* A request whose prompt **matches** a chain maps those pages
  read-only into its block table and takes one ref per entry.
* A request that **completes prefill** of a page fully covered by its
  prompt donates it: the cache owns the page from then on and the
  request keeps using it under a ref.
* ``release()`` (retire, cancel, preempt) drops refs.  A refcount-0
  entry STAYS cached until **pool pressure** evicts it:
  ``PagedKVCache.alloc`` calls the pressure callback when the free
  list runs short, and the cache frees LRU refcount-0 *leaf* entries
  (children before parents, so a cached chain is always contiguous
  from the root) back to the pool.

Copy-on-write: matching is capped so a request always re-feeds at
least its final prompt token (the step needs one live row to produce
logits), and a partially-matched page is mapped read-only up to the
first divergent token.  In both cases the first position the request
must WRITE can fall inside a mapped page; the engine then copies that
page on the device into a private one before any row targets it
(``PagedKVCache.copy_page``), so a shared page is never written.

The engine counts hits and copies in its ``stats``; the trie counts the
pages it took in and evicted.  The reference's host-DRAM tier
(``tier=``, spill and warm restore), its ``ClusterPrefixIndex`` and the
lookup counters its metrics layer reads are not ported.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache", "chain_keys"]

_ROOT_ID = 0


def chain_keys(tokens, page_size: int) -> List[bytes]:
    """Content keys of the full pages covering ``tokens``: one bytes key
    per page, each folding in the whole prefix through that page, so two
    prompts share a key iff they share the prefix through that page."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    out: List[bytes] = []
    prev = b""
    for j in range(tokens.size // page_size):
        prev = prev + tokens[j * page_size:(j + 1) * page_size].tobytes()
        out.append(prev)
    return out


class _Entry:
    __slots__ = ("eid", "parent", "block", "page", "refs", "nchildren",
                 "tick")

    def __init__(self, eid, parent, block, page):
        self.eid = eid
        self.parent: Optional["_Entry"] = parent
        self.block = block            # token block bytes (page_size int32)
        self.page = page
        self.refs = 0
        self.nchildren = 0
        self.tick = 0

    def __repr__(self):
        return "_Entry(eid=%d page=%d refs=%d kids=%d)" % (
            self.eid, self.page, self.refs, self.nchildren)


class PrefixCache:
    """Shared-prefix page trie over one ``PagedKVCache``.  Not
    thread-safe by itself: the engine calls it under its lock."""

    def __init__(self, cache, page_size: Optional[int] = None):
        self.cache = cache
        self.page_size = page_size or cache.page_size
        # (parent_eid, block_bytes) -> _Entry
        self._by_key: Dict[Tuple[int, bytes], _Entry] = {}
        # parent_eid -> {block_bytes: _Entry} (for partial-prefix match)
        self._children: Dict[int, Dict[bytes, _Entry]] = {}
        self._eid = itertools.count(_ROOT_ID + 1)
        self._tick = itertools.count(1)
        self.pages_inserted_total = 0
        self.pages_evicted_total = 0

    # ------------------------------------------------------ queries --
    @property
    def cached_pages(self) -> int:
        return len(self._by_key)

    @property
    def refs_total(self) -> int:
        return sum(e.refs for e in self._by_key.values())

    # -------------------------------------------------------- match --
    def match(self, tokens) -> Tuple[List[_Entry], List[int], int]:
        """Longest cached chain for ``tokens``: full pages while the
        trie matches, then at most one partially-matching child (its
        page is valid through the last common token; the engine copies
        it before writing the first divergent one).  Takes one ref per
        returned entry; the caller owns them until ``release()``.

        Returns ``(entries, pages, matched_tokens)``."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        entries: List[_Entry] = []
        pages: List[int] = []
        m = 0
        parent_id = _ROOT_ID
        while m + ps <= tokens.size:
            e = self._by_key.get((parent_id, tokens[m:m + ps].tobytes()))
            if e is None:
                break
            e.refs += 1
            entries.append(e)
            pages.append(e.page)
            m += ps
            parent_id = e.eid
        # partial page: the child sharing the longest token prefix with
        # the remainder (ties broken by insertion order)
        rem = tokens[m:]
        if rem.size > 0:
            best, best_n = None, 0
            for e in self._children.get(parent_id, {}).values():
                blk = np.frombuffer(e.block, np.int32)
                k = min(blk.size, rem.size)
                n = int((blk[:k] == rem[:k]).cumprod().sum())
                if n > best_n:
                    best, best_n = e, n
            if best is not None:
                best.refs += 1
                entries.append(best)
                pages.append(best.page)
                m += best_n
        tick = next(self._tick)
        for e in entries:
            e.tick = tick
        return entries, pages, m

    def release(self, entries: List[_Entry]):
        for e in entries:
            if e.refs <= 0:
                raise RuntimeError("PrefixCache: ref underflow on %r" % (e,))
            e.refs -= 1

    # ------------------------------------------------------- insert --
    def insert_chain(self, tokens, pages: List[int], upto_page: int,
                     from_page: int = 0) -> List[Tuple[int, _Entry]]:
        """Donate ``pages[from_page:upto_page]`` (the caller's privately
        owned, fully written prompt pages) to the cache.

        Walks the trie along ``tokens`` from the root.  For page j: an
        entry backed by OUR page is already chained (ref held), walk
        through; an entry backed by someone else's equivalent page means
        the content is cached already, so our page stays private but
        the walk continues under that entry; no entry means we create
        one owning our page (refs=1, the caller's) and report it.

        Returns the new ``(page_index, entry)`` pairs; the caller marks
        those pages shared and holds the refs."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        if upto_page * ps > tokens.size:
            raise ValueError("insert_chain: %d pages exceed %d tokens"
                             % (upto_page, tokens.size))
        out: List[Tuple[int, _Entry]] = []
        parent_id = _ROOT_ID
        parent: Optional[_Entry] = None
        for j in range(upto_page):
            blk = tokens[j * ps:(j + 1) * ps].tobytes()
            key = (parent_id, blk)
            e = self._by_key.get(key)
            if e is None:
                if j < from_page:
                    # the head of the chain is not cached (evicted while
                    # this request ran): grafting page j under a missing
                    # parent would orphan it
                    return out
                e = _Entry(next(self._eid), parent, blk, pages[j])
                e.refs = 1                  # the donating caller's ref
                e.tick = next(self._tick)
                self._by_key[key] = e
                self._children.setdefault(parent_id, {})[blk] = e
                if parent is not None:
                    parent.nchildren += 1
                self.pages_inserted_total += 1
                out.append((j, e))
            parent_id = e.eid
            parent = e
        return out

    # ----------------------------------------------------- eviction --
    def evict(self, n: int) -> int:
        """Free up to ``n`` pages back to the pool by retiring LRU
        refcount-0 leaf entries (the ``PagedKVCache`` pressure
        callback).  Returns how many pages were freed.  A linear scan
        per page: entries are bounded by the pool, and this runs only
        when an allocation would otherwise fail."""
        freed = 0
        while freed < n:
            victim = None
            for e in self._by_key.values():
                if e.refs == 0 and e.nchildren == 0 and (
                        victim is None or e.tick < victim.tick):
                    victim = e
            if victim is None:
                break
            self._drop(victim)
            freed += 1
        return freed

    def _drop(self, e: _Entry):
        """Remove one refcount-0 leaf entry from the trie and return its
        page to the pool."""
        parent_id = e.parent.eid if e.parent is not None else _ROOT_ID
        del self._by_key[(parent_id, e.block)]
        kids = self._children.get(parent_id)
        if kids is not None:
            kids.pop(e.block, None)
            if not kids:
                del self._children[parent_id]
        if e.parent is not None:
            e.parent.nchildren -= 1
        self.cache.free([e.page])
        self.pages_evicted_total += 1

    def clear(self):
        """Drop every refcount-0 chain (leaf first); entries still
        referenced by running requests survive."""
        while self.evict(len(self._by_key)):
            pass
