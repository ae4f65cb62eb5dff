"""Refcounted shared-prefix KV page reuse for ``PagedKVCache``, with
the host-DRAM tier.  Port of ``mxnet_tpu/serving/prefix_cache.py``
(pure Python and numpy; the port keeps its own copy), with the
router's ``ClusterPrefixIndex`` of the disaggregated cluster.

Real serving traffic shares prompt prefixes (system prompts, few-shot
headers).  The k/v content of a page is a function of the token prefix
ending at that page alone: position ``t``'s k/v depends on tokens
``0..t`` and nothing else, so pages computed for one request are valid
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

KV tiering: with a ``tier_store.HostTierStore`` attached (``tier=``),
pressure eviction SPILLS a refcount-0 entry's exact pool bytes to host
memory instead of dropping them (the page returns to the free list,
the content survives), and ``match`` gains a **warm hit** between hot
hit and miss: a chain whose tail (or whole body) was spilled is
installed again and the walk continues as if it had never left.  Spill
order is the eviction order (LRU refcount-0 leaves first), so the
spilled set is always a contiguous chain TAIL and a warm restore can
always re-link under its still-hot (or just restored) parent.  A
spilled entry leaves the trie dicts; its reachability lives in
``_spilled`` (cumulative chain key -> token block) and
``_spilled_children`` (parent key -> child keys), so a tier LRU
eviction of one spilled page drops exactly its unreachable spilled
descendants (``_on_tier_evict``).

Telemetry is plain ints bumped on the host path (``hit_tokens_total``
...), folded into the engine's ``MetricsRegistry`` as deltas by
``_EngineObs.sync_prefix``.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

__all__ = ["PrefixCache", "ClusterPrefixIndex", "chain_keys"]

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

    def __init__(self, cache, page_size: Optional[int] = None,
                 tier=None):
        self.cache = cache
        self.page_size = page_size or cache.page_size
        # (parent_eid, block_bytes) -> _Entry
        self._by_key: Dict[Tuple[int, bytes], _Entry] = {}
        # parent_eid -> {block_bytes: _Entry} (for partial-prefix match)
        self._children: Dict[int, Dict[bytes, _Entry]] = {}
        self._eid = itertools.count(_ROOT_ID + 1)
        self._tick = itertools.count(1)
        # host-DRAM page tier: pressure eviction spills refcount-0
        # chains here instead of dropping them; match() restores
        # spilled tails as warm hits.  None: drop on pressure, as
        # without a tier, bit for bit.
        self.tier = tier
        # cumulative chain key -> token block bytes of every SPILLED
        # entry (reachability model of the host-tier content), plus
        # the parent-key -> child-keys edges a tier eviction needs to
        # drop exactly the unreachable descendants
        self._spilled: Dict[bytes, bytes] = {}
        self._spilled_children: Dict[bytes, Set[bytes]] = {}
        if tier is not None:
            tier.evict_cb = self._on_tier_evict
        # telemetry (host ints, delta-folded into the obs registry)
        self.lookups_total = 0
        self.lookup_tokens_total = 0
        self.hit_tokens_total = 0
        self.pages_hit_total = 0
        self.pages_inserted_total = 0
        self.pages_evicted_total = 0
        self.cow_total = 0
        # tier movement (zero when tier is None)
        self.pages_spilled_total = 0
        self.pages_restored_total = 0
        self.warm_hits_total = 0
        self.warm_hit_tokens_total = 0
        # optional eviction hook, called with the dropped entry's
        # cumulative chain key when its content is really gone (spill
        # refused, or tier LRU eviction); a spill or restore reports
        # through tier_cb instead (the content is one install away)
        self.evict_cb = None
        # optional tier-transition hook: tier_cb(chain_key,
        # "host"|"hbm") on spill and restore
        self.tier_cb = None

    # ------------------------------------------------------ queries --
    @property
    def cached_pages(self) -> int:
        return len(self._by_key)

    @property
    def refs_total(self) -> int:
        return sum(e.refs for e in self._by_key.values())

    @property
    def evictable_pages(self) -> int:
        return sum(1 for e in self._by_key.values()
                   if e.refs == 0 and e.nchildren == 0)

    @property
    def spilled_pages(self) -> int:
        """Chain entries currently living in the host tier (their
        pool pages are freed; their bytes are one install away)."""
        return len(self._spilled)

    # -------------------------------------------------------- match --
    def match(self, tokens,
              restore: bool = True) -> Tuple[List[_Entry], List[int],
                                             int]:
        """Longest cached chain for ``tokens``: full pages while the
        trie matches, then — with a tier attached and ``restore=True``
        — the consecutive SPILLED continuation re-installed from host
        DRAM (the warm hit), then at most one partially-matching child
        (its page is valid through the last common token — the engine
        COWs it before writing the first divergent one).  Takes one
        ref per returned entry; the caller owns them until
        ``release()``.  ``restore=False`` walks hot entries only and
        never allocates.

        Refs are taken AS the walk appends (not in one batch at the
        end): the restore path allocates pool pages, and that
        allocation's pressure callback evicts refcount-0 entries — an
        already-matched entry must be pinned before the walk can
        trigger pressure, or its page could be recycled out of the
        returned chain.

        Returns ``(entries, pages, matched_tokens)``.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        entries: List[_Entry] = []
        pages: List[int] = []
        m = 0
        parent_id = _ROOT_ID
        parent: Optional[_Entry] = None
        while m + ps <= tokens.size:
            e = self._by_key.get(
                (parent_id, tokens[m:m + ps].tobytes()))
            if e is None:
                break
            e.refs += 1
            entries.append(e)
            pages.append(e.page)
            m += ps
            parent_id = e.eid
            parent = e
        if restore and self.tier is not None:
            try:
                restored = self._restore_run(tokens, m, parent)
            except BaseException:
                # the restore's alloc can raise through the pressure
                # callback (the edge the engine's _admit guards too):
                # the refs this walk already took must not leak, or the
                # chain stays pinned unevictable for the engine's life
                self.release(entries)
                raise
            for e in restored:
                e.refs += 1
                entries.append(e)
                pages.append(e.page)
                m += ps
                parent_id = e.eid
                parent = e
            if restored:
                self.warm_hits_total += 1
                self.warm_hit_tokens_total += len(restored) * ps
        # partial page: the child sharing the longest token prefix
        # with the remainder (ties broken arbitrarily).  Spilled
        # siblings are not consulted here — warm hits are whole-page
        # granularity (a partial page would be COWed right back into
        # private state, paying an install for at most ps-1 tokens).
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
        self.lookups_total += 1
        return entries, pages, m

    def _spilled_run(self, tokens, m: int) -> List[bytes]:
        """Cumulative chain keys of the consecutive spilled entries
        continuing ``tokens`` from token offset ``m`` (a multiple of
        page_size — the end of the hot walk)."""
        ps = self.page_size
        run: List[bytes] = []
        key = tokens[:m].tobytes()
        while m + ps <= tokens.size:
            key = key + tokens[m:m + ps].tobytes()
            if key not in self._spilled:
                break
            run.append(key)
            m += ps
        return run

    def _restore_run(self, tokens, m: int,
                     parent: Optional[_Entry]) -> List[_Entry]:
        """Warm hit: re-install the consecutive spilled continuation
        of the hot walk (token offset ``m``, last hot entry
        ``parent``) from the host tier into freshly-allocated pool
        pages, re-linking the entries into the trie.  One install
        (one scatter a pool, in place) covers the whole run.  Degrades page by
        page: the pool may not cover the full run (alloc shrinks it),
        and a key the tier LRU-evicted mid-flight truncates it —
        either way the caller simply matches less."""
        run = self._spilled_run(tokens, m)
        if not run:
            return []
        got = None
        while run:
            got = self.cache.alloc(len(run))
            if got is not None:
                break
            run.pop()
        if not run:
            return []
        contents = []
        for key in run:
            e = self.tier.pop(("prefix", key))
            if e is None:
                break                     # evicted mid-flight: truncate
            contents.append(e.content)
        if len(contents) < len(run):
            self.cache.free(got[len(contents):])
            got = got[:len(contents)]
            run = run[:len(contents)]
            if not run:
                return []
        try:
            self.cache.install_pages(got, contents)
        except BaseException:
            # the popped tier bytes are gone and the pool pages were
            # never filled: give the pages back and retire the popped
            # keys' reachability records (same semantics as a tier
            # eviction — their descendants are unreachable too)
            self.cache.free(got)
            for key in run:
                self._on_tier_evict(("prefix", key))
            raise
        out: List[_Entry] = []
        ps = self.page_size
        for key, page in zip(run, got):
            blk = self._spilled.pop(key)
            parent_key = key[:-4 * ps]
            kids = self._spilled_children.get(parent_key)
            if kids is not None:
                kids.discard(key)
                if not kids:
                    del self._spilled_children[parent_key]
            parent_id = parent.eid if parent is not None else _ROOT_ID
            e = _Entry(next(self._eid), parent, blk, page)
            e.tick = next(self._tick)
            self._by_key[(parent_id, blk)] = e
            self._children.setdefault(parent_id, {})[blk] = e
            if parent is not None:
                parent.nchildren += 1
            out.append(e)
            parent = e
            self.pages_restored_total += 1
            if self.tier_cb is not None:
                self.tier_cb(key, "hbm")
        return out

    def probe_depth(self, tokens) -> Tuple[int, int]:
        """Non-mutating depth probe: ``(hot_pages, warm_pages)`` of
        the chain covering ``tokens``: hot entries in the trie plus
        the consecutive spilled continuation in the host tier.  Takes
        no refs, restores nothing, allocates nothing."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        m = 0
        parent_id = _ROOT_ID
        while m + ps <= tokens.size:
            e = self._by_key.get(
                (parent_id, tokens[m:m + ps].tobytes()))
            if e is None:
                break
            m += ps
            parent_id = e.eid
        hot = m // ps
        warm = len(self._spilled_run(tokens, m)) \
            if self.tier is not None else 0
        return hot, warm

    def spilled_content(self, tokens, from_page: int) -> List:
        """Host-tier content blocks (one ``PageContent`` a page) of the
        consecutive spilled chain continuing ``tokens`` from page index
        ``from_page``, with no pool allocation: the reference serves a
        peer's fetch of a spilled chain from these."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        out: List = []
        if self.tier is None:
            return out
        for key in self._spilled_run(tokens, from_page
                                     * self.page_size):
            e = self.tier.get(("prefix", key))
            if e is None:
                break
            out.append(e.content)
        return out

    def release(self, entries: List[_Entry]):
        for e in entries:
            if e.refs <= 0:
                raise RuntimeError(
                    "PrefixCache: ref underflow on %r" % (e,))
            e.refs -= 1

    def note_admit(self, hit_tokens: int, lookup_tokens: int,
                   pages_hit: int):
        """Record a successful admission's hit accounting (kept apart
        from match() so an admission that stalls on allocation and
        re-matches later is not double-counted)."""
        self.hit_tokens_total += hit_tokens
        self.lookup_tokens_total += lookup_tokens
        self.pages_hit_total += pages_hit

    def note_cow(self):
        self.cow_total += 1

    # ------------------------------------------------------- insert --
    def insert_chain(self, tokens, pages: List[int], upto_page: int,
                     from_page: int = 0) -> List[Tuple[int, _Entry]]:
        """Donate ``pages[from_page:upto_page]`` (the caller's
        privately-owned, fully-written prompt pages) to the cache.

        Walks the trie along ``tokens`` from the root.  For page j:
        an existing entry backed by OUR page means it is already
        chained (ref held) — walk through; an existing entry backed
        by someone else's equivalent page means the content is
        already cached — our page stays private but the walk
        continues under that entry (chains merge on content); no
        entry means we create one owning our page (refs=1, the
        caller's) and report it.

        Returns the newly-created ``(page_index, entry)`` pairs; the
        caller must mark those pages shared and hold the refs.
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        if upto_page * ps > tokens.size:
            raise ValueError("insert_chain: %d pages exceed %d tokens"
                             % (upto_page, tokens.size))
        out: List[Tuple[int, _Entry]] = []
        parent_id = _ROOT_ID
        parent: Optional[_Entry] = None
        key_acc = b""
        for j in range(upto_page):
            blk = tokens[j * ps:(j + 1) * ps].tobytes()
            key_acc = key_acc + blk
            key = (parent_id, blk)
            e = self._by_key.get(key)
            if e is None:
                if j < from_page:
                    # the head of the chain is not cached (e.g. it was
                    # evicted while this request ran) — grafting page j
                    # under a missing parent would orphan it
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
                if self._spilled.pop(key_acc, None) is not None:
                    # a freshly-donated hot page SHADOWS a spilled
                    # twin (the chain was spilled, then recomputed by a
                    # request the match could not serve warm): the warm
                    # walk would never reach the spilled copy again, so
                    # keep the hot one and release the tier bytes
                    self.tier.drop(("prefix", key_acc))
                    pk = key_acc[:-4 * ps]
                    kids = self._spilled_children.get(pk)
                    if kids is not None:
                        kids.discard(key_acc)
                        if not kids:
                            del self._spilled_children[pk]
                    if self.tier_cb is not None:
                        self.tier_cb(key_acc, "hbm")
            parent_id = e.eid
            parent = e
        return out

    # ----------------------------------------------------- eviction --
    def evict(self, n: int, spill: bool = True) -> int:
        """Free up to ``n`` pages back to the pool by retiring LRU
        refcount-0 leaf entries (the ``PagedKVCache`` pressure
        callback).  With a tier attached (and ``spill=True``) each
        victim's exact pool bytes move to host DRAM first — the page
        is reclaimed either way, but the content survives one install
        away instead of one prefill away.  Returns how many pages
        were actually freed.

        The victim search is a linear scan per page freed: entries are
        bounded by the pool, and this runs only when an allocation
        would otherwise fail."""
        freed = 0
        while freed < n:
            victim = None
            for e in self._by_key.values():
                if e.refs == 0 and e.nchildren == 0 and (
                        victim is None or e.tick < victim.tick):
                    victim = e
            if victim is None:
                break
            self._drop(victim, spill=spill)
            freed += 1
        return freed

    def spill(self, n: Optional[int] = None) -> int:
        """Proactively spill up to ``n`` (default: all) refcount-0
        chains to the host tier WITHOUT pool pressure — the benchmark
        and test hook for deterministic tier population (and an ops
        lever: pre-drain HBM ahead of an expected admission wave).
        Returns pages spilled; entries whose spill the tier refuses
        stay hot (this is not an eviction)."""
        if self.tier is None:
            return 0
        spilled = 0
        budget = len(self._by_key) if n is None else n
        while spilled < budget:
            victim = None
            for e in self._by_key.values():
                if e.refs == 0 and e.nchildren == 0 and (
                        victim is None or e.tick < victim.tick):
                    victim = e
            if victim is None or not self._spill_entry(victim):
                break
            spilled += 1
        return spilled

    def chain_key(self, e: _Entry) -> bytes:
        """The entry's cumulative content key — the same bytes
        :func:`chain_keys` would produce for its page position, built
        by walking the parent chain (root block first)."""
        blocks = []
        node: Optional[_Entry] = e
        while node is not None:
            blocks.append(node.block)
            node = node.parent
        return b"".join(reversed(blocks))

    def _unlink(self, e: _Entry):
        """Remove ``e`` from the trie dicts and return its page to
        the pool (shared by the drop and spill paths)."""
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

    def _spill_entry(self, e: _Entry) -> bool:
        """Move one refcount-0 leaf entry's page to the host tier:
        export the exact pool bytes, record reachability, unlink, free
        the page.  The export MUST be asked for before the free: the
        freed page re-enters the pool at once and the very allocation
        whose pressure triggered this spill will write new content
        into it (the reference's ``_drop`` ordering; the cache runs
        its transfers in the order asked, before the step that
        writes)."""
        if self.tier is None:
            return False
        if self.cache.bytes_per_page > self.tier.budget_bytes:
            # the tier would refuse anyway: skip the export (this runs
            # inside the pressure callback; a wasted export here prices
            # every allocation under pressure)
            return False
        key = self.chain_key(e)
        content = self.cache.export_pages([e.page])
        if not self.tier.put(("prefix", key), content, 1):
            return False
        self._spilled[key] = e.block
        parent_key = key[:-4 * self.page_size]
        self._spilled_children.setdefault(parent_key, set()).add(key)
        self._unlink(e)
        self.pages_spilled_total += 1
        if self.tier_cb is not None:
            self.tier_cb(key, "host")
        return True

    def _drop(self, e: _Entry, spill: bool = True):
        """Retire one refcount-0 leaf entry under pressure: spill to
        the host tier when possible, hard-drop otherwise.  Any page
        BYTES the tier is to keep are captured before
        ``cache.free`` reclaims the page (see ``_spill_entry``); the
        eviction report — keys only, host state — goes out last."""
        if spill and self._spill_entry(e):
            return
        key = self.chain_key(e)
        self._unlink(e)
        self.pages_evicted_total += 1
        # content really gone: unreachable spilled descendants (their
        # restore path walks through this entry) go with it
        self._drop_spilled_subtree(key)
        if self.evict_cb is not None:
            self.evict_cb(key)

    def _drop_spilled_subtree(self, key: bytes):
        """Drop every spilled descendant of chain ``key`` (the parent
        content is gone, so no walk can ever reach them again),
        reporting each as a real eviction."""
        stack = list(self._spilled_children.pop(key, ()))
        while stack:
            k = stack.pop()
            if self._spilled.pop(k, None) is None:
                continue
            self.tier.drop(("prefix", k))
            self.pages_evicted_total += 1
            if self.evict_cb is not None:
                self.evict_cb(k)
            stack.extend(self._spilled_children.pop(k, ()))

    def _on_tier_evict(self, tier_key):
        """The host tier LRU-dropped an entry.  Prefix keys lose
        their reachability record and their (now-unreachable) spilled
        descendants; swap keys need nothing — the engine's resume
        path checks existence and falls back to recompute."""
        if not (isinstance(tier_key, tuple) and len(tier_key) == 2
                and tier_key[0] == "prefix"):
            return
        key = tier_key[1]
        if self._spilled.pop(key, None) is None:
            return
        parent_key = key[:-4 * self.page_size]
        kids = self._spilled_children.get(parent_key)
        if kids is not None:
            kids.discard(key)
            if not kids:
                self._spilled_children.pop(parent_key, None)
        self.pages_evicted_total += 1
        if self.evict_cb is not None:
            self.evict_cb(key)
        self._drop_spilled_subtree(key)

    def clear(self):
        """Drop every refcount-0 chain (leaf first) AND every spilled
        record; entries still referenced by running requests survive.
        Never spills: teardown returns pool pages, it does not turn
        them into host-tier churn (an export a page nobody reads)."""
        while self.evict(len(self._by_key), spill=False):
            pass
        for key in list(self._spilled):
            self._spilled.pop(key, None)
            if self.tier is not None:
                self.tier.drop(("prefix", key))
            self.pages_evicted_total += 1
            if self.evict_cb is not None:
                self.evict_cb(key)
        self._spilled_children.clear()


class ClusterPrefixIndex:
    """The disaggregated router's cluster-level prefix index: which
    worker holds the pages of each content chain key.

    First inserter wins: a key's owner is the worker that computed the
    chain (later workers fetch copies; the index keeps pointing at one
    source, so "prefilled once per cluster" is a claim the counters can
    check).  An eviction removes a key only when its reporter owns it; a
    dead worker's keys drop at once.  Each key carries the tier of the
    owner's copy: ``"hbm"`` in its device pool, ``"host"`` spilled to
    its host-DRAM tier (still fetchable, served without device work).
    Thread-safe: the router's receive threads all report here."""

    def __init__(self, capacity: int = 65536):
        self._mu = threading.Lock()
        self._owner: Dict[bytes, str] = {}
        self._by_owner: Dict[str, Set[bytes]] = {}
        self._tier: Dict[bytes, str] = {}
        self._cap = int(capacity)
        self.keys_inserted_total = 0
        self.keys_evicted_total = 0
        self.keys_retagged_total = 0
        self.hints_total = 0

    def __len__(self):
        with self._mu:
            return len(self._owner)

    def match(self, keys: List[bytes]) -> Tuple[Optional[str], int,
                                                Optional[str]]:
        """The longest head of ``keys`` held by ONE worker: ``(owner,
        depth_pages, tier)``, or ``(None, 0, None)`` on a cold prefix.
        ``tier`` is ``"hbm"`` when every matched key is in the owner's
        pool, ``"host"`` when any page comes off its host tier."""
        with self._mu:
            owner = self._owner.get(keys[0]) if keys else None
            if owner is None:
                return None, 0, None
            tier = self._tier.get(keys[0], "hbm")
            d = 1
            while d < len(keys) and self._owner.get(keys[d]) == owner:
                if self._tier.get(keys[d], "hbm") == "host":
                    tier = "host"
                d += 1
            self.hints_total += 1
            return owner, d, tier

    def report_insert(self, owner: str, keys: List[bytes]):
        with self._mu:
            mine = self._by_owner.setdefault(owner, set())
            for k in keys:
                if k not in self._owner:
                    if len(self._owner) >= self._cap:
                        break             # bounded: stop indexing
                    self._owner[k] = owner
                    self._tier[k] = "hbm"   # a fresh insert was computed
                    mine.add(k)
                    self.keys_inserted_total += 1

    def report_tier(self, owner: str, keys: List[bytes], tier: str):
        """A worker moved chains between its tiers (spill: hbm → host;
        warm restore: host → hbm).  Only the owner re-tags."""
        if tier not in ("hbm", "host"):
            raise ValueError("report_tier: tier must be 'hbm' or "
                             "'host', got %r" % (tier,))
        with self._mu:
            for k in keys:
                if self._owner.get(k) == owner \
                        and self._tier.get(k) != tier:
                    self._tier[k] = tier
                    self.keys_retagged_total += 1

    def report_evict(self, owner: str, keys: List[bytes]):
        with self._mu:
            mine = self._by_owner.get(owner, set())
            for k in keys:
                if self._owner.get(k) == owner:
                    del self._owner[k]
                    self._tier.pop(k, None)
                    mine.discard(k)
                    self.keys_evicted_total += 1

    def drop_owner(self, owner: str):
        """A worker died or was drained: none of its pages exist."""
        with self._mu:
            for k in self._by_owner.pop(owner, set()):
                if self._owner.get(k) == owner:
                    del self._owner[k]
                    self._tier.pop(k, None)
