"""Port parity: the shared-prefix cache of ``mxnet_tpu_torch.serving``
(``prefix_cache.py``, the engine's ``prefix_cache=True``) against the
reference's, on the CPU at the tiny config of tests/test_serving.py.

Twins of ``tests/test_serving_cluster.py``'s engine-level tests (prefix
hits exact with refcounts back to 0, copy-on-write leaving the shared
page untouched, refcounts after a forced retire, eviction under pool
pressure, prefix with preemption): every f32 greedy output equals the
reference ``generate`` and the reference engine run with the same
options, the schedule-determined stats (``ENGINE_STATS``, with
``prefix_hit_tokens`` and ``cow_copies``) are equal, and no page or ref
is left over.  The trie itself is held against the reference's
``PrefixCache`` on a host-only allocator, and the allocator's
``pressure_cb`` and whole-page copy are checked.

The ``cuda`` test holds the captured engine against the same engine
run op by op on the card, token for token (no JAX there: it imports
none)."""
from collections import deque

import numpy as np
import pytest
import torch

from _torch_port import (assert_no_leak, assert_same_engines, configs,
                         cuda_device, numpy_params, port_engine, quantized,
                         ref_engine, ref_generate, run_both)  # noqa: F401


def _setup(seed=3):
    jcfg, tcfg = configs()
    return jcfg, tcfg, numpy_params(jcfg, seed)


def _check_generate(tree, jcfg, eng, cases, rids):
    for rid, c in zip(rids, cases):
        np.testing.assert_array_equal(
            eng.requests[rid].output, ref_generate(tree, jcfg, c[0], c[1]))


def test_prefix_hits_exact_and_refcounts_zero():
    """Shared-prefix requests skip prefill rows via cached pages, decode
    token-identically, and leave every refcount at zero with the pages
    in use exactly the cache-owned ones."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 90, 12).astype(np.int32)
    cases = [(np.concatenate([shared, rng.randint(1, 90, 2 + i)
                              .astype(np.int32)]), 6 + i) for i in range(5)]
    ref, eng, rids = run_both(tree, jcfg, tcfg, cases, num_slots=3,
                              page_size=4, prefill_chunk=6,
                              prefix_cache=True)
    assert_same_engines(ref, eng, rids)
    _check_generate(tree, jcfg, eng, cases, rids)
    assert eng.stats["prefix_hit_tokens"] > 0
    assert eng.prefix.cached_pages == ref.prefix.cached_pages > 0
    assert eng.prefix.pages_inserted_total == \
        ref.prefix.pages_inserted_total


def test_cow_divergence_exact_and_shared_page_untouched():
    """A request diverging inside a cached page, and one submitting the
    whole cached input again, decode exactly; the private page holds the
    shared page's rows after the copy; the SHARED page's contents are
    unchanged afterwards (the writes went to the private copies)."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(1)
    eng = port_engine(tree, tcfg, num_slots=2, page_size=4,
                      prefill_chunk=8, prefix_cache=True)
    pa = rng.randint(1, 90, 16).astype(np.int32)   # 4 full pages
    ra = eng.submit(pa, 8)
    outs = eng.run()
    np.testing.assert_array_equal(outs[ra], ref_generate(tree, jcfg, pa, 8))
    assert eng.prefix.cached_pages == 4
    entries, pages, m = eng.prefix.match(pa)
    eng.prefix.release(entries)
    assert m == 16 and len(pages) == 4
    last_pg = pages[-1]
    snap = [pool["kv"][last_pg].clone() for pool in eng.cache.pools]

    rb = eng.submit(pa, 8)                 # whole-input match: COW page 3
    eng.step()
    priv = eng.requests[rb].pages[3]
    assert priv != last_pg and last_pg not in eng.requests[rb].pages
    for pool in eng.cache.pools:           # rows 12-14 copied, 15 its own
        assert torch.equal(pool["kv"][priv][:3], pool["kv"][last_pg][:3])
    pc = np.concatenate([pa[:14], rng.randint(90, 120, 4).astype(np.int32)])
    rc = eng.submit(pc, 8)                 # diverges inside page 3
    outs = eng.run()
    np.testing.assert_array_equal(outs[rb], ref_generate(tree, jcfg, pa, 8))
    np.testing.assert_array_equal(outs[rc], ref_generate(tree, jcfg, pc, 8))
    assert eng.stats["cow_copies"] == 2
    for layer, pool in enumerate(eng.cache.pools):
        assert torch.equal(pool["kv"][last_pg], snap[layer])
    assert eng.prefix.refs_total == 0


def test_prefix_refcounts_after_forced_retire():
    """A cancel mid-flight drops the request's refs; the chain survives
    at refcount 0 and the same prompt then HITS it, exactly."""
    jcfg, tcfg, tree = _setup(7)
    rng = np.random.RandomState(2)
    eng = port_engine(tree, tcfg, num_slots=2, page_size=4,
                      pages_per_slot=5, num_pages=8, prefill_chunk=8,
                      prefix_cache=True)
    pa = rng.randint(1, 90, 8).astype(np.int32)
    ra = eng.submit(pa, 12)
    for _ in range(5):
        eng.step()
    req_a = eng.requests[ra]
    assert req_a.state == "running" and req_a.generated
    assert req_a.shared_pages, "prompt pages should be donated by now"
    eng.cancel(ra)
    assert_no_leak(eng)
    rb = eng.submit(pa, 12)
    outs = eng.run()
    assert eng.requests[rb].prefix_hit_tokens > 0
    np.testing.assert_array_equal(outs[rb], ref_generate(tree, jcfg, pa, 12))
    assert_no_leak(eng)


def test_prefix_eviction_under_pressure_exact():
    """A pool too small for live traffic plus cached chains evicts
    refcount-0 chains, as the reference does, and stays exact."""
    jcfg, tcfg, tree = _setup(7)
    rng = np.random.RandomState(2)
    pa = rng.randint(1, 90, 8).astype(np.int32)
    pb = rng.randint(90, 120, 7).astype(np.int32)
    kw = dict(num_slots=2, page_size=4, pages_per_slot=5, num_pages=6,
              prefill_chunk=8, prefix_cache=True)
    engines = []
    for make, cfg in ((ref_engine, jcfg), (port_engine, tcfg)):
        eng = make(tree, cfg, **kw)
        ra = eng.submit(pa, 12)
        eng.run()
        assert eng.prefix.cached_pages > 0
        rb = eng.submit(pb, 12)             # needs the whole pool
        eng.run()
        engines.append(eng)
    ref, eng = engines
    assert_same_engines(ref, eng, [ra, rb])
    _check_generate(tree, jcfg, eng, [(pa, 12), (pb, 12)], [ra, rb])
    assert eng.prefix.pages_evicted_total == \
        ref.prefix.pages_evicted_total > 0


def test_prefix_with_preemption_exact():
    """Prefix cache with youngest-preempt recompute on an over-committed
    pool: every output exact, refs drained, stats as the reference's."""
    jcfg, tcfg, tree = _setup(9)
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 90, 8).astype(np.int32)
    cases = [(np.concatenate([shared[:4 + i],
                              rng.randint(1, 90, 2).astype(np.int32)]), n)
             for i, n in enumerate((20, 24, 16, 22, 18))]
    ref, eng, rids = run_both(tree, jcfg, tcfg, cases, num_slots=4,
                              page_size=4, pages_per_slot=8, num_pages=12,
                              prefill_chunk=4, prefix_cache=True)
    assert eng.stats["preemptions"] > 0
    assert_same_engines(ref, eng, rids)
    _check_generate(tree, jcfg, eng, cases, rids)


@pytest.mark.parametrize("w8,kv_int8", [(True, False), (False, True)])
def test_prefix_weight_and_kv_formats(w8, kv_int8):
    """Weight-only int8 params and int8 KV pages (scale planes copied on
    write too): the same stats as the reference engine, the same tokens
    (int8 KV: greedy agreement >= 0.9, the reference engine's bar)."""
    jcfg, tcfg, tree = _setup(11)
    if w8:
        tree = quantized(tree)
    rng = np.random.RandomState(4)
    shared = rng.randint(1, 90, 10).astype(np.int32)
    cases = [(np.concatenate([shared, rng.randint(1, 90, 3)
                              .astype(np.int32)]), 8) for _ in range(3)]
    cases.append((cases[0][0], 8))        # whole-input match: a COW
    ref, eng, rids = run_both(tree, jcfg, tcfg, cases, num_slots=2,
                              page_size=4, prefill_chunk=8,
                              prefix_cache=True, kv_int8=kv_int8)
    assert_same_engines(ref, eng, rids, agreement=0.9 if kv_int8 else None)
    assert eng.stats["cow_copies"] > 0


# ------------------------------------------------------ host structures --
class _Pool:
    """A host-only page allocator with a pressure hook (the tries need
    no device pools)."""

    def __init__(self, n, ps):
        self.page_size = ps
        self._free = deque(range(1, n))
        self.pressure_cb = None

    def alloc(self, k):
        if k > len(self._free) and self.pressure_cb is not None:
            self.pressure_cb(k - len(self._free))
        if k > len(self._free):
            return None
        return [self._free.popleft() for _ in range(k)]

    def free(self, pages):
        self._free.extend(pages)


def test_chain_keys_equal_reference():
    from mxnet_tpu.serving.prefix_cache import chain_keys as ref_keys
    from mxnet_tpu_torch.serving.prefix_cache import chain_keys
    rng = np.random.RandomState(5)
    for n in (0, 3, 8, 17):
        toks = rng.randint(1, 1000, n)
        assert chain_keys(toks, 4) == ref_keys(toks, 4)


def test_trie_matches_reference_trie():
    """One script of inserts, matches (full, partial, miss), releases and
    pressure evictions through the reference ``PrefixCache`` and the
    port's, each over its own host allocator: the same pages, matched
    token counts, refcounts, evictions and free lists."""
    from mxnet_tpu.serving.prefix_cache import PrefixCache as RefPC
    from mxnet_tpu_torch.serving.prefix_cache import PrefixCache
    rng = np.random.RandomState(6)
    ps = 4
    base = rng.randint(1, 50, 12).astype(np.int32)
    prompts = [base, np.concatenate([base[:9], [77, 78, 79]]),
               np.concatenate([base[:4], rng.randint(1, 50, 8)]),
               rng.randint(1, 50, 10)]
    logs = []
    for cls in (RefPC, PrefixCache):
        pool = _Pool(20, ps)
        pc = cls(pool)
        pool.pressure_cb = pc.evict
        log = []
        held = []
        for i, p in enumerate(prompts):
            entries, pages, m = pc.match(p)
            log.append(("match", i, pages, m))
            own = pool.alloc(-(-p.size // ps) - len(pages))
            chain = list(pages) + own
            new = pc.insert_chain(p, chain, p.size // ps,
                                  from_page=len(entries))
            log.append(("insert", i, [(j, e.page) for j, e in new]))
            held.append(entries + [e for _, e in new])
        for entries in held[:2]:
            pc.release(entries)
        log.append(("refs", pc.refs_total, pc.cached_pages))
        got = pool.alloc(len(pool._free) + 3)       # forces evictions
        log.append(("pressure", got, pc.pages_evicted_total,
                    pc.cached_pages))
        for entries in held[2:]:
            pc.release(entries)
        pc.clear()
        log.append(("clear", pc.cached_pages, sorted(pool._free)))
        logs.append(log)
    assert logs[0] == logs[1]


def test_pressure_cb_and_copy_page():
    """``alloc`` asks ``pressure_cb`` for the shortfall before refusing;
    ``copy_page`` copies every layer's kv (and int8 scale) page in place,
    keeping the pools' storage."""
    from mxnet_tpu_torch.serving import PagedKVCache
    _, tcfg = configs()
    cache = PagedKVCache(tcfg, num_pages=5, page_size=4, kv_int8=True,
                         device="cpu")
    asked = []

    def cb(n):
        asked.append(n)
        cache.free(held[:n])
        del held[:n]

    held = cache.alloc(4)
    assert cache.alloc(1) is None
    cache.pressure_cb = cb
    assert cache.alloc(2) is not None and asked == [2]
    ptrs = [(p["kv"].data_ptr(), p["s"].data_ptr()) for p in cache.pools]
    for p in cache.pools:
        p["kv"][2] = torch.randint(-100, 100, p["kv"][2].shape,
                                   dtype=torch.int8)
        p["s"][2] = torch.rand(p["s"][2].shape)
    cache.copy_page(2, 4)
    for p, ptr in zip(cache.pools, ptrs):
        assert (p["kv"].data_ptr(), p["s"].data_ptr()) == ptr
        assert torch.equal(p["kv"][4], p["kv"][2])
        assert torch.equal(p["s"][4], p["s"][2])


# --------------------------------------------------------------- on card --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_prefix_captured_equals_eager(cuda_device, dtype):
    """On the card, the captured engine with the prefix cache (hits,
    copy-on-write, pressure eviction) gives the tokens and stats of the
    same engine run op by op, bit for bit."""
    from mxnet_tpu_torch.models import gpt as G
    cfg = G.gpt_tiny(dtype=dtype, vocab_size=128, max_len=64, dropout=0.0)
    params = G.init_params(3, cfg, device="cpu")
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 90, 12)
    cases = [(np.concatenate([shared, rng.randint(1, 90, 2 + i)]), 6 + i)
             for i in range(6)] + [(shared, 8), (shared[:10], 8)]
    runs = []
    for eager in (True, False):
        from mxnet_tpu_torch.serving import ServingEngine
        eng = ServingEngine(params, cfg, num_slots=3, page_size=4,
                            num_pages=14, pages_per_slot=8,
                            prefill_chunk=6, prefix_cache=True,
                            device=cuda_device)
        eng._eager = eager
        rids = [eng.submit(p, n) for p, n in cases]
        outs = eng.run()
        assert_no_leak(eng)
        runs.append(([outs[r].tolist() for r in rids], dict(eng.stats)))
    assert runs[0] == runs[1]
    assert runs[1][1]["cow_copies"] > 0
    assert runs[1][1]["prefix_hit_tokens"] > 0
