"""Port parity: the host-DRAM KV tier (``serving/tier_store.py``,
``PagedKVCache.export_pages``/``install_pages``, the prefix cache's
spill and warm restore, the engine's ``tier_bytes`` swap-out
preemption) against the reference's, on the CPU at the tiny config of
tests/test_serving.py.

Exact on both sides: ``HostTierStore`` victims, callbacks and
counters under one put/peek/get/pop/drop sequence; exported page bytes
(raw bytes of the port's content against the reference's numpy
arrays, f32 and int8 KV with its f32 scale planes) and installed
pools; tier counters, prefix counters and engine stats.  Tokens: f32
KV token-identical to the reference engine and to ``generate``; int8
KV token-identical to the same port engine with the tier off (the
tier moves exact bytes) and, against the reference engine, held to
greedy agreement >= 0.9, the int8 bar of tests/test_torch_serving.py.
Every run ends with no page, ref or tier entry left over.

The ``cuda`` tests run on the card (no JAX there: this module imports
none at the top): a warm restore and a swap-in followed by captured
steps, token-identical to the engine run op by op and to ``generate``,
and exported bytes equal on the card and the CPU."""
import numpy as np
import pytest
import torch

from _torch_port import (ENGINE_STATS, configs, cuda_device,  # noqa: F401
                         numpy_params, port_engine, ref_engine,
                         ref_generate)

TIER = 1 << 22
TIER_STATS = ENGINE_STATS + ("swap_outs", "swap_ins")
PREFIX_TOTALS = ("lookups_total", "lookup_tokens_total", "hit_tokens_total",
                 "pages_hit_total", "pages_inserted_total",
                 "pages_evicted_total", "cow_total", "pages_spilled_total",
                 "pages_restored_total", "warm_hits_total",
                 "warm_hit_tokens_total")
TIER_TOTALS = ("spilled_pages_total", "installed_pages_total",
               "bytes_moved_total", "evicted_pages_total", "evictions_total",
               "pages_held", "bytes_held")


def _base(**kw):
    base = dict(num_slots=2, page_size=4, prefill_chunk=6, pages_per_slot=8,
                prefix_cache=True, tier_bytes=TIER)
    base.update(kw)
    return base


def _setup(seed=3):
    jcfg, tcfg = configs()
    return jcfg, tcfg, numpy_params(jcfg, seed)


def _same_state(ref, eng, rids, int8=False):
    """Equal tokens (int8: agreement >= 0.9), stats, prefix and tier
    totals; nothing leaked in the port."""
    for rid in rids:
        a, b = list(ref.requests[rid].generated), \
            list(eng.requests[rid].generated)
        assert ref.requests[rid].state == eng.requests[rid].state
        if int8:
            assert len(a) == len(b) and np.mean(np.equal(a, b)) >= 0.9
        else:
            assert a == b, rid
    assert {k: eng.stats[k] for k in TIER_STATS} == \
        {k: ref.stats[k] for k in TIER_STATS}
    if eng.prefix is not None:
        assert {k: getattr(eng.prefix, k) for k in PREFIX_TOTALS} == \
            {k: getattr(ref.prefix, k) for k in PREFIX_TOTALS}
        assert eng.prefix.spilled_pages == ref.prefix.spilled_pages
    if eng.tier is not None:
        assert {k: getattr(eng.tier, k) for k in TIER_TOTALS} == \
            {k: getattr(ref.tier, k) for k in TIER_TOTALS}
        assert eng.cache.bytes_per_page == ref.cache.bytes_per_page
    _no_leak(eng)


def _no_leak(eng):
    cached = 0 if eng.prefix is None else eng.prefix.cached_pages
    assert eng.cache.pages_in_use == cached
    if eng.prefix is not None:
        assert eng.prefix.refs_total == 0
        if eng.tier is not None:
            assert eng.tier.pages_held == eng.prefix.spilled_pages + sum(
                e.n_pages for k, e in eng.tier._entries.items()
                if k[0] == "swap")
    if eng.tier is not None:
        assert not [k for k in eng.tier._entries if k[0] == "swap"]
        assert eng.tier.bytes_held == sum(e.nbytes for e in
                                          eng.tier._entries.values())


# ------------------------------------------------------------ tier store --
def _content(n_pages=1, fill=0):
    return [{"kv": np.full((n_pages, 64), fill, np.int8)}]


def _store_script(S):
    """One sequence of store calls; returns what it observed."""
    seen = []
    st = S(budget_bytes=3 * 64)

    def cb(key):
        seen.append(("evicted", key))
        st.pop("child-of-%s" % key)        # reentrant removal
    st.evict_cb = cb
    for k, fill in (("a", 1), ("child-of-a", 2), ("b", 3)):
        seen.append(("put", k, st.put(k, _content(fill=fill), 1)))
    seen.append(("peek", st.peek("a") is not None))
    seen.append(("put", "c", st.put("c", _content(fill=4), 1)))
    seen.append(("put", "d", st.put("d", _content(2, 5), 2,
                                    meta={"n_cached": 5})))
    seen.append(("refused", st.put("big", _content(4), 4)))
    e = st.get("d")
    seen.append(("get", e.meta, int(e.content[0]["kv"][1, 0])))
    seen.append(("pop", st.pop("d").n_pages, st.pop("nope")))
    seen.append(("drop", st.drop("c"), st.drop("c")))
    st.put(("swap", 7), _content(fill=1), 1, meta={"n_cached": 3})
    st.put(("swap", 7), _content(2, 2), 2, meta={"n_cached": 9})
    seen.append(("replaced", len(st), st.peek(("swap", 7)).meta))
    seen.append(sorted(st.stats().items()))
    st.reset_telemetry()
    seen.append(sorted(st.stats().items()))
    st.clear()
    seen.append((len(st), st.bytes_held, st.pages_held))
    return seen


def test_tier_store_same_as_reference():
    from mxnet_tpu.serving.tier_store import HostTierStore as R
    from mxnet_tpu_torch.serving.tier_store import HostTierStore as P
    assert _store_script(P) == _store_script(R)
    with pytest.raises(ValueError):
        P(0)


# -------------------------------------------------------- export/install --
def _pools(kv_int8, seed):
    """A reference and a port ``PagedKVCache`` (12 pages) holding the
    same random pool bytes."""
    import jax.numpy as jnp
    from mxnet_tpu.serving.paged_kv import PagedKVCache as R
    from mxnet_tpu_torch.serving.paged_kv import PagedKVCache as P
    jcfg, tcfg = configs()
    ref = R(jcfg, 12, 4, kv_int8=kv_int8)
    port = P(tcfg, 12, 4, kv_int8=kv_int8, device="cpu")
    rng = np.random.RandomState(seed)
    for rp, pp in zip(ref.pools, port.pools):
        for k in pp:
            shape = tuple(pp[k].shape)
            a = (rng.randint(-128, 128, shape).astype(np.int8)
                 if pp[k].dtype == torch.int8
                 else rng.randn(*shape).astype(np.float32))
            rp[k] = jnp.asarray(a)
            pp[k].copy_(torch.from_numpy(a))
    return ref, port


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy() \
        if isinstance(t, torch.Tensor) else np.asarray(t).view(np.uint8)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("deferred", [False, True],
                         ids=["at_once", "deferred"])
def test_export_install_bit_exact(kv_int8, deferred):
    from mxnet_tpu.serving.tier_store import content_nbytes as rn
    from mxnet_tpu_torch.serving.tier_store import content_nbytes as pn
    ref, port = _pools(kv_int8, seed=5)
    port.deferred = deferred
    ids = [7, 2, 9]
    rc = ref.export_pages(ids)
    pc = port.export_pages(ids)
    assert (pc.host is None) == deferred     # queued until run or read
    assert pn(pc) == rn(rc) == 3 * port.bytes_per_page \
        == 3 * ref.bytes_per_page
    assert len(pc) == len(rc)
    for lr, lp in zip(rc, pc):
        assert sorted(lr) == sorted(lp)
        for k in lr:
            assert tuple(lp[k].shape) == lr[k].shape
            np.testing.assert_array_equal(_bytes(lp[k]), _bytes(lr[k]))
    assert pn(list(pc)) == pn(pc)
    # install the exported pages elsewhere: own content, then the
    # reference's numpy content (checked against the page shapes)
    ref.install_pages([1, 3, 4], rc)
    port.install_pages([1, 3, 4], pc)
    port.install_pages([5, 6, 8], rc)
    ref.install_pages([5, 6, 8], rc)
    port.run_transfers()
    for rp, pp in zip(ref.pools, port.pools):
        for k in pp:
            # page 0 is scratch: the reference's install pads its page
            # count to a power of two with writes there
            np.testing.assert_array_equal(_bytes(pp[k][1:]),
                                          _bytes(np.asarray(rp[k])[1:]))
    with pytest.raises(ValueError, match="does not match"):
        port.install_pages([1], [{k: np.asarray(v)[:, :2] for k, v in
                                  layer.items()} for layer in rc])
    with pytest.raises(ValueError, match="page ids"):
        port.install_pages([1, 2], pc)
    assert port.export_pages([]).n_pages == 0


def test_consecutive_exports_run_as_one():
    """Deferred exports queued back to back run as one transfer: each
    content a slice of one host buffer, its bytes those of the
    reference's export of its pages; a copy between them splits the
    batch and is ordered (the second export reads the copied page)."""
    ref, port = _pools(True, seed=6)
    port.deferred = True
    parts = [port.export_pages(ids) for ids in ([7], [2, 9], [4])]
    port.copy_page(3, 4)
    after = port.export_pages([4])
    port.run_transfers()
    base = parts[0].host.untyped_storage().data_ptr()
    assert all(p.host.untyped_storage().data_ptr() == base for p in parts)
    assert after.host.untyped_storage().data_ptr() != base
    for ids, pc in zip(([7], [2, 9], [4]), parts):
        for lr, lp in zip(ref.export_pages(ids), pc):
            for k in lr:
                np.testing.assert_array_equal(_bytes(lp[k]), _bytes(lr[k]))
    for lr, lp in zip(ref.export_pages([3]), after):
        for k in lr:
            np.testing.assert_array_equal(_bytes(lp[k]), _bytes(lr[k]))


def test_allocator_telemetry_same_as_reference():
    from mxnet_tpu.serving.paged_kv import PagedKVCache as R
    from mxnet_tpu_torch.serving.paged_kv import PagedKVCache as P
    jcfg, tcfg = configs()
    out = []
    for c in (R(jcfg, 6, 4), P(tcfg, 6, 4, device="cpu")):
        a = c.alloc(3)
        c.alloc(4)                                  # refused
        c.free(a[:2])
        c.alloc(0)
        row = [c.alloc_calls, c.alloc_pages_total, c.freed_pages_total,
               c.alloc_failures, c.bytes_held, c.bytes_pool,
               c.bytes_per_page]
        c.reset_telemetry()
        out.append(row + [c.alloc_calls, c.pages_in_use])
    assert out[0] == out[1]


# ------------------------------------------------------------ the engine --
def _spill_restore(make, tree, cfg, prompt, **kw):
    """A prompt served, its chain spilled (tier off: dropped), the
    prompt served again."""
    eng = make(tree, cfg, **_base(**kw))
    r1 = eng.submit(prompt, 5)
    eng.run()
    assert eng.prefix.cached_pages == 4
    if eng.tier is None:
        eng.prefix.clear()
    else:
        assert eng.prefix.spill() == 4
        assert eng.prefix.spilled_pages == eng.tier.pages_held == 4
    assert eng.prefix.cached_pages == 0 and eng.cache.pages_in_use == 0
    r2 = eng.submit(prompt, 5)
    eng.run()
    eng.close()
    return eng, [r1, r2]


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8kv"])
def test_spill_warm_restore(kv_int8, overlap):
    """A spilled chain restored as a warm hit serves the duplicate
    prompt exactly, with the reference's counters."""
    jcfg, tcfg, tree = _setup()
    prompt = np.random.RandomState(0).randint(1, 90, 16).astype(np.int32)
    kw = dict(kv_int8=kv_int8, overlap=overlap, metrics=True)
    ref, rids = _spill_restore(ref_engine, tree, jcfg, prompt, **kw)
    eng, _ = _spill_restore(port_engine, tree, tcfg, prompt, **kw)
    _same_state(ref, eng, rids, int8=kv_int8)
    assert eng.prefix.warm_hits_total == 1
    assert eng.prefix.pages_restored_total >= 3
    a, b = ref.metrics()["counters"], eng.metrics()["counters"]
    tier_keys = [k for k in b if "tier" in k or "swap" in k or "warm" in k]
    assert {k: b[k] for k in tier_keys} == {k: a[k] for k in tier_keys}
    assert b["serving_tier_spills_total"] == 4
    assert b["serving_tier_installs_total"] >= 3
    assert b["serving_prefix_warm_hit_tokens_total"] >= 12
    out = [eng.requests[r].output for r in rids]
    np.testing.assert_array_equal(out[0], out[1])
    if kv_int8:
        off, _ = _spill_restore(port_engine, tree, tcfg, prompt,
                                **dict(kw, tier_bytes=0))
        for r in rids:
            np.testing.assert_array_equal(off.requests[r].output,
                                          eng.requests[r].output)
    else:
        np.testing.assert_array_equal(out[1],
                                      ref_generate(tree, jcfg, prompt, 5))


def _swap(make, tree, cfg, kv_int8, tier=TIER):
    """A decode-phase victim (preempted after 3 tokens) and a
    mid-prefill victim (after one partial prefill step), each resumed;
    returns the engines and the requests' ids."""
    rng = np.random.RandomState(1)
    out = []
    eng = make(tree, cfg, **_base(kv_int8=kv_int8, prefix_cache=False,
                                  tier_bytes=tier))
    prompt = rng.randint(1, 90, 13).astype(np.int32)
    rid = eng.submit(prompt, 8)
    req = eng.requests[rid]
    while len(req.generated) < 3:
        eng.step()
    before = list(req.generated)
    assert eng.preempt(rid) is bool(tier)
    eng.run()
    assert req.generated[:3] == before
    out.append((eng, rid, prompt, 8))
    eng2 = make(tree, cfg, **_base(kv_int8=kv_int8, prefix_cache=False,
                                   prefill_chunk=4, tier_bytes=tier))
    long_p = rng.randint(1, 90, 17).astype(np.int32)
    rid2 = eng2.submit(long_p, 4)
    req2 = eng2.requests[rid2]
    eng2.step()
    assert req2.pending is None and 0 < req2.n_cached < long_p.size
    assert eng2.preempt(rid2) is bool(tier)
    eng2.run()
    out.append((eng2, rid2, long_p, 4))
    return out


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8kv"])
def test_swap_resume_decode_and_mid_prefill(kv_int8):
    jcfg, tcfg, tree = _setup()
    refs = _swap(ref_engine, tree, jcfg, kv_int8)
    ports = _swap(port_engine, tree, tcfg, kv_int8)
    offs = _swap(port_engine, tree, tcfg, kv_int8, tier=0) if kv_int8 \
        else None
    for i, ((ref, rid, p, n), (eng, _, _, _)) in enumerate(zip(refs, ports)):
        _same_state(ref, eng, [rid], int8=kv_int8)
        assert eng.stats["swap_outs"] == eng.stats["swap_ins"] == 1
        if kv_int8:
            np.testing.assert_array_equal(
                eng.requests[rid].output, offs[i][0].requests[rid].output)
            assert offs[i][0].stats["swap_ins"] == 0
        else:
            np.testing.assert_array_equal(eng.requests[rid].output,
                                          ref_generate(tree, jcfg, p, n))


def test_swap_entry_evicted_or_cancelled():
    """A swap entry aged out before resume falls back to recompute,
    exactly; a swapped victim cancelled while queued leaves no entry."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(2)
    eng = port_engine(tree, tcfg, **_base(prefix_cache=False))
    prompt = rng.randint(1, 90, 9).astype(np.int32)
    rid = eng.submit(prompt, 6)
    while len(eng.requests[rid].generated) < 2:
        eng.step()
    assert eng.preempt(rid) is True
    assert eng.tier.pop(("swap", rid)) is not None
    eng.run()
    assert eng.stats["swap_ins"] == 0
    np.testing.assert_array_equal(eng.requests[rid].output,
                                  ref_generate(tree, jcfg, prompt, 6))
    rid2 = eng.submit(prompt, 6)
    while len(eng.requests[rid2].generated) < 2:
        eng.step()
    assert eng.preempt(rid2) is True and ("swap", rid2) in eng.tier
    eng.cancel(rid2)
    assert ("swap", rid2) not in eng.tier and len(eng.tier) == 0
    assert eng.step() is False
    _no_leak(eng)


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_pressure_spills_and_swaps_match_reference(overlap):
    """A pool too small for the traffic: pressure spills refcount-0
    chains, preemptions swap victims out, warm hits and swap-ins come
    back; tokens, stats and tier counters equal the reference's."""
    jcfg, tcfg, tree = _setup(7)
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 90, 12).astype(np.int32)
    cases = [(np.concatenate([shared, rng.randint(1, 90, 3 + i)
                              .astype(np.int32)]), 5 + 2 * i)
             for i in range(4)]
    cases += [(rng.randint(1, 90, P).astype(np.int32), N)
              for P, N in [(11, 9), (6, 12), (14, 6)]]
    cases += [(shared, 6), (cases[0][0], 4)]
    kw = _base(num_slots=3, num_pages=13, overlap=overlap, metrics=True)
    engines = []
    for make, cfg in ((ref_engine, jcfg), (port_engine, tcfg)):
        eng = make(tree, cfg, **kw)
        rids = [eng.submit(p, n) for p, n in cases[:5]]
        eng.run()
        rids += [eng.submit(p, n) for p, n in cases[5:]]
        eng.run()
        eng.close()
        engines.append(eng)
    ref, eng = engines
    _same_state(ref, eng, rids)
    assert eng.stats["preemptions"] > 0 and eng.stats["swap_outs"] > 0
    assert eng.prefix.pages_spilled_total > 0
    a, b = ref.metrics(), eng.metrics()
    assert b["counters"] == a["counters"] and b["gauges"] == a["gauges"]
    for rid, (p, n) in zip(rids, cases):
        np.testing.assert_array_equal(eng.requests[rid].output,
                                      ref_generate(tree, jcfg, p, n))


def test_tier_eviction_drops_unreachable_descendants():
    """A two-page budget under a four-page spill: the reference's
    surviving spilled keys, and the duplicate prompt exact."""
    jcfg, tcfg, tree = _setup()
    prompt = np.random.RandomState(3).randint(1, 90, 16).astype(np.int32)
    out = []
    for make, cfg in ((ref_engine, jcfg), (port_engine, tcfg)):
        eng = make(tree, cfg, **_base())
        r1 = eng.submit(prompt, 4)
        eng.run()
        eng.tier.budget_bytes = 2 * eng.cache.bytes_per_page
        eng.prefix.spill()
        for key in eng.prefix._spilled:
            parent = key[:-4 * eng.page_size]
            if parent and parent not in eng.prefix._spilled:
                hot, _ = eng.prefix.probe_depth(np.frombuffer(key, np.int32))
                assert hot * eng.page_size * 4 >= len(parent)
        assert eng.tier.bytes_held <= 2 * eng.cache.bytes_per_page
        kept = sorted(eng.prefix._spilled)
        probe = eng.prefix.probe_depth(prompt)
        r2 = eng.submit(prompt, 4)
        eng.run()
        out.append((eng, kept, probe, r1, r2))
    (ref, rk, rp, r1, r2), (eng, pk, pp, _, _) = out
    assert pk == rk and pp == rp
    _same_state(ref, eng, [r1, r2])
    np.testing.assert_array_equal(eng.requests[r1].output,
                                  eng.requests[r2].output)


def test_cycles_leak_nothing_and_clear():
    """Spill, tier-evict and restore cycles over three chains: tokens
    and counters equal the reference's after every cycle, nothing
    leaks, and ``clear()`` drops hot and spilled entries."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 90, 8 + 4 * i).astype(np.int32)
               for i in range(3)]
    engines = [make(tree, cfg, **_base(num_pages=13, tier_bytes=1 << 20))
               for make, cfg in ((ref_engine, jcfg), (port_engine, tcfg))]
    for cycle in range(3):
        for eng in engines:
            rids = [eng.submit(p, 3) for p in prompts]
            eng.run()
            if cycle % 2 == 0:
                eng.prefix.spill()
        _same_state(*engines, rids)
    ref, eng = engines
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(eng.requests[rid].output,
                                      ref_generate(tree, jcfg, p, 3))
    eng.prefix.clear()
    assert eng.cache.pages_in_use == 0 and eng.prefix.spilled_pages == 0
    assert eng.tier.pages_held == 0


def test_mid_pressure_spill_reads_bytes_before_recycle():
    """The export of a chain spilled under the pressure of the very
    allocation that takes its pages reads the old bytes: the tier's
    content equals the chain's pre-spill export, and the warm hit
    replays exactly."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(5)
    eng = port_engine(tree, tcfg, **_base(num_pages=9, num_slots=1))
    pa = rng.randint(1, 90, 16).astype(np.int32)
    ra = eng.submit(pa, 3)
    out_a = eng.run()[ra]
    chain = [e.page for e in eng.prefix._by_key.values()]
    golden = eng.cache.export_pages(chain)
    golden.wait()
    pb = rng.randint(1, 90, 29).astype(np.int32)       # needs 8 pages
    rb = eng.submit(pb, 3)
    np.testing.assert_array_equal(eng.run()[rb],
                                  ref_generate(tree, jcfg, pb, 3))
    assert eng.prefix.pages_spilled_total == 4
    run = eng.prefix.spilled_content(pa, 0)
    assert len(run) == 4
    for j, content in enumerate(run):
        for lt, lg in zip(content, golden):
            for k in lt:
                assert torch.equal(lt[k][0], lg[k][j])
    r2 = eng.submit(pa, 3)
    np.testing.assert_array_equal(eng.run()[r2], out_a)
    _no_leak(eng)


def test_match_restore_exception_releases_refs():
    jcfg, tcfg, tree = _setup()
    pa = np.random.RandomState(11).randint(1, 90, 16).astype(np.int32)
    eng = port_engine(tree, tcfg, **_base())
    eng.submit(pa, 4)
    eng.run()
    eng.prefix.spill()
    eng.submit(pa[:8], 3)                 # heat the chain's head again
    eng.run()
    h, w = eng.prefix.probe_depth(pa)
    assert h >= 1 and w >= 1
    in_use = eng.cache.pages_in_use
    orig = eng.cache.install_pages

    def boom(*a, **k):
        raise RuntimeError("injected install failure")

    eng.cache.install_pages = boom
    try:
        with pytest.raises(RuntimeError, match="injected"):
            eng.prefix.match(pa)
    finally:
        eng.cache.install_pages = orig
    assert eng.prefix.refs_total == 0
    assert eng.cache.pages_in_use == in_use
    r3 = eng.submit(pa, 4)
    np.testing.assert_array_equal(eng.run()[r3],
                                  ref_generate(tree, jcfg, pa, 4))


def test_env_and_constructor(monkeypatch):
    _, tcfg, tree = _setup()
    monkeypatch.setenv("MXNET_SERVE_TIER_BYTES", "4096")
    eng = port_engine(tree, tcfg, num_slots=2, page_size=4)
    assert eng.tier is not None and eng.tier.budget_bytes == 4096
    assert port_engine(tree, tcfg, num_slots=2, tier_bytes=0).tier is None
    monkeypatch.setenv("MXNET_SERVE_TIER_BYTES", "lots")
    with pytest.raises(ValueError, match="expected int"):
        port_engine(tree, tcfg, num_slots=2)
    monkeypatch.delenv("MXNET_SERVE_TIER_BYTES")
    assert port_engine(tree, tcfg, num_slots=2).tier is None
    from mxnet_tpu_torch.parallel import make_mesh
    live = make_mesh({"tp": 2}, devices=["cpu", "cpu"])
    for kw in (dict(tp=2), dict(mesh=live), dict(kernel="pallas")):
        with pytest.raises(NotImplementedError):
            port_engine(tree, tcfg, num_slots=2, **kw)


# ------------------------------------------------------------- the card --
def _card_model(dev):
    from mxnet_tpu_torch.models import gpt as G
    tiny = G.gpt_tiny(dtype="float32", vocab_size=128, max_len=64,
                      d_model=128, n_heads=2, d_ff=256, dropout=0.0)
    return G, tiny, G.init_params(3, tiny, device=dev)


@pytest.mark.cuda
def test_warm_restore_and_swap_in_then_captured_steps(cuda_device):
    """On the card: a warm restore and a swap-in, each followed by
    replayed (captured) steps, token-identical to the engine run op by
    op and to ``generate``; tier counters moved."""
    from mxnet_tpu_torch.serving import ServingEngine
    G, tiny, tp = _card_model(cuda_device)
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 90, 16).astype(np.int32)
    other = rng.randint(1, 90, 13).astype(np.int32)
    outs = []
    for eager in (True, False):
        eng = ServingEngine(tp, tiny, device=cuda_device, metrics=True,
                            **_base())
        eng._eager = eager
        r1 = eng.submit(prompt, 5)
        eng.run()
        assert eng.prefix.spill() == 4
        r2 = eng.submit(prompt, 5)          # warm restore, then steps
        r3 = eng.submit(other, 8)
        req = eng.requests[r3]
        while len(req.generated) < 3:
            eng.step()
        assert eng.preempt(r3) is True
        eng.run()                           # swap-in, then steps
        c = eng.metrics()["counters"]
        assert c["serving_tier_spills_total"] > 0
        assert c["serving_tier_installs_total"] > 0
        assert c["serving_swap_ins_total"] == 1
        _no_leak(eng)
        outs.append([eng.requests[r].output for r in (r1, r2, r3)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    for out, (p, n) in zip(outs[1], ((prompt, 5), (prompt, 5), (other, 8))):
        want = G.generate(tp, tiny, torch.as_tensor(p)[None], n,
                          device=cuda_device)[0].cpu().numpy()
        np.testing.assert_array_equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8kv"])
def test_export_install_bytes_card_equal_cpu(cuda_device, kv_int8):
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.serving.paged_kv import PagedKVCache
    tiny = G.gpt_tiny(dtype="float32", vocab_size=128, max_len=64,
                      d_model=128, n_heads=2, d_ff=256, dropout=0.0)
    caches = [PagedKVCache(tiny, 12, 4, kv_int8=kv_int8, device=d)
              for d in ("cpu", cuda_device)]
    gen = torch.Generator().manual_seed(7)
    for pools in zip(*(c.pools for c in caches)):
        for k in pools[0]:
            t = pools[0][k]
            a = torch.randint(-128, 128, t.shape, generator=gen,
                              dtype=torch.int8) if t.dtype == torch.int8 \
                else torch.randn(t.shape, generator=gen)
            for p in pools:
                p[k].copy_(a)
    for c in caches:
        c.deferred = True
    contents = [c.export_pages([7, 2, 9]) for c in caches]
    for c, content in zip(caches, contents):
        c.install_pages([1, 3, 4], content)
        c.run_transfers()
    for lc, lg in zip(*contents):
        for k in lc:
            assert torch.equal(lc[k].contiguous().view(torch.uint8),
                               lg[k].contiguous().view(torch.uint8))
    for pc, pg in zip(*(c.pools for c in caches)):
        for k in pc:
            assert torch.equal(pc[k], pg[k].cpu())
