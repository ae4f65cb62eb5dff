"""Port parity: the disaggregated serving cluster
(``mxnet_tpu_torch/serving/cluster.py`` ``DisaggServingCluster``,
``serving/transport.py``, ``serving/page_streamer.py``,
``ClusterPrefixIndex``, ``ServingEngine.admit_prefilled``) against the
reference's, on the CPU at the tiny f32 GPT of the reference's
tests/test_serving_disagg.py, with the reference's weights through
``convert.from_jax``.

In process: the wire's meta and bytes equal the reference's
(``tree_to_frames``, ``pages_to_bufs``, f32 and int8 pages), a bf16 leaf
travels as raw bytes, the shm put segment's round trip, capability
negotiation and release accounting, ``PageReceiver`` releasing the
frames it holds, ``ClusterPrefixIndex`` against the reference's on one
call sequence, and the handoff simulated between two engines
(``admit_prefilled``) token-identical to the reference's ``generate``.

Across processes (spawned workers on the CPU, each wait bounded): mixed
lengths through one prefill and one decode worker, a shared prefix
prefilled once with two prefill workers, a decode worker SIGKILLed
mid-decode; every output equals the reference's ``generate`` and no
survivor keeps pages, refs or staged streams.  The serve launcher
starts a router script and its workers through ``MXNET_SERVE_*``.

The ``cuda`` test runs a cluster's workers on the card: their captured
steps launch the paged-attention kernel in each worker process (no JAX
there: this file imports the reference only inside its CPU tests)."""
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _torch_port import (configs, cuda_device, numpy_params,  # noqa: F401
                         ref_generate, to_port)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

_SETUP = {}


def _setup():
    """One weight tree for the whole file."""
    if not _SETUP:
        jcfg, tcfg = configs()
        _SETUP["v"] = (jcfg, tcfg, numpy_params(jcfg, 0))
    return _SETUP["v"]


_REFS = {}


def _ref(tree, jcfg, prompt, n):
    key = (id(tree), prompt.tobytes(), n)
    if key not in _REFS:
        _REFS[key] = ref_generate(tree, jcfg, prompt, n)
    return _REFS[key]


# --- the wire ---------------------------------------------------------------
def _tree():
    rng = np.random.RandomState(0)
    return {"a": rng.randn(2, 3).astype(np.float32),
            "layers": [{"w": rng.randint(-9, 9, (2, 2)).astype(np.int8)},
                       {"w": np.zeros((1,), np.float64),
                        "i": np.arange(5, dtype=np.int32)}],
            "s": np.float32(2.5)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_tree_frames_equal_the_reference_s():
    """The same tree gives the reference's meta (pickled alike) and
    bytes, from numpy leaves and from torch leaves; it comes back
    exact."""
    from mxnet_tpu.serving import transport as RT
    from mxnet_tpu_torch.serving import transport as PT
    tree = _tree()
    rmeta, rbufs = RT.tree_to_frames(tree)
    for src in (tree, _torch_tree(tree)):
        meta, bufs = PT.tree_to_frames(src)
        assert meta == rmeta
        assert pickle.dumps(meta) == pickle.dumps(rmeta)
        assert [bytes(b) for b in bufs] == [bytes(b) for b in rbufs]
    back = PT.frames_to_tree(rmeta, [bytearray(b) for b in rbufs])
    assert back["layers"][0]["w"].dtype == torch.int8
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(back["layers"][1]["i"].numpy(),
                                  tree["layers"][1]["i"])
    assert back["s"].shape == () and float(back["s"]) == 2.5
    # a bare leaf rebuilds from its one buffer, as the reference's
    m, b = PT.tree_to_frames(tree["a"])
    np.testing.assert_array_equal(PT.frames_to_tree(m, b).numpy(),
                                  RT.frames_to_tree(*RT.tree_to_frames(
                                      tree["a"])))


def test_bf16_leaf_travels_as_raw_bytes():
    """A ``torch.bfloat16`` leaf goes out under the reference's dtype
    name and shape with the reference's bytes (its ``ml_dtypes``
    array's), and comes back a bfloat16 tensor, bit for bit."""
    import ml_dtypes
    from mxnet_tpu.serving import transport as RT
    from mxnet_tpu_torch.serving import transport as PT
    x = torch.randn(3, 5).to(torch.bfloat16)
    ref = x.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    rmeta, rbufs = RT.tree_to_frames({"w": ref})
    meta, bufs = PT.tree_to_frames({"w": x})
    assert meta == rmeta and meta["leaves"][0]["dtype"] == "bfloat16"
    assert [bytes(b) for b in bufs] == [bytes(b) for b in rbufs]
    back = PT.frames_to_tree(meta, [bytearray(b) for b in bufs])["w"]
    assert back.dtype == torch.bfloat16 and back.shape == (3, 5)
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))


def _ref_cache_with_pages(jcfg, kv_int8, ids, seed=0):
    """A reference pool with ``ids`` filled with seeded integers."""
    import jax.numpy as jnp
    from mxnet_tpu.serving.paged_kv import PagedKVCache
    c = PagedKVCache(jcfg, 9, 4, kv_int8=kv_int8)
    rng = np.random.RandomState(seed)
    pools = []
    for pool in c.pools:
        lay = {}
        for k, v in pool.items():
            a = np.asarray(v).copy()
            a[ids] = rng.randint(-100, 100, a[ids].shape).astype(a.dtype)
            lay[k] = jnp.asarray(a)
        pools.append(lay)
    c.pools = pools
    return c


@pytest.mark.parametrize("kv_int8", [False, True])
def test_page_bufs_equal_the_reference_s(kv_int8):
    """``pages_to_bufs`` of the same pages gives the reference's bytes:
    from the reference's exported arrays, and from the port's own
    export of those pages installed in its pool; ``bufs_to_pages``
    installs them back exactly, the wire counting the pool's bytes."""
    from mxnet_tpu.serving import page_streamer as RS
    from mxnet_tpu_torch.serving import page_streamer as PS
    from mxnet_tpu_torch.serving.paged_kv import PagedKVCache
    jcfg, tcfg = _setup()[:2]
    rc = _ref_cache_with_pages(jcfg, kv_int8, [1, 2, 5])
    content = [{k: np.asarray(v) for k, v in lay.items()}
               for lay in rc.export_pages([1, 2, 5])]
    want = [bytes(b) for b in RS.pages_to_bufs(content)]
    assert [bytes(b) for b in PS.pages_to_bufs(content)] == want
    src = PagedKVCache(tcfg, 9, 4, kv_int8=kv_int8, device="cpu")
    ids = src.alloc(3)
    src.install_pages(ids, content)
    bufs = PS.pages_to_bufs(src.export_pages(ids))
    assert [bytes(b) for b in bufs] == want
    assert sum(len(b) for b in want) == PS.page_wire_bytes(src, 3) == \
        RS.page_wire_bytes(rc, 3)
    dst = PagedKVCache(tcfg, 9, 4, kv_int8=kv_int8, device="cpu")
    got = dst.alloc(3)
    dst.install_pages(got, PS.bufs_to_pages(dst, 3, [bytearray(b)
                                                     for b in want]))
    assert [bytes(b) for b in PS.pages_to_bufs(dst.export_pages(got))] \
        == want
    with pytest.raises(ValueError, match="buffers"):
        PS.bufs_to_pages(dst, 3, want[:-1])
    with pytest.raises(ValueError, match="bytes"):
        PS.bufs_to_pages(dst, 2, want)
    # merged content (a fetch reply of hot and host-tier pages) is the
    # pages in order
    merged = PS.merge_page_content([src.export_pages(ids[:1]),
                                    src.export_pages(ids[1:])])
    assert [bytes(b) for b in PS.pages_to_bufs(merged)] == want


def test_put_segment_round_trip_and_release_accounting():
    """``put_write`` lands buffers in one pid-named segment,
    ``put_read`` maps them back and unlinks the file at once, a
    release is idempotent and balances the opens, and ``put_sweep``
    removes a segment nobody received."""
    import glob
    from mxnet_tpu_torch.serving.transport import (
        PUT_DIR, PUT_STATS, put_read, put_sweep, put_write)
    bufs = [np.arange(64, dtype=np.float32).tobytes(),
            np.arange(5, dtype=np.int8).tobytes()]
    path, sizes = put_write(bufs)
    assert os.path.exists(path) and sizes == [256, 5]
    assert str(os.getpid()) in os.path.basename(path)
    opens, rels = PUT_STATS["opens"], PUT_STATS["releases"]
    got = put_read(path, sizes)
    assert not os.path.exists(path)
    assert bytes(got[0]) == bufs[0] and bytes(got[1]) == bufs[1]
    got.release()
    got.release()
    assert PUT_STATS["opens"] == opens + 1
    assert PUT_STATS["releases"] == rels + 1
    path2, _ = put_write(bufs)
    assert put_sweep(os.getpid()) >= 1
    assert not os.path.exists(path2)
    assert not glob.glob(os.path.join(PUT_DIR, "mxserve-put-%d-*"
                                      % os.getpid()))


def test_put_capability_negotiation(monkeypatch):
    """Both ends must advertise, from one shm domain; the port's
    advertisement is the reference's; ``MXNET_SERVE_TRANSPORT=socket``
    advertises nothing."""
    from mxnet_tpu.serving import transport as RT
    from mxnet_tpu_torch.serving.transport import (put_capability,
                                                   put_eligible)
    mine = put_capability()
    assert mine == RT.put_capability() and mine["put_pages"]
    assert put_eligible(mine, dict(mine))
    assert not put_eligible(mine, None)
    assert not put_eligible(None, dict(mine))
    assert not put_eligible(mine, dict(mine, host="elsewhere"))
    assert not put_eligible(mine, dict(mine, put_pages=False))
    monkeypatch.setenv("MXNET_SERVE_TRANSPORT", "socket")
    assert put_capability() is None


def test_put_frames_over_a_connection():
    """Caps frames record each side's capability; a put frame's body
    does not ride the socket, arrives as the same bytes and is unlinked
    by the receiver."""
    from mxnet_tpu_torch.serving.transport import (Listener, connect,
                                                   put_write)
    accepted, frames = [], []
    evt = threading.Event()

    def handler(conn):
        conn.send_caps()
        accepted.append(conn)
        evt.set()
        while True:
            got = conn.recv()
            if got is None:
                return
            frames.append(got)

    lis = Listener().start(handler)
    try:
        c = connect(lis.host, lis.port)
        c.send_caps()
        assert c.wait_caps(timeout=5.0)["put_pages"]
        assert evt.wait(5.0)
        payload = [b"x" * 4096, b"y" * 128]
        path, sizes = put_write(payload)
        before = c.bytes_sent
        c.send("pages", {"srid": (1, 0), "start": 0, "n": 1,
                         "put": {"path": path, "sizes": sizes}}, ())
        assert c.bytes_sent == before
        deadline = time.time() + 5
        while len(frames) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert accepted[0].peer_put is not None
        kind, meta, bufs = frames[-1]
        assert kind == "pages" and meta["n"] == 1
        assert [bytes(b) for b in bufs] == payload
        assert not os.path.exists(path)
        bufs.release()
        c.close()
    finally:
        lis.close()


def test_page_receiver_releases_the_frames_it_holds():
    """A frame the dry pool cannot take is held as delivered (no copy)
    and released by an abort; a frame installed into a real pool is
    released once installed, its bytes in the pool."""
    from mxnet_tpu_torch.serving.page_streamer import (PageReceiver,
                                                       pages_to_bufs)
    from mxnet_tpu_torch.serving.transport import (PUT_STATS, put_read,
                                                   put_write)

    class _Bufs(list):
        released = False

        def release(self):
            self.released = True

    class _Dry:
        def alloc(self, n):
            return None

        def free(self, ids):
            pass

    class _Eng:
        cache = _Dry()

    rec = PageReceiver(_Eng())
    held = _Bufs([b"a", b"b"])
    rec.on_pages((7, 0), 0, 1, held)
    assert rec._staged[(7, 0)].held[0][1] is held and not held.released
    rec.abort((7, 0))
    assert held.released
    with pytest.raises(RuntimeError, match="out of order"):
        rec.on_pages((8, 0), 1, 1, _Bufs())

    jcfg, tcfg, tree = _setup()
    from mxnet_tpu_torch.serving import ServingEngine
    eng = ServingEngine(to_port(tree), tcfg, num_slots=2, page_size=4,
                        device="cpu")
    gen = torch.Generator().manual_seed(0)
    for pool in eng.cache.pools:
        pool["kv"].copy_(torch.randn(pool["kv"].shape, generator=gen))
    src = eng.cache.alloc(2)
    want = [bytes(b) for b in pages_to_bufs(eng.cache.export_pages(src))]
    opens, rels = PUT_STATS["opens"], PUT_STATS["releases"]
    rec = PageReceiver(eng)
    seg = put_read(*put_write(want))
    rec.on_pages((9, 0), 0, 2, seg)
    rec.on_handoff((9, 0), 2, {"toks": [1]})
    assert rec.ready((9, 0)) and seg.released
    assert PUT_STATS["opens"] - opens == PUT_STATS["releases"] - rels == 1
    ids, meta = rec.take((9, 0))
    assert meta == {"toks": [1]}
    assert [bytes(b) for b in pages_to_bufs(eng.cache.export_pages(ids))] \
        == want
    assert rec.pages_installed_total == 2 and not rec.staged_rids


def test_cluster_prefix_index_matches_the_reference_s():
    """One call sequence through both indexes: every ``match``, length
    and counter equal, tier tags included."""
    from mxnet_tpu.serving import ClusterPrefixIndex as R
    from mxnet_tpu_torch.serving import ClusterPrefixIndex as P_
    k = [b"a", b"ab", b"abc", b"abcd"]
    calls = [("report_insert", "p0", k[:2]), ("report_insert", "p1", k),
             ("report_evict", "p1", k[:1]), ("report_tier", "p0", k[1:2],
                                             "host"),
             ("report_tier", "p1", k[:1], "host"),
             ("report_evict", "p0", k[:1]), ("report_insert", "p0", k),
             ("report_tier", "p0", k[2:3], "host"),
             ("report_tier", "p0", k[2:3], "hbm"), ("drop_owner", "p0"),
             ("report_insert", "p2", k)]
    ref, port = R(), P_()
    for call in calls:
        seen = []
        for idx in (ref, port):
            getattr(idx, call[0])(*call[1:])
            seen.append([idx.match(k), idx.match(k[2:]), idx.match(k[:1]),
                         idx.match([]), len(idx), idx.keys_inserted_total,
                         idx.keys_evicted_total, idx.keys_retagged_total,
                         idx.hints_total])
        assert seen[0] == seen[1], call
    with pytest.raises(ValueError, match="tier"):
        port.report_tier("p0", k[:1], "warm")
    small = P_(capacity=2)
    small.report_insert("p0", k)
    assert len(small) == 2 and small.match(k) == ("p0", 2, "hbm")


def test_admit_prefilled_adopts_a_handoff_exactly():
    """The cross-process handoff in one process: engine A prefills with
    a one-token budget, its retire snapshot's pages export; engine B
    installs them and adopts the request mid-decode.  The output equals
    the reference's ``generate`` and B keeps no page."""
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.serving.page_streamer import (bufs_to_pages,
                                                       pages_to_bufs)
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(0)
    for P, n_new in ((13, 7), (8, 5), (3, 4)):
        prompt = rng.randint(1, 90, P).astype(np.int32)
        snap = {}
        A = ServingEngine(to_port(tree), tcfg, num_slots=2, page_size=4,
                          prefix_cache=True, device="cpu")
        A.retire_cb = lambda req: snap.update(pages=list(req.pages),
                                              n_cached=req.n_cached)
        rid = A.submit(prompt, 1)
        A.run()
        t0 = int(A.requests[rid].generated[0])
        n_pages = -(-snap["n_cached"] // A.page_size)
        bufs = pages_to_bufs(A.cache.export_pages(snap["pages"][:n_pages]))
        B = ServingEngine(to_port(tree), tcfg, num_slots=2, page_size=4,
                          device="cpu")
        ids = B.cache.alloc(n_pages)
        B.cache.install_pages(ids, bufs_to_pages(B.cache, n_pages, bufs))
        assert B.free_slots == 2
        erid = B.admit_prefilled(prompt, [t0], ids, max_new_tokens=n_new)
        assert B.free_slots == 1
        B.run()
        np.testing.assert_array_equal(B.requests[erid].output,
                                      _ref(tree, jcfg, prompt, n_new))
        assert B.cache.pages_in_use == 0


def test_admit_prefilled_validation():
    """The reference's refusals, with its messages."""
    from mxnet_tpu_torch.serving import ServingEngine
    jcfg, tcfg, tree = _setup()
    eng = ServingEngine(to_port(tree), tcfg, num_slots=1, page_size=4,
                        device="cpu")
    with pytest.raises(ValueError, match="committed token"):
        eng.admit_prefilled(np.ones(4, np.int32), [], [1],
                            max_new_tokens=2)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.admit_prefilled(np.ones(0, np.int32), [5], [1],
                            max_new_tokens=2)
    with pytest.raises(ValueError, match="cannot cover"):
        eng.admit_prefilled(np.ones(9, np.int32), [5], [1],
                            max_new_tokens=2)
    with pytest.raises(ValueError, match="max_seq"):
        eng.admit_prefilled(np.ones(9, np.int32), [5], [1],
                            max_new_tokens=100)
    eng.admit_prefilled(np.ones(3, np.int32), [5], [1], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no free slot"):
        eng.admit_prefilled(np.ones(3, np.int32), [5], [2],
                            max_new_tokens=2)


# --- whole processes --------------------------------------------------------
def _cluster(tcfg, tree, **kw):
    from mxnet_tpu_torch.serving import DisaggServingCluster
    base = dict(num_slots=4, page_size=4, metrics=True, watchdog_s=60.0,
                device="cpu", ready_timeout=TIMEOUT)
    base.update(kw)
    return DisaggServingCluster(to_port(tree), tcfg, **base)


def _leak_check(cl):
    """No survivor keeps pages beyond its prefix trie's, refs, staged
    streams, requests or mapped put segments."""
    for name, st in cl.cluster_stats().items():
        assert st["pages_in_use"] - st["prefix_cached_pages"] == 0, \
            (name, st)
        assert st["prefix_refs"] == 0, (name, st)
        assert st["staged_rids"] == 0, (name, st)
        assert st["active_requests"] == 0, (name, st)
        assert st["put_opens"] == st["put_releases"], (name, st)


def test_disagg_identity_mixed_lengths():
    """One prefill and one decode process exchanging KV pages: every
    output, a one-token request's too, equals the reference's
    ``generate``; the decode worker prefilled nothing; the router's
    counters agree with the workers'."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(0)
    wl = [(rng.randint(1, 90, P).astype(np.int32), n)
          for P, n in ((5, 6), (9, 4), (17, 8), (3, 5), (21, 11), (12, 1))]
    want = [_ref(tree, jcfg, p, n) for p, n in wl]
    cl = _cluster(tcfg, tree, prefill=1, decode=1)
    try:
        assert len({w.proc.pid for w in cl.workers.values()}) == 2
        rids = [cl.submit(p, n) for p, n in wl]
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT),
                                          w)
        st = cl.cluster_stats()
        # every streamed page is installed, but the one-token request's
        # may be fenced first (its 'abort' from the router can overtake
        # its 'pages' from the prefill worker)
        assert 0 < st["decode0"]["pages_installed"] <= \
            st["prefill0"]["pages_streamed"]
        assert st["decode0"]["decode_rows"] > 0
        assert st["decode0"]["prefill_rows"] == 0
        # the CPU runs the plain versions: no kernel launched anywhere
        assert all(v["launches"] == {"paged_attention": 0, "flash_fwd": 0}
                   for v in st.values())
        c = cl.registry.snapshot()["counters"]
        assert c["cluster_requests_completed_total"] == len(wl)
        assert c["cluster_pages_streamed_total"] == \
            st["prefill0"]["pages_streamed"]
        _leak_check(cl)
        with pytest.raises(ValueError, match="max_seq"):
            cl.submit(np.ones(60, np.int32), 10)
    finally:
        cl.close()
    from mxnet_tpu_torch.serving import ClusterClosed
    with pytest.raises(ClusterClosed):
        cl.submit(wl[0][0], 2)
    assert all(not w.proc.is_alive() for w in cl.workers.values())


def test_disagg_remote_prefix_prefilled_once_per_cluster():
    """Requests sharing a prefix, alternated over two prefill processes:
    the prefix is prefilled once in the cluster, the other worker
    fetches its pages once (a remote hit), outputs stay exact."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 90, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(1, 90, 3)
                               .astype(np.int32)]) for _ in range(5)]
    want = [_ref(tree, jcfg, p, 4) for p in prompts]
    cl = _cluster(tcfg, tree, prefill=2, decode=1)
    try:
        for p, w in zip(prompts, want):
            np.testing.assert_array_equal(
                cl.result(cl.submit(p, 4), timeout=TIMEOUT), w)
        st = cl.cluster_stats()
        assert sum(v["remote_hits"] for v in st.values()) == 1, st
        assert sum(v["remote_hit_tokens"] for v in st.values()) == \
            shared.size
        rows = sum(v["prefill_rows"] for v in st.values()
                   if v["role"] == "prefill")
        assert sum(p.size for p in prompts) - rows >= \
            (len(prompts) - 1) * shared.size, st
        snap = cl.registry.snapshot()["counters"]
        assert snap["serving_prefix_remote_hits_total"] == 1
        assert snap["serving_prefix_remote_hit_tokens_total"] == shared.size
        assert snap["cluster_page_bytes_streamed_total"] > 0
        assert len(cl.index) >= 2
        _leak_check(cl)
    finally:
        cl.close()


def test_disagg_sigkill_decode_mid_decode():
    """SIGKILL of a decode process while requests decode: the router's
    streamed tokens resubmit as prompt extension and every output still
    equals the reference's ``generate``; the survivors keep nothing and
    the dead worker's flight ring is recovered."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(1)
    wl = [(rng.randint(1, 90, int(P)).astype(np.int32), 40)
          for P in rng.choice([5, 9, 14, 21], 6)]
    want = [_ref(tree, jcfg, p, n) for p, n in wl]
    cl = _cluster(tcfg, tree, prefill=1, decode=2)
    try:
        rids = [cl.submit(p, n) for p, n in wl]
        deadline = time.perf_counter() + TIMEOUT
        victim = None
        while victim is None and time.perf_counter() < deadline:
            with cl._lock:
                for r in cl.requests.values():
                    if r.state == "running" and r.phase == "decode" \
                            and 0 < len(r.committed) < r.max_new_tokens:
                        victim = r.decode
                        break
            time.sleep(0.002)
        assert victim is not None, "no request caught mid-decode"
        cl.kill_worker(victim)
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT),
                                          w)
        snap = cl.registry.snapshot()["counters"]
        assert snap["cluster_failovers_total"] == 1
        assert snap["cluster_requests_resubmitted_total"] >= 1
        assert not cl.workers[victim].proc.is_alive()
        assert cl.flight_tail(victim)
        assert [h["dead"] for h in cl.health()].count(True) == 1
        _leak_check(cl)
    finally:
        cl.close()


ROUTER = """
import os, sys
import numpy as np
from mxnet_tpu_torch.models import gpt as G
from mxnet_tpu_torch.serving import DisaggServingCluster
cfg = G.gpt_tiny(dtype="float32", vocab_size=64, max_len=32, dropout=0.0)
params = G.init_params(0, cfg, device="cpu")
cl = DisaggServingCluster(
    params, cfg, spawn=False, device="cpu", num_slots=2, page_size=4,
    prefill=int(os.environ["MXNET_SERVE_PREFILL"]),
    decode=int(os.environ["MXNET_SERVE_DECODE"]),
    port=int(os.environ["MXNET_SERVE_ROUTER_PORT"]), ready_timeout=100)
try:
    p = np.arange(1, 8, dtype=np.int32)
    out = cl.result(cl.submit(p, 5), timeout=100)
    want = G.generate(params, cfg, p[None], 5, device="cpu")[0].numpy()
    assert out.tolist() == want.tolist(), (out, want)
    print("workers", sorted(w.pid for w in cl.workers.values()
                            if w.pid is not None) != [], "OK")
finally:
    cl.close()
"""


def test_serve_launcher_runs_router_and_workers():
    """``tools.launch --launcher serve``: the router script (spawn=False)
    and one prefill and one decode worker started through the
    launcher's ``MXNET_SERVE_*`` environment serve a request exactly;
    the launcher returns the router's exit code."""
    p = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch",
         "--launcher", "serve", "--prefill", "1", "--decode", "1",
         sys.executable, "-c", ROUTER], cwd=ROOT, timeout=TIMEOUT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert p.returncode == 0, p.stdout[-3000:]
    assert "workers True OK" in p.stdout, p.stdout[-3000:]
    from mxnet_tpu_torch.tools import launch
    assert launch.main(["--launcher", "serve", "--workers-only",
                        "--prefill", "1"]) == 2


def test_worker_asked_for_cuda_without_a_card_fails_its_handshake():
    """A cluster asked for CUDA on a machine without a card refuses at
    once; a worker whose handshake asks for CUDA without a card reports
    the error instead of ``ready`` (it runs nowhere else), and the
    router's handshake raises, naming it.  ``kernel=`` is refused."""
    import queue
    from mxnet_tpu_torch.serving import DisaggServingCluster
    from mxnet_tpu_torch.serving import cluster as C
    from mxnet_tpu_torch.serving.transport import Listener, tree_to_frames
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    jcfg, tcfg, tree = _setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        DisaggServingCluster(to_port(tree), tcfg, num_slots=2)
    with pytest.raises(NotImplementedError, match="kernel"):
        DisaggServingCluster(to_port(tree), tcfg, num_slots=2,
                             device="cpu", kernel="xla")
    lis = Listener()
    conns = queue.Queue()
    lis.start(conns.put)
    errs = []

    def worker():
        try:
            C._DisaggWorker("prefill0", "prefill", lis.host, lis.port)
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        conn = conns.get(timeout=TIMEOUT)
        kind, meta, _ = conn.recv(timeout=TIMEOUT)
        assert kind == "hello" and meta["name"] == "prefill0"
        pm, pb = tree_to_frames(to_port(tree))
        conn.send("config", {"cfg": tcfg, "role": "prefill",
                             "engine_kwargs": dict(num_slots=2,
                                                   page_size=4,
                                                   device="cuda"),
                             "params_meta": pm, "watchdog_s": 5.0}, pb)
        wh = C._WorkerHandle("prefill0", "prefill")
        wh.conn = conn
        with pytest.raises(RuntimeError,
                           match="prefill0 failed to build its engine "
                                 ".*CUDA is not available"):
            C.DisaggServingCluster._take_ready(
                None, wh, time.perf_counter() + TIMEOUT, "handshake")
        t.join(TIMEOUT)
        assert errs and "CUDA" in str(errs[0])
    finally:
        lis.close()


@pytest.mark.cuda
def test_paged_kernel_runs_in_every_worker_on_the_card(cuda_device):
    """Workers on the card: each captured its own step, so the paged
    kernel's launches counted in the worker processes are above 0 and
    the outputs equal ``generate`` on the card token for token (f32)."""
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.serving import DisaggServingCluster
    cfg = G.gpt_tiny(dtype="float32", vocab_size=128, max_len=64,
                     d_model=128, n_heads=2, d_ff=256, dropout=0.0)
    params = G.init_params(3, cfg, device="cpu")
    rng = np.random.RandomState(0)
    wl = [(rng.randint(1, 90, P).astype(np.int32), n)
          for P, n in ((5, 8), (13, 6), (9, 12), (21, 4))]
    want = [G.generate(params, cfg, p[None], n, device=cuda_device)[0]
            .cpu().numpy() for p, n in wl]
    cl = DisaggServingCluster(params, cfg, prefill=1, decode=1,
                              num_slots=3, page_size=4, prefill_chunk=6,
                              metrics=True)
    try:
        rids = [cl.submit(p, n) for p, n in wl]
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT),
                                          w)
        st = cl.cluster_stats()
        for name, v in st.items():
            assert v["launches"]["paged_attention"] > 0, (name, v)
            assert v["device_steps"] > 0, (name, v)
        _leak_check(cl)
    finally:
        cl.close()
