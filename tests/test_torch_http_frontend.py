"""The HTTP/SSE front door (``serving/http_frontend.py``) on the CPU.

The reference's fast tests (``tests/test_http_frontend.py``: the wire
helpers, the token bucket and key table, the watchdog clamp of
``Retry-After``, and the live server over real loopback sockets against
a scripted fake cluster: every edge rejection, SSE framing and JSON
mode, disconnect to ``cancel(rid)``, the in-flight quota, ``/healthz``,
``/metrics``, ``/debug/*``) run against ``mxnet_tpu_torch``.  Then the
port's front door over its real clusters on the tiny f32 GPT of the
reference's tests, with the reference's weights: every SSE stream and
JSON response of a two-replica ``ServingCluster`` and of a one-prefill,
one-decode ``DisaggServingCluster`` is token-identical to the
reference's ``generate``; a client disconnect mid-stream frees the
victim's pages while a concurrent request still decodes (in process) or
reaches both workers as the generation-fenced ``cancel`` (disaggregated),
with no page, ref or staged stream left; a mass disconnect reconciles
its counters.  The launcher's ``http`` mode starts the CLI, which
serves a GPT drawn from ``torch.Generator`` seeded 0 (the reference
draws from ``jax.random.PRNGKey(0)``): its stream equals ``generate`` of
that tree.
"""
import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque

import numpy as np
import pytest

from mxnet_tpu_torch.serving.http_frontend import (ApiKeyTable,
                                                   HttpFrontend,
                                                   TokenBucket, chunk,
                                                   parse_request_head,
                                                   sse_event)
from _torch_port import configs, numpy_params, ref_generate, to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


# ---------------------------------------------------------------------------
# raw-socket client helpers (blocking: tests want determinism, not
# throughput)
# ---------------------------------------------------------------------------

def _request_bytes(path="/v1/generate", method="POST", body=b"",
                   key=None, extra=()):
    head = ["%s %s HTTP/1.1" % (method, path), "Host: test"]
    if key is not None:
        head.append("Authorization: Bearer %s" % key)
    if method == "POST":
        head.append("Content-Length: %d" % len(body))
    head.extend(extra)
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _recv_head(sock):
    buf = b""
    while b"\r\n\r\n" not in buf:
        data = sock.recv(65536)
        if not data:
            raise AssertionError("EOF before response head: %r" % buf)
        buf += data
    head, rest = buf.split(b"\r\n\r\n", 1)
    status = int(head.split(b" ", 2)[1])
    headers = {}
    for ln in head.split(b"\r\n")[1:]:
        k, v = ln.decode("latin-1").split(":", 1)
        headers[k.strip().lower()] = v.strip()
    return status, headers, rest


def _read_n(sock, rest, n):
    while len(rest) < n:
        data = sock.recv(65536)
        if not data:
            raise AssertionError("EOF mid-body")
        rest += data
    return rest[:n], rest[n:]


def _read_sse(sock, rest):
    """Read a chunked SSE body to the terminal chunk; returns the
    ordered (event, payload) list."""
    events = []
    buf = rest
    while True:
        while b"\r\n" not in buf:
            data = sock.recv(65536)
            if not data:
                return events          # peer closed (error paths)
            buf += data
        nl = buf.find(b"\r\n")
        n = int(buf[:nl], 16)
        body, buf = _read_n(sock, buf[nl + 2:], n + 2)
        if n == 0:
            return events
        for block in body[:-2].split(b"\n\n"):
            if not block.strip():
                continue
            ev = data_ = None
            for ln in block.split(b"\n"):
                if ln.startswith(b"event: "):
                    ev = ln[7:].decode()
                elif ln.startswith(b"data: "):
                    data_ = json.loads(ln[6:])
            events.append((ev, data_))


def _generate_body(prompt, n, stream=True, **kw):
    obj = {"prompt": [int(x) for x in prompt],
           "max_new_tokens": int(n), "stream": stream}
    obj.update(kw)
    return json.dumps(obj).encode()


def _connect(fe):
    s = socket.create_connection((fe.host, fe.port), timeout=60)
    s.settimeout(60)
    return s


def _sse_tokens(events):
    return [d["t"] for ev, d in events if ev == "token"]


# ---------------------------------------------------------------------------
# fast tier: pure wire-format units
# ---------------------------------------------------------------------------

def test_parse_request_head():
    m, p, h = parse_request_head(
        b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
        b"Content-Length: 3\r\nX-Api-Key:  k1 \r\n\r\n")
    assert (m, p) == ("POST", "/v1/generate")
    assert h["content-length"] == "3"
    assert h["x-api-key"] == "k1"          # trimmed, lower-cased name
    # last-wins duplicate headers
    _, _, h = parse_request_head(
        b"GET / HTTP/1.1\r\nA: 1\r\nA: 2\r\n\r\n")
    assert h["a"] == "2"


@pytest.mark.parametrize("head", [
    b"GET /\r\n\r\n",                      # no HTTP version
    b"GET / HTTP/2\r\n\r\n",               # not HTTP/1.x
    b"GET  /  HTTP/1.1\r\n\r\n",           # extra spaces
    b"GET x HTTP/1.1\r\n\r\n",             # path not absolute
    b"GET / HTTP/1.1\r\nbad line\r\n\r\n"  # colon-free header
])
def test_parse_request_head_malformed(head):
    with pytest.raises(ValueError):
        parse_request_head(head)


def test_sse_event_and_chunk_framing():
    ev = sse_event("token", {"i": 0, "t": 7})
    assert ev == b'event: token\ndata: {"i":0,"t":7}\n\n'
    ck = chunk(ev)
    assert ck == (b"%x\r\n" % len(ev)) + ev + b"\r\n"
    assert chunk(b"") == b"0\r\n\r\n"      # terminal chunk


def test_token_bucket():
    # unlimited: always ok
    tb = TokenBucket(None, 1)
    assert all(tb.take()[0] for _ in range(100))
    # hard burst budget (rate=0): exactly `burst` takes, then never
    tb = TokenBucket(0, 3)
    got = [tb.take()[0] for _ in range(10)]
    assert got == [True] * 3 + [False] * 7
    ok, retry = tb.take()
    assert not ok and retry is None        # never refills
    # refilling bucket with an injected clock: deterministic
    tb = TokenBucket(2.0, 2)               # 2 tokens/s, burst 2
    t0 = tb.t
    assert tb.take(t0)[0] and tb.take(t0)[0]
    ok, retry = tb.take(t0)
    assert not ok and retry == pytest.approx(0.5)
    ok, _ = tb.take(t0 + 0.5)              # one token refilled
    assert ok
    ok, _ = tb.take(t0 + 10.0)             # refill caps at burst
    assert ok
    assert tb.tokens == pytest.approx(1.0)


def test_api_key_table_load_shapes(tmp_path):
    spec = {"sk-a": {"tenant": "a", "rate": 2.5,
                     "max_in_flight": 4},
            "sk-b": {}}
    for src in (spec, json.dumps(spec)):
        kt = ApiKeyTable.load(src)
        a = kt.lookup("sk-a")
        assert a.name == "a" and a.max_in_flight == 4
        assert a.bucket.rate == 2.5 and a.bucket.burst == 3
        b = kt.lookup("sk-b")
        assert b.name == "sk-b"            # display name defaults
        assert b.bucket.rate is None and b.max_in_flight is None
        assert kt.lookup("sk-zzz") is None
        assert kt.lookup(None) is None
    f = tmp_path / "keys.json"
    f.write_text(json.dumps(spec))
    assert ApiKeyTable.load(str(f)).lookup("sk-a").name == "a"
    # idempotent: load() of a table is the table
    kt = ApiKeyTable.load(spec)
    assert ApiKeyTable.load(kt) is kt


def test_retry_after_clamped_to_watchdog():
    """The completion-rate hint is bounded above by the watchdog, so a
    stalled or barely-completing cluster never advertises a multi-hour
    Retry-After."""
    from mxnet_tpu_torch.serving.cluster import ServingCluster
    cl = object.__new__(ServingCluster)    # the method's state only
    cl.watchdog_s = 30.0
    cl.max_queue = 4
    cl._obs = None
    now = time.perf_counter()
    # one completion interval over ~10 s => rate ~0.1/s
    cl._completions = deque([now - 10.0, now - 1e-4])
    # small excess: unclamped arithmetic (2 excess / 0.1 per s ~ 20 s)
    hint = cl._retry_after_locked(waiting=cl.max_queue + 1)
    assert 10.0 < hint < 30.0
    # huge excess: would be ~10^6 s — must clamp to the watchdog
    assert cl._retry_after_locked(waiting=10 ** 5) == 30.0
    # no completions observed: the watchdog/4 floor (already bounded)
    cl._completions = deque()
    assert cl._retry_after_locked(waiting=10 ** 5) == \
        pytest.approx(7.5)


# ---------------------------------------------------------------------------
# fast tier: the live server over a scripted fake cluster
# ---------------------------------------------------------------------------

class _FakeCluster:
    """Duck-typed stand-in for ServingCluster: scripted token streams,
    recorded cancels — the edge and framing paths without an engine."""

    def __init__(self, script=(5, 6, 7), hold=False):
        from mxnet_tpu_torch.obs import MetricsRegistry
        self.registry = MetricsRegistry({"cluster": "fake"})
        self.script = list(script)
        self.hold = threading.Event()      # set => block before done
        if hold:
            self.hold.clear()
        else:
            self.hold.set()
        self.cancelled = []
        self.submitted = []
        self._seq = itertools.count(100)
        self._lock = threading.Lock()
        self._cancel_evt = {}              # rid -> Event

    def submit(self, prompt, max_new_tokens, eos_id=None, ttl_s=None):
        rid = next(self._seq)
        self.submitted.append((rid, np.asarray(prompt),
                               max_new_tokens))
        self._cancel_evt[rid] = threading.Event()
        return rid

    def attach_stream(self, rid, cb):
        prompt = next(p for r, p, _ in self.submitted if r == rid)

        def run():
            for t in self.script:
                cb(("tokens", [t]))
                time.sleep(0.005)
            while not self.hold.wait(0.05):
                if self._cancel_evt[rid].is_set():
                    return                 # cancelled while held
            out = np.concatenate([prompt.astype(np.int64),
                                  np.asarray(self.script)])
            cb(("done", out))

        threading.Thread(target=run, daemon=True).start()

    def cancel(self, rid):
        self.cancelled.append(rid)
        self._cancel_evt[rid].set()
        return True

    def health(self):
        return [{"replica": 0, "alive": True}]


def test_http_edge_rejections_fast():
    """401/429/413/400/404/405/411 — each refused at the edge,
    BEFORE submit(), with X-Request-Id on every response and the
    rejection counters reconciling exactly."""
    fake = _FakeCluster()
    keys = {"sk-good": {"tenant": "t", "rate": 0, "burst": 2}}
    fe = HttpFrontend(fake, keys=keys, max_body=256).start()
    try:
        def roundtrip(raw):
            s = _connect(fe)
            try:
                s.sendall(raw)
                return _recv_head(s)
            finally:
                s.close()

        body = _generate_body([1, 2], 3)
        # no key / unknown key -> 401
        st, h, _ = roundtrip(_request_bytes(body=body))
        assert st == 401 and h["x-request-id"]
        st, _, _ = roundtrip(_request_bytes(body=body, key="sk-bad"))
        assert st == 401
        # burst budget 2: two accepted, third 429 with Retry-After
        for _ in range(2):
            st, _, _ = roundtrip(_request_bytes(body=body,
                                                key="sk-good"))
            assert st == 200
        st, h, _ = roundtrip(_request_bytes(body=body, key="sk-good"))
        assert st == 429 and "retry-after" in h
        # oversized body -> 413 (and the submit never happened)
        st, _, _ = roundtrip(_request_bytes(body=b"x" * 512,
                                            key="sk-good"))
        assert st == 413
        # undecodable body -> 400
        st, _, _ = roundtrip(_request_bytes(body=b"not json",
                                            key="sk-good"))
        assert st == 400
        # unknown path -> 404; bad method -> 405; no length -> 411
        st, _, _ = roundtrip(_request_bytes(path="/v2/zzz", body=body,
                                            key="sk-good"))
        assert st == 404
        st, _, _ = roundtrip(b"PUT /v1/generate HTTP/1.1\r\n"
                             b"Host: x\r\nContent-Length: 0\r\n\r\n")
        assert st == 405
        st, _, _ = roundtrip(
            b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
            b"Authorization: Bearer sk-good\r\n\r\n")
        assert st == 411
        # the two 200s are the ONLY submits that reached the cluster
        assert len(fake.submitted) == 2
        snap = fake.registry.snapshot()["counters"]
        assert snap["http_rejected_auth_total"] == 2
        assert snap["http_rejected_quota_total"] == 1
        assert snap["http_rejected_body_total"] == 1
    finally:
        fe.close()


def test_http_sse_framing_and_json_mode_fast():
    """The SSE stream is exact: ordered token events with running
    indices, one done event carrying the count, clean terminal chunk.
    JSON mode returns the generated tokens on a keep-alive
    connection (two requests ride one socket)."""
    fake = _FakeCluster(script=[5, 6, 7])
    fe = HttpFrontend(fake, keys=None).start()
    try:
        s = _connect(fe)
        s.sendall(_request_bytes(body=_generate_body([9, 8], 3)))
        st, h, rest = _recv_head(s)
        assert st == 200
        assert h["content-type"] == "text/event-stream"
        assert h["transfer-encoding"] == "chunked"
        events = _read_sse(s, rest)
        s.close()
        assert _sse_tokens(events) == [5, 6, 7]
        assert [d["i"] for ev, d in events if ev == "token"] \
            == [0, 1, 2]
        assert events[-1][0] == "done" and events[-1][1]["n"] == 3
        # JSON mode, keep-alive: two requests on one connection
        s = _connect(fe)
        for _ in range(2):
            s.sendall(_request_bytes(
                body=_generate_body([9, 8], 3, stream=False)))
            st, h, rest = _recv_head(s)
            assert st == 200
            clen = int(h["content-length"])
            body, _ = _read_n(s, rest, clen)
            assert json.loads(body)["tokens"] == [5, 6, 7]
        s.close()
        snap = fake.registry.snapshot()["counters"]
        assert snap["http_streams_total"] == 1
        assert snap["http_requests_total"] == 3
    finally:
        fe.close()


def test_http_disconnect_propagates_cancel_fast():
    """Client disconnect mid-stream reaches ``cluster.cancel(rid)``:
    the scripted stream never completes (the fake holds the done
    event), the client reads one token and slams the socket."""
    fake = _FakeCluster(script=[4], hold=True)
    fe = HttpFrontend(fake, keys=None).start()
    try:
        s = _connect(fe)
        s.sendall(_request_bytes(body=_generate_body([1], 8)))
        st, _, rest = _recv_head(s)
        assert st == 200
        while b"event: token" not in rest:
            rest += s.recv(4096)
        # RST, not FIN: the rudest client disconnect
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
        s.close()
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline and not fake.cancelled:
            time.sleep(0.01)
        assert fake.cancelled, "disconnect never reached cancel()"
        snap = fake.registry.snapshot()["counters"]
        assert snap["http_client_disconnects_total"] == 1
    finally:
        fake.hold.set()
        fe.close()


def test_json_mode_disconnect_propagates_cancel_fast():
    """JSON mode watches the read side too: a client that drops the
    connection while its non-streamed request decodes reaches
    ``cluster.cancel(rid)`` exactly like an SSE disconnect — the
    engine must not decode to completion for nobody."""
    fake = _FakeCluster(script=[4], hold=True)
    fe = HttpFrontend(fake, keys=None).start()
    try:
        s = _connect(fe)
        s.sendall(_request_bytes(body=_generate_body([1], 8,
                                                     stream=False)))
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline and not fake.submitted:
            time.sleep(0.01)
        assert fake.submitted
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
        s.close()
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline and not fake.cancelled:
            time.sleep(0.01)
        assert fake.cancelled, "JSON-mode disconnect never cancelled"
        snap = fake.registry.snapshot()["counters"]
        assert snap["http_client_disconnects_total"] == 1
    finally:
        fake.hold.set()
        fe.close()


def test_http_max_in_flight_quota_fast():
    """max_in_flight bounds CONCURRENT admitted requests per tenant:
    a held stream occupies the slot, the next request 429s, and the
    slot frees on completion."""
    fake = _FakeCluster(script=[4], hold=True)
    fe = HttpFrontend(fake,
                      keys={"sk-t": {"max_in_flight": 1}}).start()
    try:
        s1 = _connect(fe)
        s1.sendall(_request_bytes(body=_generate_body([1], 4),
                                  key="sk-t"))
        st, _, rest = _recv_head(s1)
        assert st == 200
        while b"event: token" not in rest:
            rest += s1.recv(4096)
        s2 = _connect(fe)
        s2.sendall(_request_bytes(body=_generate_body([1], 4),
                                  key="sk-t"))
        st, _, _ = _recv_head(s2)
        assert st == 429
        s2.close()
        fake.hold.set()                    # finish the held stream
        _read_sse(s1, rest)
        s1.close()
        deadline = time.perf_counter() + 10
        while time.perf_counter() < deadline:
            if fe.keys.lookup("sk-t").in_flight == 0:
                break
            time.sleep(0.01)
        s3 = _connect(fe)
        s3.sendall(_request_bytes(body=_generate_body([1], 4),
                                  key="sk-t"))
        st, _, rest = _recv_head(s3)
        assert st == 200
        _read_sse(s3, rest)
        s3.close()
    finally:
        fake.hold.set()
        fe.close()


def test_healthz_and_metrics_fast():
    fake = _FakeCluster()
    fe = HttpFrontend(fake, keys={"sk": {}}).start()
    try:
        s = _connect(fe)
        s.sendall(_request_bytes(path="/healthz", method="GET"))
        st, h, rest = _recv_head(s)
        assert st == 200
        body, _ = _read_n(s, rest, int(h["content-length"]))
        obj = json.loads(body)
        assert obj["ok"] and obj["tenants"][0]["tenant"] == "sk"
        # keep-alive: /metrics rides the same socket
        s.sendall(_request_bytes(path="/metrics", method="GET"))
        st, h, rest = _recv_head(s)
        assert st == 200
        assert h["content-type"].startswith("text/plain")
        s.close()
    finally:
        fe.close()


def test_debug_statusz_and_trace_fast():
    """The ops surface at the edge: ``GET /debug/statusz`` and
    ``GET /debug/trace/<rid>`` relay the cluster's snapshots with the
    response's own X-Request-Id stamped in, 404 an unknown rid (the
    cluster's KeyError), 400 a non-integer rid, 405 non-GET, and 404
    when the attached cluster has no debug surface at all."""
    fake = _FakeCluster()
    fake.debug_status = lambda: {
        "kind": "fake", "closed": False, "workers": [],
        "in_flight": [], "slo": {"windows": []},
        "flight": {"path": None, "recovered": []}}

    def request_trace(rid):
        if rid != 100:
            raise KeyError(rid)
        return {"rid": rid, "router": {"state": "running"},
                "spans": [{"name": "prefill", "worker": "w0"}]}
    fake.request_trace = request_trace
    fe = HttpFrontend(fake, keys={"sk": {}}).start()
    try:
        s = _connect(fe)
        s.sendall(_request_bytes(path="/debug/statusz", method="GET"))
        st, h, rest = _recv_head(s)
        assert st == 200
        body, rest = _read_n(s, rest, int(h["content-length"]))
        obj = json.loads(body)
        assert obj["kind"] == "fake" and obj["workers"] == []
        assert obj["request_id"] == h["x-request-id"]
        # keep-alive: the trace surface rides the same socket
        s.sendall(_request_bytes(path="/debug/trace/100",
                                 method="GET"))
        st, h, rest = _recv_head(s)
        assert st == 200
        body, rest = _read_n(s, rest, int(h["content-length"]))
        obj = json.loads(body)
        assert obj["rid"] == 100
        assert obj["spans"][0]["worker"] == "w0"
        assert obj["request_id"] == h["x-request-id"]
        s.close()

        def one(raw):
            c = _connect(fe)
            try:
                c.sendall(raw)
                return _recv_head(c)[0]
            finally:
                c.close()

        assert one(_request_bytes(path="/debug/trace/999",
                                  method="GET")) == 404
        assert one(_request_bytes(path="/debug/trace/xyz",
                                  method="GET")) == 400
        assert one(_request_bytes(path="/debug/statusz",
                                  body=b"{}")) == 405
    finally:
        fe.close()
    # a cluster flavor without the surface: a clean 404, not a 500
    bare = _FakeCluster()
    fe = HttpFrontend(bare, keys={"sk": {}}).start()
    try:
        s = _connect(fe)
        s.sendall(_request_bytes(path="/debug/statusz", method="GET"))
        assert _recv_head(s)[0] == 404
        s.close()
    finally:
        fe.close()


def test_oversized_head_answered_not_dropped():
    """A request head past the 256 KiB stream limit gets a 400, not a
    silent connection drop (every malformed input answers with a
    status code)."""
    fake = _FakeCluster()
    fe = HttpFrontend(fake, keys=None).start()
    try:
        s = _connect(fe)
        s.sendall(b"POST /v1/generate HTTP/1.1\r\n"
                  b"X-Junk: " + b"j" * 300 * 1024 + b"\r\n\r\n")
        st, h, _ = _recv_head(s)
        assert st == 400
        s.close()
    finally:
        fe.close()


def test_tenant_accounting_partitions_traffic():
    """accepted counts edge-ADMITTED requests only: a quota 429 or an
    auth miss is rejected, a cluster-side failure after admission
    still counts accepted — accepted + rejected partitions the
    tenant's well-formed traffic."""
    fake = _FakeCluster()
    keys = {"sk-t": {"tenant": "t", "rate": 0, "burst": 2}}
    fe = HttpFrontend(fake, keys=keys).start()
    try:
        body = _generate_body([1, 2], 2, stream=False)
        for _ in range(2):
            s = _connect(fe)
            s.sendall(_request_bytes(body=body, key="sk-t"))
            st, h, rest = _recv_head(s)
            assert st == 200
            _read_n(s, rest, int(h["content-length"]))
            s.close()
        s = _connect(fe)
        s.sendall(_request_bytes(body=body, key="sk-t"))
        assert _recv_head(s)[0] == 429
        s.close()
        snap = fe.keys.snapshot()[0]
        assert snap["accepted"] == 2 and snap["rejected"] == 1
        assert snap["in_flight"] == 0
    finally:
        fe.close()


def test_env_knob_validation():
    from mxnet_tpu_torch.serving.http_frontend import _env_int
    os.environ["MXNET_SERVE_HTTP_MAX_BODY"] = "nope"
    try:
        with pytest.raises(ValueError):
            _env_int("MXNET_SERVE_HTTP_MAX_BODY", 1)
    finally:
        del os.environ["MXNET_SERVE_HTTP_MAX_BODY"]


def test_clusters_expose_registry():
    """``HttpFrontend.__init__`` reads ``cluster.registry``
    unconditionally: both cluster flavors expose it."""
    import inspect
    from mxnet_tpu_torch.serving import DisaggServingCluster, ServingCluster
    for cls in (ServingCluster, DisaggServingCluster):
        assert isinstance(
            inspect.getattr_static(cls, "registry", None), property), cls



# ---------------------------------------------------------------------------
# the port's real clusters over real sockets (tiny f32 GPT, the CPU)
# ---------------------------------------------------------------------------

_SETUP = {}


def _setup():
    if not _SETUP:
        jcfg, tcfg = configs()
        _SETUP["v"] = (jcfg, tcfg, numpy_params(jcfg, 3))
    return _SETUP["v"]


def _oracle(wl):
    """The reference's ``generate`` of each (prompt, n), computed before
    a cluster starts (its compiles hold the interpreter lock long enough
    to look like a stalled replica)."""
    jcfg, _, tree = _setup()
    return [ref_generate(tree, jcfg, p, n) for p, n in wl]


def _assert_no_leaks(cl):
    for rep in cl.replicas:
        if rep.engine is None or rep.dead:
            continue
        eng = rep.engine
        refs = 0 if eng.prefix is None else eng.prefix.refs_total
        cached = 0 if eng.prefix is None else eng.prefix.cached_pages
        assert refs == 0, "replica %d leaks %d refs" % (rep.idx, refs)
        assert eng.cache.pages_in_use == cached, \
            "replica %d leaks pages (%d in use, %d cache-owned)" % (
                rep.idx, eng.cache.pages_in_use, cached)


def _disagg_clean(cl, deadline):
    while time.perf_counter() < deadline:
        st = cl.cluster_stats()
        if all(not s.get("active_requests") and not s.get("staged_rids")
               and not s.get("prefix_refs")
               and s.get("pages_in_use", 0) == s.get("prefix_cached_pages",
                                                      0)
               and s.get("put_opens") == s.get("put_releases")
               for s in st.values()):
            return st
        time.sleep(0.02)
    raise AssertionError("worker pages never recycled: %r"
                         % (cl.cluster_stats(),))


def _abort(sock):
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
    sock.close()


def _roundtrip(fe, p, n, stream):
    s = _connect(fe)
    try:
        s.sendall(_request_bytes(body=_generate_body(p, n, stream=stream)))
        st, h, rest = _recv_head(s)
        assert st == 200, (st, rest)
        if stream:
            events = _read_sse(s, rest)
            assert events[-1][0] == "done"
            return _sse_tokens(events)
        body, _ = _read_n(s, rest, int(h["content-length"]))
        return json.loads(body)["tokens"]
    finally:
        s.close()


def test_stream_bit_identity_both_modes():
    """Every SSE stream and JSON response of a two-replica cluster
    equals the reference's ``generate``, token for token."""
    from mxnet_tpu_torch.serving import ServingCluster
    _, tcfg, tree = _setup()
    rng = np.random.RandomState(7)
    wl = [(rng.randint(1, 90, 3 + (i % 6)).astype(np.int32), 4 + (i % 5))
          for i in range(8)]
    want = _oracle(wl)
    cl = ServingCluster(to_port(tree), tcfg, replicas=2, num_slots=2,
                        page_size=4, prefill_chunk=6, metrics=True,
                        device="cpu")
    fe = None
    try:
        fe = HttpFrontend(cl, keys=None).start()
        for i, ((p, n), w) in enumerate(zip(wl, want)):
            got = _roundtrip(fe, p, n, stream=i % 3 != 2)
            assert got == [int(t) for t in w[len(p):]], "request %d" % i
        _assert_no_leaks(cl)
    finally:
        if fe is not None:
            fe.close()
        cl.close()


def test_disconnect_frees_pages_while_peer_still_decoding():
    """A client disconnect mid-decode frees the victim's pages while a
    concurrent request on the same replica is still decoding; the
    survivor equals ``generate``."""
    from mxnet_tpu_torch.serving import ServingCluster
    _, tcfg, tree = _setup()
    pa = np.arange(1, 7, dtype=np.int32)
    pb = np.arange(40, 48, dtype=np.int32)
    n = 40
    (want_b,) = _oracle([(pb, n)])
    cl = ServingCluster(to_port(tree), tcfg, replicas=1, num_slots=2,
                        page_size=4, prefill_chunk=8, metrics=True,
                        device="cpu")
    fe = None
    try:
        fe = HttpFrontend(cl, keys=None).start()
        s = _connect(fe)
        s.sendall(_request_bytes(body=_generate_body(pa, n)))
        st, _, rest = _recv_head(s)
        assert st == 200
        while b"event: token" not in rest:
            rest += s.recv(4096)
        rid_b = cl.submit(pb, n)
        eng = cl.replicas[0].engine
        deadline = time.perf_counter() + TIMEOUT
        while time.perf_counter() < deadline:
            with cl._lock:
                if sum(r.state == "running"
                       for r in cl.requests.values()) == 2:
                    break
            time.sleep(0.002)
        in_use_both = eng.cache.pages_in_use
        _abort(s)
        freed_at_state = None
        while time.perf_counter() < deadline:
            in_use = eng.cache.pages_in_use
            with cl._lock:
                b_state = cl.requests[rid_b].state
            if in_use < in_use_both:
                freed_at_state = b_state
                break
            time.sleep(0.001)
        assert freed_at_state == "running", freed_at_state
        np.testing.assert_array_equal(cl.result(rid_b, timeout=TIMEOUT),
                                      want_b)
        snap = cl.registry.snapshot()["counters"]
        assert snap["cluster_cancelled_total"] == 1
        assert snap["http_client_disconnects_total"] == 1
        _assert_no_leaks(cl)
    finally:
        if fe is not None:
            fe.close()
        cl.close()


def test_mass_disconnect_storm_reconciles():
    """Half of many concurrent streams aborted in one burst: every
    survivor equals ``generate``, every request ends done or cancelled,
    the counters reconcile and nothing leaks."""
    from mxnet_tpu_torch.serving import ServingCluster
    _, tcfg, tree = _setup()
    rng = np.random.RandomState(13)
    N = 12
    wl = [(rng.randint(1, 90, 4 + (i % 4)).astype(np.int32), 20)
          for i in range(N)]
    want = _oracle(wl)
    cl = ServingCluster(to_port(tree), tcfg, replicas=2, num_slots=2,
                        page_size=4, prefill_chunk=6, metrics=True,
                        max_queue=10 ** 6, device="cpu")
    fe = None
    try:
        fe = HttpFrontend(cl, keys=None).start()
        socks = []
        for p, n in wl:
            s = _connect(fe)
            s.sendall(_request_bytes(body=_generate_body(p, n)))
            socks.append(s)
        rests = []
        for s in socks:
            st, _, rest = _recv_head(s)
            assert st == 200
            rests.append(rest)
        victims = set(range(1, N, 2))
        for i in sorted(victims):
            _abort(socks[i])
        for i, ((p, n), w) in enumerate(zip(wl, want)):
            if i in victims:
                continue
            assert _sse_tokens(_read_sse(socks[i], rests[i])) == \
                [int(t) for t in w[len(p):]], "stream %d" % i
            socks[i].close()
        deadline = time.perf_counter() + TIMEOUT
        while time.perf_counter() < deadline:
            with cl._lock:
                live = sum(r.state in ("queued", "running")
                           for r in cl.requests.values())
            if not live:
                break
            time.sleep(0.02)
        with cl._lock:
            states = [r.state for r in cl.requests.values()]
            assert all(r.delivered for r in cl.requests.values())
        assert states.count("done") + states.count("cancelled") == N
        snap = cl.registry.snapshot()["counters"]
        assert snap["http_client_disconnects_total"] == len(victims)
        assert snap["cluster_cancelled_total"] == states.count(
            "cancelled") <= len(victims)
        _assert_no_leaks(cl)
    finally:
        if fe is not None:
            fe.close()
        cl.close()


def test_disagg_streams_and_disconnect_cancel_gen_fenced():
    """Over a one-prefill, one-decode cluster: streams and JSON equal
    ``generate``; a disconnect mid-stream cancels the request on both
    workers (the gen-fenced ``cancel``) with no page, ref or staged
    stream left; a late or duplicate cancel is a no-op and the cluster
    serves exactly afterwards."""
    from mxnet_tpu_torch.serving import DisaggServingCluster
    _, tcfg, tree = _setup()
    rng = np.random.RandomState(11)
    wl = [(rng.randint(1, 90, 6).astype(np.int32), 36),
          (rng.randint(1, 90, 5).astype(np.int32), 5),
          (rng.randint(1, 90, 7).astype(np.int32), 6)]
    want = _oracle(wl)
    cl = DisaggServingCluster(to_port(tree), tcfg, prefill=1, decode=1,
                              num_slots=2, page_size=4, prefill_chunk=6,
                              metrics=True, watchdog_s=60.0, device="cpu",
                              ready_timeout=TIMEOUT)
    fe = None
    try:
        fe = HttpFrontend(cl, keys=None).start()
        for stream in (True, False):
            p, n = wl[1]
            assert _roundtrip(fe, p, n, stream) == \
                [int(t) for t in want[1][len(p):]]
        p, n = wl[0]
        s = _connect(fe)
        s.sendall(_request_bytes(body=_generate_body(p, n)))
        st, _, rest = _recv_head(s)
        assert st == 200
        while b"event: token" not in rest:
            rest += s.recv(4096)
        with cl._lock:
            (rid,) = [r for r, cr in cl.requests.items()
                      if cr.state == "running"]
        _abort(s)
        deadline = time.perf_counter() + TIMEOUT
        while time.perf_counter() < deadline:
            with cl._lock:
                if cl.requests[rid].state == "cancelled":
                    break
            time.sleep(0.01)
        with cl._lock:
            assert cl.requests[rid].state == "cancelled"
        _disagg_clean(cl, deadline)
        assert cl.cancel(rid) is False
        p2, n2 = wl[2]
        r2 = cl.submit(p2, n2)
        np.testing.assert_array_equal(cl.result(r2, timeout=TIMEOUT),
                                      want[2])
        assert cl.cancel(r2) is False
        snap = cl.registry.snapshot()["counters"]
        assert snap["cluster_cancelled_total"] == 1
        assert snap["http_client_disconnects_total"] == 1
    finally:
        if fe is not None:
            fe.close()
        cl.close()


def test_http_launcher_serves_the_seeded_torch_model():
    """``python -m mxnet_tpu_torch.tools.launch --launcher http``: the
    CLI prints its ``listening`` line, streams a request whose tokens
    equal ``generate`` of ``init_params(0, cfg)`` (a ``torch.Generator``
    seeded 0), and shuts down on SIGTERM with the cluster closed."""
    import torch
    from mxnet_tpu_torch.models import gpt
    geo = ["--vocab", "96", "--max-len", "32", "--d-model", "32",
           "--n-heads", "2", "--n-layers", "2", "--d-ff", "64",
           "--num-slots", "2", "--page-size", "4"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch",
         "--launcher", "http", "--", "--device", "cpu"] + geo,
        cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        host, port = line["listening"].rsplit(":", 1)
        assert line["disagg"] is False

        class _FE:
            pass
        fe = _FE()
        fe.host, fe.port = host, int(port)
        prompt = np.array([5, 9, 2, 7], np.int32)
        got = _roundtrip(fe, prompt, 6, stream=True)
        cfg = gpt.gpt_config(vocab_size=96, max_len=32, d_model=32,
                             n_heads=2, n_layers=2, d_ff=64, dropout=0.0,
                             use_flash=False, remat=False,
                             dtype="float32")
        params = gpt.init_params(0, cfg, device="cpu")
        with torch.no_grad():
            want = gpt.generate(params, cfg, prompt[None], 6,
                                device="cpu")[0].numpy()
        assert got == [int(t) for t in want[prompt.size:]]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(TIMEOUT) == 0
        assert json.loads(proc.stdout.readline()) == {"closed": True}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
