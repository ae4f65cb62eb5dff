"""Streaming HTTP/SSE front door for the serving clusters.

Port of ``mxnet_tpu/serving/http_frontend.py``: a stdlib-asyncio
HTTP/1.1 server (request parsing and chunked transfer encoding written
here, no third-party dependency) in front of :class:`ServingCluster` or
:class:`DisaggServingCluster`.  Wire behaviour: ``docs/http_api.md``.

* **Token streaming**: ``POST /v1/generate`` with ``"stream": true``
  answers as Server-Sent Events (``text/event-stream`` over chunked
  transfer encoding), one ``token`` event per committed token, fed from
  the cluster's per-token failover log through
  ``cluster.attach_stream``, so a stream survives a replica's or a
  worker's death without a gap or a repeat.  The cluster calls the
  stream callback from a replica's engine thread (in process) or from
  the router's receive thread (disaggregated); the callback only
  enqueues onto the event loop with one ``loop.call_soon_threadsafe``
  per event batch and touches no CUDA state, and the loop never blocks
  on ``result()``.
* **Cancellation**: a client disconnect (read-side EOF or a write
  error) cancels the request through ``cluster.cancel(rid)``: an
  in-process replica frees its pages and slot before its engine's next
  step, and the disaggregated router sends the generation-fenced
  ``cancel`` wire kind to both of the request's workers.
* **Edge admission**: per-tenant API keys (:class:`ApiKeyTable`; a JSON
  file, a dict or ``MXNET_SERVE_KEYS``) with token-bucket rates and
  in-flight quotas, checked before ``submit()``.  Quota breach: ``429``
  with ``Retry-After``; unknown key: ``401``; oversized body: ``413``;
  ``ClusterOverloaded``: ``429`` with the cluster's own
  ``retry_after_s`` (the cluster clamps it to its watchdog).  Every
  response carries an ``X-Request-Id``.
* **Observability**: ``GET /metrics`` serves the Prometheus text
  exposition (:func:`mxnet_tpu_torch.obs.prometheus_text`), ``GET
  /healthz`` the cluster's ``health()``, ``GET /debug/statusz`` and
  ``GET /debug/trace/<rid>`` the cluster's ``debug_status()`` and
  ``request_trace(rid)``; the front door's own counters land on the
  cluster's registry when metrics are on.

Environment: ``MXNET_SERVE_KEYS`` (a path to, or inline, key-table
JSON), ``MXNET_SERVE_HTTP_PORT``, ``MXNET_SERVE_HTTP_MAX_BODY`` (bytes,
default 1 MiB), ``MXNET_SERVE_HTTP_MAX_CONNECTIONS`` (default 1024;
over it a new connection gets ``503`` and is closed).

Clock: ``time.perf_counter`` throughout (the serving trace clock).

``python -m mxnet_tpu_torch.serving.http_frontend`` (:func:`main`)
serves a GPT with seeded random weights on the card (``--device``).
"""
from __future__ import annotations

import asyncio
import itertools
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cluster import ClusterOverloaded

__all__ = ["HttpFrontend", "ApiKeyTable", "TokenBucket",
           "parse_request_head", "sse_event", "chunk"]

_MiB = 1 << 20


def _env_int(name, fallback):
    v = os.environ.get(name)
    if v is None or v == "":
        return fallback
    try:
        return int(v)
    except ValueError:
        raise ValueError("%s=%r: expected int" % (name, v))


# ---------------------------------------------------------------------------
# wire-format helpers (pure functions: the FAST-tier unit surface)
# ---------------------------------------------------------------------------

def parse_request_head(head: bytes) -> Tuple[str, str, Dict[str, str]]:
    """Parse an HTTP/1.1 request head (everything up to and including
    the blank line) into ``(method, path, headers)`` with
    lower-cased, last-wins header names.  Raises ``ValueError`` on a
    malformed head — the caller answers 400."""
    try:
        text = head.decode("latin-1")
    except UnicodeDecodeError:              # pragma: no cover (latin-1
        raise ValueError("undecodable request head")  # never raises)
    lines = text.split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise ValueError("malformed request line: %r" % lines[0])
    method, path = parts[0], parts[1]
    if not path.startswith("/"):
        raise ValueError("malformed path: %r" % path)
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        if not ln:
            continue
        if ":" not in ln:
            raise ValueError("malformed header line: %r" % ln)
        k, v = ln.split(":", 1)
        headers[k.strip().lower()] = v.strip()
    return method, path, headers


def sse_event(event: str, data: dict) -> bytes:
    """One Server-Sent-Events frame: ``event:`` name + one-line JSON
    ``data:`` payload, blank-line terminated."""
    return ("event: %s\ndata: %s\n\n"
            % (event, json.dumps(data, separators=(",", ":")))
            ).encode()


def chunk(payload: bytes) -> bytes:
    """One HTTP/1.1 chunked-transfer-encoding chunk (hex length line,
    payload, CRLF).  ``chunk(b"")`` is the terminal chunk."""
    return b"%x\r\n%s\r\n" % (len(payload), payload)


def _status_line(code: int) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
              404: "Not Found", 405: "Method Not Allowed",
              408: "Request Timeout", 411: "Length Required",
              413: "Payload Too Large", 429: "Too Many Requests",
              500: "Internal Server Error",
              503: "Service Unavailable"}.get(code, "Error")
    return b"HTTP/1.1 %d %s\r\n" % (code, reason.encode())


# ---------------------------------------------------------------------------
# edge admission: API keys, token buckets, in-flight quotas
# ---------------------------------------------------------------------------

class TokenBucket:
    """Classic token bucket: ``burst`` capacity refilled at ``rate``
    tokens/s.  ``rate`` 0 means no refill (a hard burst budget — the
    quota-arithmetic shape the load proof checks exactly);
    ``rate`` None means unlimited.  Single-threaded by design: the
    front door mutates quota state only on its event loop."""

    def __init__(self, rate: Optional[float], burst: int):
        self.rate = rate
        self.burst = int(burst)
        self.tokens = float(burst)
        self.t = time.perf_counter()

    def take(self, now: Optional[float] = None):
        """Try to take one token.  Returns ``(ok, retry_after_s)``;
        ``retry_after_s`` is None when the bucket never refills."""
        if self.rate is None:
            return True, 0.0
        if now is None:
            now = time.perf_counter()
        if self.rate > 0:
            self.tokens = min(float(self.burst),
                              self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, 0.0
        if self.rate > 0:
            return False, (1.0 - self.tokens) / self.rate
        return False, None


class _Tenant:
    __slots__ = ("name", "bucket", "max_in_flight", "in_flight",
                 "accepted", "rejected")

    def __init__(self, name, rate, burst, max_in_flight):
        self.name = name
        self.bucket = TokenBucket(rate, burst)
        self.max_in_flight = max_in_flight
        self.in_flight = 0
        self.accepted = 0
        self.rejected = 0


class ApiKeyTable:
    """Static per-tenant API keys with admission quotas.

    The table maps **key string → tenant spec**::

        {"sk-tenant-a": {"tenant": "a", "rate": 10.0, "burst": 20,
                         "max_in_flight": 8},
         "sk-tenant-b": {"tenant": "b"}}          # unlimited

    Spec fields (all optional): ``tenant`` (display name, defaults to
    the key), ``rate`` (token-bucket refill per second; 0 = hard
    burst budget, absent = unlimited), ``burst`` (bucket capacity,
    default ``max(1, ceil(rate))``), ``max_in_flight`` (concurrent
    admitted requests, absent = unlimited).

    ``load()`` accepts a dict, inline JSON, or a file path — the
    ``MXNET_SERVE_KEYS`` env var takes either of the latter two."""

    def __init__(self, specs: Dict[str, dict]):
        self.tenants: Dict[str, _Tenant] = {}
        for key, spec in specs.items():
            spec = dict(spec or {})
            rate = spec.get("rate")
            if rate is not None:
                rate = float(rate)
            burst = int(spec.get("burst",
                                 1 if rate is None
                                 else max(1, math.ceil(rate))))
            mif = spec.get("max_in_flight")
            self.tenants[key] = _Tenant(
                spec.get("tenant", key), rate, burst,
                None if mif is None else int(mif))

    @classmethod
    def load(cls, spec) -> "ApiKeyTable":
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(spec)
        text = str(spec)
        if text.lstrip().startswith("{"):
            return cls(json.loads(text))
        with open(text) as f:
            return cls(json.load(f))

    def lookup(self, key: Optional[str]) -> Optional[_Tenant]:
        if key is None:
            return None
        return self.tenants.get(key)

    def snapshot(self) -> List[dict]:
        return [{"tenant": t.name, "in_flight": t.in_flight,
                 "accepted": t.accepted, "rejected": t.rejected}
                for t in self.tenants.values()]


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class _HttpObs:
    """Front-door instrument bundle on the CLUSTER registry — the
    front door is an edge of the cluster, not a separate system, so
    its counters scrape alongside ``cluster_*``."""

    def __init__(self, registry):
        c, g = registry.counter, registry.gauge
        self.requests = c("http_requests_total",
                          "HTTP requests parsed (all endpoints)")
        self.streams = c("http_streams_total",
                         "SSE generate streams opened")
        self.rej_auth = c("http_rejected_auth_total",
                          "401s: missing/unknown API key")
        self.rej_quota = c("http_rejected_quota_total",
                           "429s: tenant rate/in-flight quota, or "
                           "cluster backpressure surfaced at the "
                           "edge")
        self.rej_body = c("http_rejected_body_total",
                          "413s: body over MXNET_SERVE_HTTP_MAX_BODY")
        self.disconnects = c("http_client_disconnects_total",
                             "mid-stream client disconnects "
                             "propagated to cancel(rid)")
        self.g_conns = g("http_connections",
                         "currently open HTTP connections")


class HttpFrontend:
    """Asyncio HTTP/1.1 + SSE server over a serving cluster.

    ``start()`` runs the event loop on a daemon thread and returns
    once the socket is bound (``self.port`` then holds the real
    port); ``close()`` stops it.  The server owns NO cluster
    lifecycle — closing the front door leaves the cluster running.

    Endpoints (full reference: ``docs/http_api.md``):

    * ``POST /v1/generate`` — body ``{"prompt": [ints], "max_new_tokens":
      N, "eos_id"?, "ttl_s"?, "stream"?}``; SSE stream or JSON.
    * ``GET /healthz`` — cluster ``health()`` as JSON.
    * ``GET /metrics`` — Prometheus text exposition.
    """

    def __init__(self, cluster, *, host="127.0.0.1", port=None,
                 keys=None, max_body=None, max_connections=None):
        self.cluster = cluster
        self.host = host
        if port is None:
            port = _env_int("MXNET_SERVE_HTTP_PORT", 0)
        self.port = int(port)
        if max_body is None:
            max_body = _env_int("MXNET_SERVE_HTTP_MAX_BODY", _MiB)
        self.max_body = int(max_body)
        if max_connections is None:
            max_connections = _env_int(
                "MXNET_SERVE_HTTP_MAX_CONNECTIONS", 1024)
        self.max_connections = int(max_connections)
        if keys is None:
            keys = os.environ.get("MXNET_SERVE_KEYS") or None
        self.keys = None if keys is None else ApiKeyTable.load(keys)
        reg = cluster.registry
        self._obs = _HttpObs(reg) if reg is not None else None
        self._rid_seq = itertools.count(1)
        self._active = 0                   # event-loop-thread only
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None

    # ------------------------------------------------------ lifecycle --
    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="http-frontend")
        self._thread.start()
        if not self._ready.wait(30) or self._startup_error is not None:
            raise RuntimeError("HttpFrontend failed to start: %r"
                               % (self._startup_error,))
        return self

    def _run(self):
        try:
            asyncio.run(self._main())
        except BaseException as e:          # surface bind errors etc.
            self._startup_error = e
            self._ready.set()

    async def _main(self):
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        server = await asyncio.start_server(
            self._serve_conn, self.host, self.port, limit=256 * 1024)
        self.port = server.sockets[0].getsockname()[1]
        self._ready.set()
        async with server:
            await self._stop.wait()
        # asyncio.run cancels lingering per-connection tasks on exit

    def close(self, timeout=10.0):
        if self._loop is not None and self._stop is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:
                pass                       # loop already gone
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.close()

    # ------------------------------------------------------ plumbing --
    async def _send(self, writer, code, body: bytes,
                    ctype="application/json", req_id=None,
                    extra=(), close=False):
        head = [_status_line(code),
                b"Content-Type: %s\r\n" % ctype.encode(),
                b"Content-Length: %d\r\n" % len(body)]
        if req_id is not None:
            head.append(b"X-Request-Id: %s\r\n" % req_id.encode())
        for k, v in extra:
            head.append(("%s: %s\r\n" % (k, v)).encode())
        head.append(b"Connection: close\r\n" if close
                    else b"Connection: keep-alive\r\n")
        head.append(b"\r\n")
        writer.write(b"".join(head) + body)
        await writer.drain()

    async def _send_json(self, writer, code, obj, req_id=None,
                         extra=(), close=False):
        await self._send(writer, code,
                         json.dumps(obj).encode() + b"\n",
                         req_id=req_id, extra=extra, close=close)

    @staticmethod
    def _auth_key(headers) -> Optional[str]:
        auth = headers.get("authorization")
        if auth and auth.lower().startswith("bearer "):
            return auth[7:].strip()
        return headers.get("x-api-key")

    # ---------------------------------------------------- connection --
    async def _serve_conn(self, reader, writer):
        obs = self._obs
        if self._active >= self.max_connections:
            # over the edge cap: refuse outright — the bounded
            # admission queue is the CLUSTER's backpressure; this cap
            # protects the event loop itself
            try:
                await self._send_json(
                    writer, 503, {"error": "connection limit"},
                    req_id="r%06d" % next(self._rid_seq),
                    extra=[("Retry-After", "1")], close=True)
            except OSError:
                pass
            writer.close()
            try:
                # close() only schedules the close — wait for the
                # transport to drain so refused connections can't
                # pile up half-closed under an overload burst
                await writer.wait_closed()
            except OSError:
                pass
            return
        self._active += 1
        if obs is not None:
            obs.g_conns.set(self._active)
        try:
            await self._conn_loop(reader, writer)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionResetError, BrokenPipeError,
                asyncio.TimeoutError, OSError):
            pass                           # peer went away mid-parse
        finally:
            self._active -= 1
            if obs is not None:
                obs.g_conns.set(self._active)
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:
                pass

    async def _conn_loop(self, reader, writer):
        """Keep-alive loop: one request head at a time; SSE responses
        and error paths close the connection."""
        while True:
            try:
                head = await reader.readuntil(b"\r\n\r\n")
            except asyncio.IncompleteReadError:
                return                     # clean keep-alive close
            except asyncio.LimitOverrunError:
                # head larger than the stream limit (256 KiB): answer
                # like every other malformed input instead of a
                # silent close
                await self._send_json(
                    writer, 400, {"error": "request head too large"},
                    req_id="r%06d" % next(self._rid_seq), close=True)
                return
            try:
                method, path, headers = parse_request_head(head)
            except ValueError as e:
                await self._send_json(
                    writer, 400, {"error": str(e)},
                    req_id="r%06d" % next(self._rid_seq), close=True)
                return
            req_id = "r%06d" % next(self._rid_seq)
            if self._obs is not None:
                self._obs.requests.inc()
            # honor the client's keep-alive choice: a `Connection:
            # close` request gets its response and the socket closed
            # (open-loop bench clients read-until-EOF per request)
            want_close = headers.get("connection",
                                     "").lower() == "close"
            if path == "/healthz" or path == "/metrics":
                if method != "GET":
                    await self._send_json(
                        writer, 405, {"error": "GET only"},
                        req_id=req_id, close=True)
                    return
                if path == "/healthz":
                    await self._handle_healthz(writer, req_id)
                else:
                    await self._handle_metrics(writer, req_id)
                if want_close:
                    return
                continue
            if path == "/debug/statusz" \
                    or path.startswith("/debug/trace/"):
                # ops introspection: the same operator surface as
                # /metrics; GET only, unauthenticated, read-only
                # snapshots off the executor
                if method != "GET":
                    await self._send_json(
                        writer, 405, {"error": "GET only"},
                        req_id=req_id, close=True)
                    return
                if path == "/debug/statusz":
                    await self._handle_statusz(writer, req_id)
                else:
                    await self._handle_trace(writer, path, req_id)
                if want_close:
                    return
                continue
            if path != "/v1/generate":
                await self._send_json(
                    writer, 404, {"error": "unknown path %s" % path},
                    req_id=req_id, close=True)
                return
            if method != "POST":
                await self._send_json(
                    writer, 405, {"error": "POST only"},
                    req_id=req_id, close=True)
                return
            closing = await self._handle_generate(
                reader, writer, headers, req_id)
            if closing or want_close:
                return

    async def _handle_healthz(self, writer, req_id):
        health = await self._in_executor(self.cluster.health)
        ok = any(h.get("alive") for h in health)
        body = {"ok": ok, "health": health}
        if self.keys is not None:
            body["tenants"] = self.keys.snapshot()
        await self._send_json(writer, 200 if ok else 503, body,
                              req_id=req_id)

    async def _handle_metrics(self, writer, req_id):
        from ..obs import prometheus_text
        text = await self._in_executor(prometheus_text)
        await self._send(writer, 200, text.encode(),
                         ctype="text/plain; version=0.0.4",
                         req_id=req_id)

    def _in_executor(self, fn, *args):
        return asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    # ---------------------------------------------------------- debug --
    async def _handle_statusz(self, writer, req_id):
        """``GET /debug/statusz``: live topology, per-worker health,
        clock offsets and tier occupancy, in-flight request states and
        SLO burn gauges: whatever snapshot the attached cluster flavor
        provides."""
        fn = getattr(self.cluster, "debug_status", None)
        if fn is None:
            await self._send_json(
                writer, 404,
                {"error": "cluster has no debug_status surface",
                 "request_id": req_id}, req_id=req_id, close=True)
            return
        status = await self._in_executor(fn)
        status["request_id"] = req_id
        await self._send_json(writer, 200, status, req_id=req_id)

    async def _handle_trace(self, writer, path, req_id):
        """``GET /debug/trace/<rid>``: the router's view of one
        request's timeline plus every span workers shipped for it."""
        tail = path[len("/debug/trace/"):]
        try:
            rid = int(tail)
        except ValueError:
            await self._send_json(
                writer, 400,
                {"error": "bad rid %r" % tail, "request_id": req_id},
                req_id=req_id, close=True)
            return
        fn = getattr(self.cluster, "request_trace", None)
        if fn is None:
            await self._send_json(
                writer, 404,
                {"error": "cluster has no request_trace surface",
                 "request_id": req_id}, req_id=req_id, close=True)
            return
        try:
            trace = await self._in_executor(fn, rid)
        except KeyError:
            await self._send_json(
                writer, 404,
                {"error": "unknown rid %d" % rid,
                 "request_id": req_id}, req_id=req_id, close=True)
            return
        trace["request_id"] = req_id
        await self._send_json(writer, 200, trace, req_id=req_id)

    # ------------------------------------------------------ generate --
    async def _handle_generate(self, reader, writer, headers, req_id):
        """Returns True when the connection must close (SSE/errors)."""
        obs = self._obs
        # ---- edge admission, strictly BEFORE submit(): auth is
        # checked on the headers alone (an unauthorized caller must
        # not cost a body buffer), size on the declared length, and
        # the quota spend comes last — only a request that would
        # otherwise be admitted drains the bucket
        tenant = None
        if self.keys is not None:
            tenant = self.keys.lookup(self._auth_key(headers))
            if tenant is None:
                if obs is not None:
                    obs.rej_auth.inc()
                await self._send_json(
                    writer, 401, {"error": "unknown or missing API "
                                           "key", "request_id": req_id},
                    req_id=req_id, close=True)
                return True
        # ---- body size: declared length is checked before the quota
        # spend — an oversized request is refused on its headers alone
        # and must not burn a bucket token (the load proof's 429
        # arithmetic counts only well-formed requests)
        clen = headers.get("content-length")
        if clen is None or not clen.isdigit():
            await self._send_json(
                writer, 411, {"error": "Content-Length required",
                              "request_id": req_id},
                req_id=req_id, close=True)
            return True
        clen = int(clen)
        if clen > self.max_body:
            if obs is not None:
                obs.rej_body.inc()
            await self._send_json(
                writer, 413,
                {"error": "body %d > max %d bytes"
                 % (clen, self.max_body), "request_id": req_id},
                req_id=req_id, close=True)
            return True
        body = await reader.readexactly(clen)
        try:
            req = json.loads(body)
            prompt = np.asarray(req["prompt"], np.int32).reshape(-1)
            max_new = int(req.get("max_new_tokens", 16))
            eos_id = req.get("eos_id")
            ttl_s = req.get("ttl_s")
            stream = bool(req.get("stream", True))
        except (ValueError, KeyError, TypeError) as e:
            await self._send_json(
                writer, 400, {"error": "bad request body: %r" % (e,),
                              "request_id": req_id},
                req_id=req_id, close=True)
            return True
        # ---- quota spend, last edge stop before submit(): only a
        # well-formed, rightly-sized, authenticated request costs a
        # bucket token or an in-flight slot — the load proof's 429
        # arithmetic depends on malformed traffic not draining quota
        if tenant is not None:
            if tenant.max_in_flight is not None \
                    and tenant.in_flight >= tenant.max_in_flight:
                tenant.rejected += 1
                if obs is not None:
                    obs.rej_quota.inc()
                await self._send_json(
                    writer, 429,
                    {"error": "tenant %s at max_in_flight %d"
                     % (tenant.name, tenant.max_in_flight),
                     "request_id": req_id},
                    req_id=req_id, extra=[("Retry-After", "1")],
                    close=True)
                return True
            ok, retry = tenant.bucket.take()
            if not ok:
                tenant.rejected += 1
                if obs is not None:
                    obs.rej_quota.inc()
                retry_s = 60.0 if retry is None else max(0.001, retry)
                await self._send_json(
                    writer, 429,
                    {"error": "tenant %s rate limit" % tenant.name,
                     "retry_after_s": retry_s, "request_id": req_id},
                    req_id=req_id,
                    extra=[("Retry-After",
                            str(int(math.ceil(retry_s))))],
                    close=True)
                return True
            # past every edge check: the request is edge-ACCEPTED
            # (what happens next — ClusterOverloaded, engine error —
            # is the cluster's accounting, not the tenant quota's, so
            # accepted + rejected partitions the tenant's traffic)
            tenant.accepted += 1
        # ---- submit (executor: submit takes the cluster lock)
        if tenant is not None:
            tenant.in_flight += 1
        try:
            return await self._run_request(
                writer, reader, prompt, max_new, eos_id, ttl_s,
                stream, req_id)
        finally:
            if tenant is not None:
                tenant.in_flight -= 1

    def _submit(self, prompt, max_new, eos_id, ttl_s, req_id):
        # the edge mints the trace context: X-Request-Id IS the
        # trace_id, so the access log, the engine trace instants, and
        # the cluster-wide merged trace all correlate by one string
        kw = {"trace_id": req_id}
        if ttl_s is not None:
            kw["ttl_s"] = float(ttl_s)
        try:
            return self.cluster.submit(prompt, max_new,
                                       eos_id=eos_id, **kw)
        except TypeError:
            # cluster flavors without an optional kwarg (the
            # disaggregated one takes no ttl_s): shed the kwarg, never
            # the request
            try:
                kw.pop("ttl_s", None)
                return self.cluster.submit(prompt, max_new,
                                           eos_id=eos_id, **kw)
            except TypeError:
                return self.cluster.submit(prompt, max_new,
                                           eos_id=eos_id)

    async def _run_request(self, writer, reader, prompt, max_new,
                           eos_id, ttl_s, stream, req_id):
        obs = self._obs
        loop = asyncio.get_running_loop()
        try:
            rid = await self._in_executor(
                lambda: self._submit(prompt, max_new, eos_id, ttl_s,
                                     req_id))
        except ClusterOverloaded as e:
            if obs is not None:
                obs.rej_quota.inc()
            retry_s = e.retry_after_s or 1.0
            await self._send_json(
                writer, 429,
                {"error": str(e), "retry_after_s": retry_s,
                 "request_id": req_id},
                req_id=req_id,
                extra=[("Retry-After", str(int(math.ceil(retry_s))))],
                close=True)
            return True
        except ValueError as e:
            await self._send_json(
                writer, 400, {"error": str(e), "request_id": req_id},
                req_id=req_id, close=True)
            return True
        except Exception as e:
            await self._send_json(
                writer, 503, {"error": repr(e),
                              "request_id": req_id},
                req_id=req_id, close=True)
            return True
        q: "asyncio.Queue" = asyncio.Queue()

        def feed(evt):
            # called from a CLUSTER thread: the only cross-thread
            # touch on asyncio state.  The loop can close between the
            # last token and the callback (front door shutting down
            # mid-stream) — drop the event rather than crash the
            # cluster's completion thread
            try:
                loop.call_soon_threadsafe(q.put_nowait, evt)
            except RuntimeError:
                pass

        await self._in_executor(self.cluster.attach_stream, rid, feed)
        if stream:
            if obs is not None:
                obs.streams.inc()
            await self._stream_sse(writer, reader, q, rid, prompt,
                                   req_id)
            return True                    # SSE always closes
        return await self._respond_json(writer, reader, q, rid,
                                        prompt, req_id)

    async def _wait_stream_event(self, getter, monitor_box, reader,
                                 rid):
        """Await the next queue event while watching the socket's read
        side (``monitor_box`` holds the one live read task so callers
        can re-arm/cancel it).  Returns the event, or None when the
        client disconnected (EOF/RST — the request is cancelled here).
        Data arriving mid-wait (a pipelined next request) keeps the
        stream alive but is DROPPED and flags the connection to close
        after the in-flight response — this server does not support
        HTTP pipelining, and closing is the honest refusal (the
        client retries; we never misparse a stolen byte)."""
        pipelined = False
        while True:
            done, _ = await asyncio.wait(
                {getter, monitor_box[0]},
                return_when=asyncio.FIRST_COMPLETED)
            if monitor_box[0] in done:
                try:
                    data = monitor_box[0].result()
                except (ConnectionResetError, BrokenPipeError,
                        OSError):
                    data = b""             # RST reads as a raise
                if not data:               # EOF: client disconnected
                    getter.cancel()
                    await self._cancel_disconnected(rid)
                    return None, pipelined
                pipelined = True
                monitor_box[0] = asyncio.ensure_future(
                    reader.read(4096))
                if getter in done:
                    return getter.result(), pipelined
                continue
            return getter.result(), pipelined

    async def _respond_json(self, writer, reader, q, rid, prompt,
                            req_id):
        """JSON mode shares the SSE path's disconnect detection: the
        read side is watched while the request runs, so a gone client
        cancels the request instead of decoding to completion for
        nobody."""
        monitor_box = [asyncio.ensure_future(reader.read(4096))]
        getter = None
        must_close = False
        try:
            while True:
                getter = asyncio.ensure_future(q.get())
                evt, pipelined = await self._wait_stream_event(
                    getter, monitor_box, reader, rid)
                must_close = must_close or pipelined
                if evt is None:            # disconnected
                    return True
                kind, payload = evt
                if kind == "tokens":
                    continue               # buffered by the cluster
                if kind == "done":
                    # retire the monitor BEFORE writing: a cancelled-
                    # in-time read leaves the next keep-alive
                    # request's bytes in the stream buffer; one that
                    # already completed stole them (pipelining or an
                    # EOF racing the response) — then close, so a
                    # stolen byte can never misparse request N+1.
                    # The cancel must be AWAITED: StreamReader allows
                    # one waiter, and the next readuntil would hit
                    # "another coroutine is already waiting" while
                    # the cancelled read is still pending
                    mon = monitor_box[0]
                    if mon.done():
                        must_close = True
                    else:
                        mon.cancel()
                        try:
                            await mon
                        except (asyncio.CancelledError, OSError):
                            pass
                    await self._send_json(
                        writer, 200,
                        {"request_id": req_id, "rid": rid,
                         "prompt_len": int(prompt.size),
                         "tokens": [int(t) for t in
                                    payload[prompt.size:]]},
                        req_id=req_id, close=must_close)
                    return must_close      # keep-alive unless flagged
                await self._send_json(     # ("error", exc)
                    writer, 503,
                    {"error": repr(payload), "request_id": req_id,
                     "rid": rid},
                    req_id=req_id, close=True)
                return True
        finally:
            monitor_box[0].cancel()
            if getter is not None and not getter.done():
                getter.cancel()

    async def _stream_sse(self, writer, reader, q, rid, prompt,
                          req_id):
        """The SSE hot path.  Disconnect detection is the read side:
        a well-behaved SSE client sends nothing after the request, so
        the pending ``reader.read`` completes only on EOF/reset —
        which is exactly the moment to ``cancel(rid)``.  Write errors
        (peer gone mid-burst) propagate the same way."""
        writer.write(
            _status_line(200)
            + b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Transfer-Encoding: chunked\r\n"
            + b"X-Request-Id: %s\r\n" % req_id.encode()
            + b"Connection: close\r\n\r\n")
        n_sent = 0
        monitor_box = [asyncio.ensure_future(reader.read(4096))]
        getter = None
        try:
            await writer.drain()
            while True:
                getter = asyncio.ensure_future(q.get())
                evt, _ = await self._wait_stream_event(
                    getter, monitor_box, reader, rid)
                if evt is None:            # EOF: client disconnected
                    return
                kind, payload = evt
                if kind == "tokens":
                    out = b"".join(
                        chunk(sse_event("token",
                                        {"i": n_sent + j, "t": t}))
                        for j, t in enumerate(payload))
                    n_sent += len(payload)
                    writer.write(out)
                    await writer.drain()
                elif kind == "done":
                    writer.write(chunk(sse_event(
                        "done", {"request_id": req_id, "rid": rid,
                                 "prompt_len": int(prompt.size),
                                 "n": n_sent})) + chunk(b""))
                    await writer.drain()
                    return
                else:
                    writer.write(chunk(sse_event(
                        "error", {"error": repr(payload),
                                  "request_id": req_id})) + chunk(b""))
                    await writer.drain()
                    return
        except (ConnectionResetError, BrokenPipeError, OSError):
            await self._cancel_disconnected(rid)
        finally:
            monitor_box[0].cancel()
            if getter is not None and not getter.done():
                getter.cancel()

    async def _cancel_disconnected(self, rid):
        if self._obs is not None:
            self._obs.disconnects.inc()
        try:
            await self._in_executor(self.cluster.cancel, rid)
        except KeyError:
            pass                           # already purged: moot


# ---------------------------------------------------------------------------
# CLI: ``python -m mxnet_tpu_torch.serving.http_frontend``, the entry
# ``tools/launch.py --launcher http`` starts (a GPT with seeded random
# weights; a deployment embeds HttpFrontend over its own cluster)
# ---------------------------------------------------------------------------

def main(argv=None):
    import argparse
    import signal
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None,
                    help="default: MXNET_SERVE_HTTP_PORT or an "
                         "OS-assigned port (printed at startup)")
    ap.add_argument("--keys", default=None, metavar="FILE|JSON",
                    help="API key table (default: MXNET_SERVE_KEYS; "
                         "absent = open access)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (default: cuda)")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--disagg", action="store_true",
                    help="front a DisaggServingCluster (spawns "
                         "--prefill/--decode worker processes)")
    ap.add_argument("--prefill", type=int, default=1)
    ap.add_argument("--decode", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    args = ap.parse_args(argv)

    # a float32 GPT of the flags' shape, its weights drawn from a
    # torch.Generator seeded 0 (the reference draws from
    # jax.random.PRNGKey(0), which torch cannot reproduce)
    from ..models import gpt
    cfg = gpt.gpt_config(
        vocab_size=args.vocab, max_len=args.max_len,
        d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, dropout=0.0,
        use_flash=False, remat=False, dtype="float32")
    params = gpt.init_params(0, cfg, device=args.device)
    kw = dict(num_slots=args.num_slots, page_size=args.page_size,
              metrics=True, device=args.device)
    if args.disagg:
        from .cluster import DisaggServingCluster
        cl = DisaggServingCluster(params, cfg, prefill=args.prefill,
                                  decode=args.decode, **kw)
    else:
        from .cluster import ServingCluster
        cl = ServingCluster(params, cfg, replicas=args.replicas, **kw)
    fe = HttpFrontend(cl, host=args.host, port=args.port,
                      keys=args.keys).start()
    print(json.dumps({"listening": "%s:%d" % (fe.host, fe.port),
                      "disagg": bool(args.disagg)}), flush=True)
    stop = threading.Event()
    # SIGTERM (a launcher's or a supervisor's stop) shuts down cleanly
    # like ^C: the front door, then the cluster and its workers
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        while not stop.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        fe.close()
        cl.close()
    print(json.dumps({"closed": True}), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
