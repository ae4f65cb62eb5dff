"""The parameter server: ``dist_sync`` and ``dist_async`` stores.

Port of ``mxnet_tpu/parallel/dist.py`` (MXNet's ``kvstore_dist.h`` and
``kvstore_dist_server.h`` over ps-lite), over TCP between processes:

* ``dist_sync``: the server waits for every worker's push of a key's
  round, sums them and applies the update once; pulls of that round
  wait for it.  ``dist_async``: each push is applied on arrival.
* The optimizer that worker 0 ships (``set_optimizer``, MXNet's
  ``update_on_kvstore``) runs on the server; without one the server
  sums.
* Keys are sharded over ``DMLC_NUM_SERVER`` servers by a stable hash
  (server ``i`` listens on ``DMLC_PS_ROOT_PORT + i``), and ``barrier``
  waits for every worker.
* Optional 2-bit compression with error feedback
  (``parallel/compression.py``) rides the push.

The wire is the reference's, so either package's worker talks to either
package's server: length-prefixed pickled message tuples (``("push",
key, value, rank, round)``, ...), and a second frame kind, the raw
frame (:func:`send_frame`/:func:`recv_frame`), whose length prefix
carries a flag bit and whose payload is a small pickled header followed
by raw byte buffers that are never pickled.  Reads are bounded by
``MAX_FRAME_BYTES``, retry on EINTR, and read a reset connection as
EOF (``None``).

Values cross the wire as numpy arrays.  A worker reads each pushed
value to the host once (``_to_numpy``) and writes a pulled value into
``out`` on ``out``'s own device.  The server keeps its store in numpy;
a server that was shipped an optimizer runs the updater on the context
it was given (``DistServer(ctx=...)``, by default the card), so a
sum-only server needs no device.
"""
from __future__ import annotations

import os
import pickle
import queue
import socket
import struct
import threading
import time
from typing import Dict

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["DistServer", "DistKVStore", "create_dist_kvstore",
           "run_server", "send_frame", "recv_frame", "MAX_FRAME_BYTES"]


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

# the bound on any one frame component (a pickled message, a raw frame's
# header, one raw buffer): a garbage length prefix fails the connection
# instead of allocating it
MAX_FRAME_BYTES = 1 << 31

# the high bit of the length prefix marks a raw frame; the other 63 bits
# are its header's length
_RAW_FLAG = 1 << 63


def _send(sock: socket.socket, obj):
    """Send one pickled message; returns the bytes sent."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(data)) + data)
    return 8 + len(data)


def _check_len(n):
    if n > MAX_FRAME_BYTES:
        raise MXNetError(
            "dist wire: frame length %d exceeds MAX_FRAME_BYTES %d — "
            "garbage/oversized length prefix (peer killed mid-frame, "
            "or a foreign protocol on this port)" % (n, MAX_FRAME_BYTES))
    return n


def _recv_sized(sock: socket.socket):
    """(message, bytes read), or (None, 0) at EOF."""
    hdr = _recv_exact(sock, 8)
    if hdr is None:
        return None, 0
    (n,) = struct.unpack("<Q", hdr)
    if n & _RAW_FLAG:
        raise MXNetError(
            "dist wire: raw frame on a pickled-protocol connection "
            "(use recv_frame on transport endpoints)")
    data = _recv_exact(sock, _check_len(n))
    if data is None:
        return None, 0
    return pickle.loads(data), 8 + n


def _recv(sock: socket.socket):
    return _recv_sized(sock)[0]


def _recv_exact(sock, n):
    """Exactly ``n`` bytes, or ``None`` on EOF or an abortive close (a
    reset, a socket closed under the reader); EINTR retries."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:])
        except InterruptedError:
            continue
        except socket.timeout:            # the caller's poll signal
            raise
        except OSError:
            return None
        if r == 0:
            return None
        got += r
    return bytes(buf) if n <= 64 else buf


def send_frame(sock: socket.socket, meta, bufs=()):
    """Send a raw frame: a small pickled ``meta`` header, then N raw
    byte buffers through ``sendall(memoryview)``, neither pickled nor
    concatenated (the header and the length words go in one send)."""
    mb = pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL)
    views = [memoryview(b).cast("B") for b in bufs]
    head = [struct.pack("<Q", _RAW_FLAG | len(mb)), mb,
            struct.pack("<I", len(views))]
    head.append(b"".join(struct.pack("<Q", v.nbytes) for v in views))
    sock.sendall(b"".join(head))
    for v in views:
        sock.sendall(v)


def recv_frame(sock: socket.socket):
    """Receive either frame kind: ``(meta, bufs)`` for a raw frame
    (``bufs`` a list of bytearrays), ``(obj, None)`` for a pickled
    message, ``None`` at EOF or on a reset."""
    hdr = _recv_exact(sock, 8)
    if hdr is None:
        return None
    (n,) = struct.unpack("<Q", hdr)
    if not n & _RAW_FLAG:
        data = _recv_exact(sock, _check_len(n))
        if data is None:
            return None
        return pickle.loads(data), None
    mb = _recv_exact(sock, _check_len(n & ~_RAW_FLAG))
    if mb is None:
        return None
    meta = pickle.loads(mb)
    cnt = _recv_exact(sock, 4)
    if cnt is None:
        return None
    (nbuf,) = struct.unpack("<I", cnt)
    if nbuf > 4096:
        raise MXNetError("dist wire: raw frame claims %d buffers — "
                         "garbage header" % nbuf)
    lens = _recv_exact(sock, 8 * nbuf)
    if lens is None and nbuf:
        return None
    sizes = struct.unpack("<%dQ" % nbuf, bytes(lens or b""))
    bufs = []
    for sz in sizes:
        b = _recv_exact(sock, _check_len(sz))
        if b is None:
            return None
        bufs.append(b if isinstance(b, bytearray) else bytearray(b))
    return meta, bufs


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class DistServer:
    """The server role (reference ``KVStoreDistServer``).

    ``dist_sync`` buffers a key's pushes of one round until every worker
    gave its own, then sums them (or runs the updater) once and wakes
    the pulls; ``dist_async`` applies each push on arrival.  The
    optimizer arrives from worker 0 pickled; its updater runs on
    ``ctx`` (default: the current context, the card).
    ``exit_on_idle`` shuts the server down once every worker rank has
    connected and every connection closed again (the launcher's
    servers, which no tracker stops under ``mpirun``).
    """

    def __init__(self, host="127.0.0.1", port=0, num_workers=1,
                 sync_mode=True, exit_on_idle=False, ctx=None):
        self.num_workers = num_workers
        self.sync_mode = sync_mode
        self.exit_on_idle = exit_on_idle
        self.ctx = ctx
        self._conn_seen = 0
        self._conn_active = 0
        self._ranks_seen = set()
        self.store: Dict[object, np.ndarray] = {}
        self._pending: Dict[object, dict] = {}
        self._version: Dict[object, int] = {}
        self._updater = None
        self._cv = threading.Condition()
        self._barrier_count = 0
        self._barrier_gen = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(num_workers * 2 + 8)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._threads = []

    def serve_forever(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def start(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._stop = True
        # close() alone does not wake a thread blocked in accept()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _apply_push(self, key, agg):
        cur = self.store.get(key)
        if self._updater is not None and cur is not None:
            from .. import ndarray as nd
            from ..context import current_context
            ctx = self.ctx if self.ctx is not None else current_context()
            w = nd.array(cur, ctx=ctx)
            g = nd.array(agg, ctx=ctx)
            idx = key if isinstance(key, int) else abs(hash(key)) % (2**31)
            self._updater(idx, g, w)
            self.store[key] = w.asnumpy()
        elif cur is not None:
            self.store[key] = cur + agg
        else:
            self.store[key] = agg
        self._version[key] = self._version.get(key, 0) + 1

    def _handle(self, conn):
        with self._cv:
            self._conn_seen += 1
            self._conn_active += 1
        try:
            self._handle_loop(conn)
        finally:
            with self._cv:
                self._conn_active -= 1
                idle = (self.exit_on_idle and self._conn_active == 0
                        and len(self._ranks_seen) >= self.num_workers)
            if idle:
                self.shutdown()

    def _handle_loop(self, conn):
        while True:
            msg = _recv(conn)
            if msg is None:
                break
            cmd = msg[0]
            if cmd == "init":
                _, key, value = msg
                with self._cv:
                    if key not in self.store:
                        self.store[key] = np.asarray(value)
                        self._version[key] = 1
                    self._cv.notify_all()
                _send(conn, ("ok",))
            elif cmd in ("push", "cpush"):
                # (cmd, key, value, rank, round): a sync round is keyed
                # by (key, round) and filled by rank, so a fast worker's
                # next round never counts into this one
                if cmd == "cpush":
                    _, key, (payload, shape, dtype, thr), rank, rnd = msg
                    from .compression import decompress
                    value = decompress(payload, shape, thr, dtype)
                else:
                    _, key, value, rank, rnd = msg
                value = np.asarray(value)
                with self._cv:
                    self._ranks_seen.add(rank)
                    if self.sync_mode:
                        bucket = self._pending.setdefault((key, rnd), {})
                        bucket[rank] = value
                        if len(bucket) == self.num_workers:
                            del self._pending[(key, rnd)]
                            agg = np.sum(list(bucket.values()), axis=0)
                            self._apply_push(key, agg)
                            self._cv.notify_all()
                    else:
                        self._apply_push(key, value)
                        self._cv.notify_all()
                _send(conn, ("ok",))
            elif cmd == "pull":
                _, key, min_version = msg
                with self._cv:
                    while (key not in self.store or
                           self._version.get(key, 0) < min_version):
                        self._cv.wait(timeout=60)
                    val = self.store[key]
                _send(conn, ("val", val))
            elif cmd == "version":
                _, key = msg
                with self._cv:
                    _send(conn, ("ver", self._version.get(key, 0)))
            elif cmd == "barrier":
                with self._cv:
                    gen = self._barrier_gen
                    self._barrier_count += 1
                    if self._barrier_count == self.num_workers:
                        self._barrier_count = 0
                        self._barrier_gen += 1
                        self._cv.notify_all()
                    else:
                        while self._barrier_gen == gen:
                            self._cv.wait(timeout=60)
                _send(conn, ("ok",))
            elif cmd == "optimizer":
                _, blob = msg
                from .. import optimizer as opt
                self._updater = opt.get_updater(pickle.loads(blob))
                _send(conn, ("ok",))
            elif cmd == "hello":
                # a worker names its rank on connect: the idle exit arms
                # once every rank said hello
                _, rank = msg
                with self._cv:
                    self._ranks_seen.add(rank)
                _send(conn, ("ok",))
            elif cmd == "stop":
                _send(conn, ("ok",))
                self.shutdown()
                break
            else:
                _send(conn, ("err", "unknown command %r" % (cmd,)))
        conn.close()


def run_server():
    """The server role's entry point (the launcher's ``DMLC_ROLE=server``
    process): server ``DMLC_SERVER_ID`` listens on ``DMLC_PS_ROOT_PORT``
    plus its id, on every interface (under ``mpirun`` it may land on any
    node), and exits once its workers are gone."""
    port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
    sid = int(os.environ.get("DMLC_SERVER_ID", "0"))
    nworkers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    sync = os.environ.get("MXNET_KVSTORE_MODE", "dist_sync") != "dist_async"
    server = DistServer(host="0.0.0.0", port=port + sid,
                        num_workers=nworkers, sync_mode=sync,
                        exit_on_idle=True)
    server.serve_forever()


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

class DistKVStore:
    """The worker's store (reference ``KVStoreDist``).

    A push first sums its values across this worker's contexts, then
    goes to the key's server from a sender thread, so the transfer
    overlaps the caller's compute; ``pull``, ``init``, ``barrier`` and
    ``set_optimizer`` wait for the queued pushes and raise a push's
    error there.  ``wire_bytes()`` counts the bytes sent and received.
    """

    def __init__(self, name="dist_sync"):
        self.type = name
        self._sync = "async" not in name
        host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
        self._rank = int(os.environ.get("DMLC_WORKER_ID",
                                        os.environ.get("DMLC_RANK", "0")))
        self._num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        self._num_servers = max(1, int(os.environ.get("DMLC_NUM_SERVER",
                                                      "1")))
        self._socks = []
        deadline = time.time() + float(
            os.environ.get("MXNET_KVSTORE_CONNECT_TIMEOUT", "30"))
        for sid in range(self._num_servers):
            sock = None
            last_err = None
            while time.time() < deadline:
                try:
                    sock = socket.create_connection((host, port + sid),
                                                    timeout=60)
                    break
                except OSError as e:
                    last_err = e
                    time.sleep(0.05)
            if sock is None:
                raise MXNetError(
                    "cannot reach kvstore server %d at %s:%d (%s)"
                    % (sid, host, port + sid, last_err))
            self._socks.append(sock)
        self._lock = threading.Lock()
        self._sent = 0
        self._received = 0
        for sock in self._socks:
            self._sent += _send(sock, ("hello", self._rank))
            self._received += _recv_sized(sock)[1]
        self._pull_version: Dict[object, int] = {}
        self._push_round: Dict[object, int] = {}
        self._compressor = None
        self._async_push = os.environ.get(
            "MXNET_KVSTORE_ASYNC_PUSH", "1").lower() not in (
                "0", "false", "off")
        self._q: "queue.Queue" = queue.Queue()
        self._q_exc = None
        self._sender = None
        if self._async_push:
            self._sender = threading.Thread(target=self._sender_loop,
                                            daemon=True)
            self._sender.start()

    # -- the sender thread -------------------------------------------------
    def _sender_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            msg, key = item
            try:
                # after a failure the store is poisoned (_drain raises
                # from then on), so the rest of the queue is skipped
                if self._q_exc is None:
                    self._rpc(*msg, key=key)
            except Exception as e:  # noqa: BLE001 — raised at the sync
                self._q_exc = e
            finally:
                self._q.task_done()

    def _enqueue_rpc(self, *msg, key=None):
        if self._async_push:
            self._q.put((msg, key))
        else:
            self._rpc(*msg, key=key)

    def _drain(self):
        """Wait for the queued pushes; raise a push's error.  A failed
        push poisons the store for good: its round counters ran ahead of
        what the server saw (recreate the store to recover)."""
        if self._async_push:
            self._q.join()
        if self._q_exc is not None:
            raise MXNetError("async push failed (store is now "
                             "unusable, recreate it): %s"
                             % (self._q_exc,))

    def close(self):
        """Stop the sender thread and close the connections; a sender
        blocked on a dead server's socket is woken by shutting the
        sockets down under it."""
        if self._sender is not None and self._sender.is_alive():
            self._q.put(None)
            self._sender.join(timeout=5)
            if self._sender.is_alive():
                for s in self._socks:
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                self._sender.join(timeout=5)
            self._sender = None
        for s in self._socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def __del__(self):
        try:
            self.close()
        except BaseException:
            pass

    # -- the API -----------------------------------------------------------
    @property
    def rank(self) -> int:
        return self._rank

    @property
    def num_workers(self) -> int:
        return self._num_workers

    def wire_bytes(self):
        """The bytes this worker sent and received since it was made."""
        with self._lock:
            return {"sent": self._sent, "received": self._received}

    def _server_of(self, key) -> int:
        import zlib
        return zlib.crc32(str(key).encode()) % self._num_servers

    def _rpc(self, *msg, key=None):
        """Send to the server of ``key`` (server 0 without a key) and
        read its reply; a dead transport raises :class:`MXNetError`."""
        sock = self._socks[self._server_of(key) if key is not None else 0]
        with self._lock:
            try:
                self._sent += _send(sock, msg)
                out, n = _recv_sized(sock)
                self._received += n
            except OSError as e:
                raise MXNetError(
                    "kvstore transport failed (server dead?): %s"
                    % (e,)) from e
            if out is None:
                raise MXNetError("kvstore transport closed by peer "
                                 "mid-reply (server dead?)")
            return out

    def _rpc_all(self, *msg):
        """Send to every server; their replies (barrier, optimizer)."""
        out = []
        with self._lock:
            try:
                for sock in self._socks:
                    self._sent += _send(sock, msg)
                for sock in self._socks:
                    reply, n = _recv_sized(sock)
                    if reply is None:
                        raise MXNetError(
                            "kvstore transport closed by peer "
                            "mid-reply (server dead?)")
                    self._received += n
                    out.append(reply)
            except OSError as e:
                raise MXNetError(
                    "kvstore transport failed (server dead?): %s"
                    % (e,)) from e
        return out

    def init(self, key, value):
        self._drain()
        keys, values = _kv_lists(key, value)
        for k, v in zip(keys, values):
            if self._rank == 0:
                self._rpc("init", k, _to_numpy(v), key=k)
        self.barrier()

    def push(self, key, value, priority=0):
        keys, values = _kv_lists(key, value)
        for k, vlist in zip(keys, values):
            if not isinstance(vlist, (list, tuple)):
                vlist = [vlist]
            # the sum across this worker's contexts first
            reduced = vlist[0]
            for v in vlist[1:]:
                reduced = reduced + v.as_in_context(reduced.context)
            rnd = self._push_round.get(k, 0)
            self._push_round[k] = rnd + 1
            if self._compressor is not None:
                payload, shape, dtype = self._compressor.compress(
                    k, _to_numpy(reduced))
                self._enqueue_rpc("cpush", k,
                                  (payload, shape, dtype,
                                   self._compressor.threshold),
                                  self._rank, rnd, key=k)
            else:
                self._enqueue_rpc("push", k, _to_numpy(reduced),
                                  self._rank, rnd, key=k)
            if self._sync:
                # one aggregate update a round of pushes
                self._pull_version[k] = self._pull_version.get(k, 1) + 1

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        from ..ndarray.ndarray import NDArray
        self._drain()
        keys, outs = _kv_lists(key, out)
        for k, olist in zip(keys, outs):
            if not isinstance(olist, (list, tuple)):
                olist = [olist]
            tag, val = self._rpc("pull", k, self._pull_version.get(k, 1),
                                 key=k)
            if tag != "val":
                raise MXNetError("pull failed for key %r" % (k,))
            host = torch.from_numpy(np.ascontiguousarray(val))
            for o in olist:
                if isinstance(o, NDArray):
                    o._set_data(host.to(o._data.device))
        return None

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        self.pull(key, out, priority)

    def set_optimizer(self, optimizer):
        """Ship the optimizer to the servers (worker 0 pickles it); they
        run its updater on every round's sum."""
        self._drain()
        if self._rank == 0:
            blob = pickle.dumps(optimizer, protocol=pickle.HIGHEST_PROTOCOL)
            self._rpc_all("optimizer", blob)
        self.barrier()

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback on every push
        (reference ``KVStore::SetGradientCompression``)."""
        from .compression import create_compressor
        self._compressor = create_compressor(compression_params)

    def barrier(self):
        self._drain()
        self._rpc_all("barrier")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise MXNetError("Cannot save states on a distributed worker "
                         "(reference behavior)")

    def _send_command_to_servers(self, head, body):
        pass


def _kv_lists(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


def _to_numpy(v):
    from ..ndarray.ndarray import NDArray
    if isinstance(v, NDArray):
        return v.asnumpy()
    return np.asarray(v)


def create_dist_kvstore(name: str):
    """The worker's store, or, in a ``DMLC_ROLE=server`` process, the
    server (which runs until its workers are gone, then exits)."""
    if os.environ.get("DMLC_ROLE", "worker") == "server":
        run_server()
        raise SystemExit(0)
    return DistKVStore(name)
