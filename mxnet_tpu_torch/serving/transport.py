"""Message transport of the disaggregated serving cluster.  Port of
``mxnet_tpu/serving/transport.py``.

One layer above ``parallel/dist.py``'s wire: every message is a raw
frame (:func:`parallel.dist.send_frame`) whose pickled header is a
small control dict ``{"kind": str, ...}`` and whose buffers are raw
tensor bytes, so KV pages, prompts and params never go through pickle.
The framing is the one the dist KVStore speaks (bounded prefixes, a
reset read as EOF), byte for byte the reference's, so a worker of
either package could read the other's frames.

* :class:`Connection`: one framed duplex socket.  ``send(kind, meta,
  bufs)`` under a send lock (several threads may reply on one
  connection); ``recv(timeout)`` waits for a frame's arrival with
  ``select`` and then reads the whole frame (a frame is never left
  half read, which would desynchronise the stream).
* :class:`Listener`: a listening socket that hands each accepted
  :class:`Connection` to a handler on a thread of its own (a worker's
  page server: fetches from sibling workers, the prefill-to-decode page
  streams).
* :func:`tree_to_frames` / :func:`frames_to_tree`: a nested dict/list
  tree of arrays over raw buffers; the router ships the model params to
  every worker at its handshake this way, so a spawned worker needs only
  a socket address.  Leaves are numpy arrays or torch tensors going out
  and CPU torch tensors coming back; a ``bfloat16`` leaf travels as its
  raw bytes under the reference's dtype name (numpy has no bfloat16
  without ``ml_dtypes``) and comes back as a ``torch.bfloat16`` tensor.

Every connection counts ``bytes_sent`` / ``bytes_received`` (the
buffers), which the workers roll up into the router's
``cluster_page_bytes_streamed_total``.

Same-host page puts: page-sized payloads (``pages`` streams,
``fetch_reply`` bodies) between workers of one host skip the socket
body.  The sender lands the raw pool bytes in one ``/dev/shm`` segment
(:func:`put_write`) and sends a control frame naming it
(``meta["put"]``); :meth:`Connection.recv` maps the segment as
zero-copy memoryviews (:class:`PutBufs`) and unlinks the file at once,
so a segment exists on disk only while its frame is in flight.  Whether
the path is live is negotiated: each side of a data-plane connection
sends a ``caps`` frame first (:func:`put_capability`), and a sender
puts only when both sides advertise ``put_pages`` with the same host
and directory; otherwise the bytes go inline on the socket, the same
bytes.  ``MXNET_SERVE_TRANSPORT``: ``auto`` (default), ``socket``
(never advertise), ``put`` (advertise; tests force the path with it).
"""
from __future__ import annotations

import glob
import mmap
import os
import select
import socket
import tempfile
import threading
import time
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..parallel.dist import recv_frame, send_frame

__all__ = ["Connection", "Listener", "tree_to_frames",
           "frames_to_tree", "connect", "put_capability",
           "put_write", "put_read", "put_sweep", "PutBufs",
           "PUT_DIR", "PUT_STATS"]

# --------------------------------------------------------------------------
# zero-copy same-host page puts
# --------------------------------------------------------------------------

PUT_DIR = "/dev/shm" if os.path.isdir("/dev/shm") \
    else tempfile.gettempdir()
_PUT_PREFIX = "mxserve-put-"

# open/release accounting of this process: every mapped segment is
# released after its install or abort, so releases == opens when idle
PUT_STATS = {"writes": 0, "opens": 0, "releases": 0}


def put_capability() -> Optional[dict]:
    """The capability this process advertises on data-plane
    connections, or ``None`` when the put path is off
    (``MXNET_SERVE_TRANSPORT=socket``).  Two workers may put to each
    other only when their host and directory match."""
    if os.environ.get("MXNET_SERVE_TRANSPORT", "auto") == "socket":
        return None
    return {"put_pages": True, "host": socket.gethostname(),
            "dir": PUT_DIR}


def put_eligible(mine: Optional[dict],
                 theirs: Optional[dict]) -> bool:
    """Both ends advertised ``put_pages`` from the same shm domain?"""
    return (mine is not None and theirs is not None
            and bool(theirs.get("put_pages"))
            and mine.get("host") == theirs.get("host")
            and mine.get("dir") == theirs.get("dir"))


def put_write(bufs) -> Tuple[str, List[int]]:
    """Land raw buffers in one fresh segment: ``(path, sizes)`` for the
    control frame.  The name carries the writer's pid, so a killed
    worker's unreceived segments can be swept (:func:`put_sweep`)."""
    fd, path = tempfile.mkstemp(
        prefix="%s%d-" % (_PUT_PREFIX, os.getpid()), dir=PUT_DIR)
    sizes = []
    try:
        with os.fdopen(fd, "wb") as f:
            for b in bufs:
                mv = memoryview(b).cast("B")
                sizes.append(mv.nbytes)
                f.write(mv)
    except BaseException:
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    PUT_STATS["writes"] += 1
    return path, sizes


class PutBufs(list):
    """A received put segment: zero-copy memoryviews into one mapping.
    :meth:`release` drops the views and closes the map (the file was
    unlinked at open, so this returns the memory).  A view still
    exported elsewhere keeps the map open until it goes."""

    def __init__(self, views: List[memoryview], mm_obj, base):
        super().__init__(views)
        self._mm = mm_obj
        self._base = base
        self.released = False

    def release(self):
        if self.released:
            return
        self.released = True
        PUT_STATS["releases"] += 1
        try:
            for v in self:
                v.release()
            self._base.release()
            self._mm.close()
        except BufferError:
            pass                          # an exported view: GC closes it
        self._mm = self._base = None
        self[:] = []


def put_read(path: str, sizes: List[int]) -> PutBufs:
    """Open, map and unlink a put segment at once (the namespace holds
    only in-flight segments; the mapping keeps the bytes until
    :meth:`PutBufs.release`)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        mm_obj = mmap.mmap(fd, 0, prot=mmap.PROT_READ)
    finally:
        os.close(fd)
    try:
        os.unlink(path)
    except OSError:
        pass                              # already swept: bytes live on
    base = memoryview(mm_obj)
    views, off = [], 0
    for n in sizes:
        views.append(base[off:off + n])
        off += n
    PUT_STATS["opens"] += 1
    return PutBufs(views, mm_obj, base)


def put_sweep(pid: Optional[int] = None) -> int:
    """Unlink leftover put segments: ours at an orderly exit, or a
    killed worker's (by its pid) from the router, since a segment
    written just before SIGKILL has no receiver left to unlink it.
    Returns the files removed."""
    pat = os.path.join(PUT_DIR, "%s%s-*" % (
        _PUT_PREFIX, pid if pid is not None else os.getpid()))
    n = 0
    for p in glob.glob(pat):
        try:
            os.unlink(p)
            n += 1
        except OSError:
            pass
    return n


class Connection:
    """One framed duplex transport connection."""

    def __init__(self, sock: socket.socket):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        self._sock = sock
        self._slock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0
        self.closed = False
        # the peer's transport capability, from its `caps` frame
        self.peer_put: Optional[dict] = None
        self.caps_seen = False

    def send(self, kind: str, meta: Optional[dict] = None, bufs=()):
        """Send one message; raises ``OSError`` on a dead peer (the
        caller decides between failover and shutdown)."""
        head = {"kind": kind}
        if meta:
            head.update(meta)
        n = sum(memoryview(b).nbytes for b in bufs)
        with self._slock:
            send_frame(self._sock, head, bufs)
            self.bytes_sent += n

    def recv(self, timeout: Optional[float] = None):
        """One message as ``(kind, meta, bufs)``; ``None`` on EOF, a
        reset or a foreign frame; ``"timeout"`` when no frame arrived
        within ``timeout`` seconds (a frame that started arriving is
        read to its end)."""
        if timeout is not None:
            r, _, _ = select.select([self._sock], [], [], timeout)
            if not r:
                return "timeout"
        try:
            got = recv_frame(self._sock)
        except (OSError, MXNetError):
            return None
        if got is None:
            return None
        meta, bufs = got
        bufs = bufs or []
        self.bytes_received += sum(len(b) for b in bufs)
        if not isinstance(meta, dict) or "kind" not in meta:
            return None                   # foreign frame: drop the conn
        if meta["kind"] == "caps":
            self.peer_put = meta.get("put")
            self.caps_seen = True
        put = meta.get("put") if meta["kind"] != "caps" else None
        if put is not None:
            # the body rides a shm segment: map it (and unlink it now)
            try:
                bufs = put_read(put["path"], put["sizes"])
            except OSError:
                return None               # sender died mid-put: as EOF
            self.bytes_received += sum(v.nbytes for v in bufs)
        return meta["kind"], meta, bufs

    def send_caps(self):
        """Advertise this end's capability: the first frame each side
        sends on a data-plane connection."""
        self.send("caps", {"put": put_capability()})

    def wait_caps(self, timeout: float = 5.0) -> Optional[dict]:
        """The connector's half of the handshake: the acceptor's first
        frame is always its ``caps``.  Returns the peer's capability, or
        ``None`` on a timeout or EOF (a socket-only peer)."""
        deadline = time.perf_counter() + timeout
        while not self.caps_seen:
            left = deadline - time.perf_counter()
            if left <= 0:
                return None
            got = self.recv(timeout=left)
            if got in (None, "timeout"):
                return None
        return self.peer_put

    def close(self):
        self.closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def __del__(self):
        try:
            self.close()
        except BaseException:
            pass


def connect(host: str, port: int, timeout: float = 10.0,
            retry_until: float = 0.0) -> Connection:
    """Connect, retrying refused attempts for ``retry_until`` seconds
    (an externally launched worker may start before the router has
    bound its port)."""
    deadline = time.perf_counter() + retry_until
    while True:
        try:
            return Connection(socket.create_connection(
                (host, port), timeout=timeout))
        except OSError:
            if time.perf_counter() >= deadline:
                raise
            time.sleep(0.1)


class Listener:
    """An accept loop handing each peer :class:`Connection` to
    ``handler(conn)`` on a daemon thread of its own."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    def start(self, handler: Callable[[Connection], None]):
        def loop():
            while not self._stop:
                try:
                    s, _ = self._sock.accept()
                except OSError:
                    return
                threading.Thread(target=handler, args=(Connection(s),),
                                 daemon=True).start()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._stop = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# array trees <-> raw frames (params shipped at a worker's handshake)
# ---------------------------------------------------------------------------

def dtype_name(a) -> str:
    """The reference's (numpy's) name of a leaf's dtype."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).split(".")[-1]
    return str(a.dtype)


def raw_bytes(a) -> memoryview:
    """A flat byte view of an array or tensor, in C order (a copy only
    where it is not contiguous on the host); bfloat16 goes through its
    bits."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous().reshape(-1)
        return memoryview(t.view(torch.uint8).numpy())
    a = np.ascontiguousarray(a)
    return memoryview(a.reshape(-1).view(np.uint8))


def tensor_from_bytes(buf, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor of ``dtype`` (the reference's name) and ``shape``
    over ``buf`` without a copy (read-only buffers too: the caller only
    reads, or copies out)."""
    dt = getattr(torch, dtype)
    mv = memoryview(buf).cast("B")
    if mv.nbytes == 0:
        return torch.empty(tuple(shape), dtype=dt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # not writable
        t = torch.frombuffer(mv, dtype=torch.uint8)
    return t.view(dt).reshape(tuple(shape))


def _flatten(tree, path, leaves):
    if isinstance(tree, dict):
        return {k: _flatten(v, path + (k,), leaves)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        skel = [_flatten(v, path + (i,), leaves)
                for i, v in enumerate(tree)]
        return skel if isinstance(tree, list) else tuple(skel)
    leaves.append((path, tree if isinstance(tree, torch.Tensor)
                   else np.asarray(tree)))
    return None                           # the leaf's slot in the skeleton


def tree_to_frames(tree) -> Tuple[dict, List]:
    """Flatten a nested dict/list/tuple of arrays or tensors into
    ``(meta, bufs)``: meta holds the container skeleton and each leaf's
    path, dtype name and shape (the reference's meta), bufs the raw
    bytes in order."""
    leaves: List[Tuple[tuple, object]] = []
    skel = _flatten(tree, (), leaves)
    meta = {"skel": skel,
            "leaves": [{"path": p, "dtype": dtype_name(a),
                        "shape": tuple(int(d) for d in a.shape)}
                       for p, a in leaves]}
    return meta, [raw_bytes(a) for _, a in leaves]


def frames_to_tree(meta: dict, bufs: List):
    """The inverse of :func:`tree_to_frames`, leaves as CPU tensors
    over the received buffers (no copy)."""
    tree = meta["skel"]
    if tree is None and len(meta["leaves"]) == 1 \
            and meta["leaves"][0]["path"] == ():
        lf = meta["leaves"][0]
        return tensor_from_bytes(bufs[0], lf["dtype"], lf["shape"])
    for lf, b in zip(meta["leaves"], bufs):
        arr = tensor_from_bytes(b, lf["dtype"], lf["shape"])
        node = tree
        *parents, last = lf["path"]
        for k in parents:
            node = node[k]
        if isinstance(node, tuple):
            raise ValueError("frames_to_tree: tuple leaf containers "
                             "are not rebuildable in place; use lists")
        node[last] = arr
    return tree
