"""Crash-durable per-process flight recorder.  Port of
``mxnet_tpu/obs/flight.py``; the two write and read the same file
format, so either package reads the other's ring.

A fixed-size ring of the last N structured events, backed by an
``mmap``-ed file in shared memory — the black box a killed worker
leaves behind.  Workers may exit through ``os._exit`` or ``SIGKILL``
mid-write, so nothing flush-on-exit survives: an mmap write IS the
durability mechanism.  The store lands in the kernel page cache the
instant it retires, and the file (``/dev/shm`` by default) outlives
the process.  No ``msync`` is needed for same-host recovery, since only
the process dies, not the kernel.

The recorder writes ``mxserve-flight-<pid>.bin`` (named as the zero-copy
put segments ``mxserve-put-<pid>-…`` of the disaggregated transport), so
a supervisor recovers a victim's file by pid, and :func:`flight_sweep`
clears leftovers.

Record format (all little-endian, one slot per event)::

    header   <4sIIIQ>  magic "MXFL", version, slot_bytes, n_slots, pid
    slot[i]  <QdI>     seq (u64, 1-based), t (perf_counter seconds),
                       payload length   … then compact-JSON payload

Slot index is ``(seq - 1) % n_slots``: a monotone sequence number makes
recovered events totally ordered and wraparound detectable.  The
payload is written *before* the slot head, so a slot torn by a kill
carries a stale or zero seq or unparsable JSON and is skipped by the
reader instead of corrupting the timeline.

``record()`` is on hot paths (wire sends and receives, page installs,
step boundaries) and does memory-only work under its lock:
``json.dumps`` plus two buffer stores, no syscalls, no blocking calls.

Environment (constructor arguments win):

* ``MXNET_SERVE_FLIGHT_SLOTS`` — ring capacity (default 256); ``0``
  disables the recorder (no file, ``record`` is a single attribute
  test).
* ``MXNET_SERVE_FLIGHT_DIR`` — directory for the ring files (default
  ``/dev/shm`` when present, else the temporary directory).
"""
from __future__ import annotations

import glob as _glob
import json
import mmap
import os
import struct
import tempfile
import threading
import time
from typing import List, Optional

__all__ = ["FlightRecorder", "flight_path", "read_flight",
           "flight_recover", "flight_sweep", "DEFAULT_SLOTS",
           "DEFAULT_SLOT_BYTES"]

_FLIGHT_PREFIX = "mxserve-flight-"
_MAGIC = b"MXFL"
_VERSION = 1
_HEADER = struct.Struct("<4sIIIQ")
_HEADER_BYTES = 64                      # header padded to one slot line
_SLOT_HEAD = struct.Struct("<QdI")

DEFAULT_SLOTS = 256
DEFAULT_SLOT_BYTES = 256


def _flight_dir(dir: Optional[str] = None) -> str:
    if dir is not None:
        return dir
    env = os.environ.get("MXNET_SERVE_FLIGHT_DIR")
    if env:
        return env
    return "/dev/shm" if os.path.isdir("/dev/shm") \
        else tempfile.gettempdir()


def flight_path(pid: Optional[int] = None,
                dir: Optional[str] = None) -> str:
    """The ring-file path a process with ``pid`` writes (and a
    supervisor recovers)."""
    return os.path.join(_flight_dir(dir), "%s%d.bin" % (
        _FLIGHT_PREFIX, pid if pid is not None else os.getpid()))


class FlightRecorder:
    """Fixed-size crash-durable event ring for THIS process.

    ``record(kind, **fields)`` appends one structured event; the ring
    keeps the last ``slots`` of them.  Disabled (``slots == 0`` via
    arg or ``MXNET_SERVE_FLIGHT_SLOTS=0``) it creates no file and
    every ``record`` returns ``None`` after one attribute test — the
    tracing-off path stays bit-identical.
    """

    def __init__(self, slots: Optional[int] = None,
                 slot_bytes: int = DEFAULT_SLOT_BYTES,
                 dir: Optional[str] = None,
                 pid: Optional[int] = None):
        if slots is None:
            try:
                slots = int(os.environ.get(
                    "MXNET_SERVE_FLIGHT_SLOTS", DEFAULT_SLOTS))
            except ValueError:
                slots = DEFAULT_SLOTS
        self._slots = max(0, int(slots))
        self._slot_bytes = max(_SLOT_HEAD.size + 16, int(slot_bytes))
        self._mm: Optional[mmap.mmap] = None
        self._seq = 0
        self._lock = threading.Lock()
        self.path: Optional[str] = None
        self.dropped = 0                # payloads truncated to fit
        if self._slots == 0:
            return
        path = flight_path(pid, dir)
        size = _HEADER_BYTES + self._slots * self._slot_bytes
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._mm[:_HEADER.size] = _HEADER.pack(
            _MAGIC, _VERSION, self._slot_bytes, self._slots,
            pid if pid is not None else os.getpid())
        self.path = path

    @property
    def enabled(self) -> bool:
        return self._mm is not None

    def record(self, kind: str, **fields) -> Optional[int]:
        """Append one event; returns its seq (``None`` when disabled).

        Memory-only under the lock: the mmap store is the durability
        point (no flush, no syscall; it survives a kill the moment it
        lands in the page cache)."""
        mm = self._mm
        if mm is None:
            return None
        ev = {"kind": kind}
        ev.update(fields)
        payload = json.dumps(ev, separators=(",", ":"),
                             default=str).encode("utf-8")
        cap = self._slot_bytes - _SLOT_HEAD.size
        if len(payload) > cap:
            payload = json.dumps(
                {"kind": kind, "trunc": len(payload)},
                separators=(",", ":")).encode("utf-8")[:cap]
            self.dropped += 1
        t = time.perf_counter()
        with self._lock:
            self._seq += 1
            seq = self._seq
            off = _HEADER_BYTES + ((seq - 1) % self._slots) \
                * self._slot_bytes
            body = off + _SLOT_HEAD.size
            mm[body:body + len(payload)] = payload
            _SLOT_HEAD.pack_into(mm, off, seq, t, len(payload))
        return seq

    def close(self, unlink: bool = False):
        """Orderly shutdown: drop the mapping, optionally remove the
        file (a process that closes cleanly needs no forensics)."""
        with self._lock:
            mm, self._mm = self._mm, None
        if mm is not None:
            try:
                mm.close()
            except (BufferError, ValueError):
                pass
        if unlink and self.path is not None:
            try:
                os.unlink(self.path)
            except OSError:
                pass


def read_flight(path: str) -> List[dict]:
    """Decode a ring file into seq-ordered event dicts.

    Each event carries its payload fields plus ``seq`` and ``t``
    (writer-process ``perf_counter`` seconds — correct to another
    process's clock with the handshake offset before merging).  Torn
    or never-written slots are skipped, not raised."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER_BYTES:
        return []
    magic, version, slot_bytes, n_slots, _pid = _HEADER.unpack_from(
        raw, 0)
    if magic != _MAGIC or version != _VERSION or slot_bytes <= \
            _SLOT_HEAD.size or n_slots <= 0:
        return []
    cap = slot_bytes - _SLOT_HEAD.size
    out = []
    for i in range(n_slots):
        off = _HEADER_BYTES + i * slot_bytes
        if off + _SLOT_HEAD.size > len(raw):
            break
        seq, t, plen = _SLOT_HEAD.unpack_from(raw, off)
        if seq == 0 or plen == 0 or plen > cap:
            continue
        body = off + _SLOT_HEAD.size
        try:
            ev = json.loads(raw[body:body + plen].decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            continue                    # torn mid-SIGKILL: skip
        if not isinstance(ev, dict):
            continue
        ev["seq"] = int(seq)
        ev["t"] = float(t)
        out.append(ev)
    out.sort(key=lambda e: e["seq"])
    return out


def flight_recover(pid: int, dir: Optional[str] = None,
                   unlink: bool = False) -> Optional[List[dict]]:
    """Recover a (dead) process's ring by pid; ``None`` when it left
    no file (orderly exit, or recorder disabled)."""
    path = flight_path(pid, dir)
    try:
        events = read_flight(path)
    except OSError:
        return None
    if unlink:
        try:
            os.unlink(path)
        except OSError:
            pass
    return events


def flight_sweep(pid: Optional[int] = None,
                 dir: Optional[str] = None) -> int:
    """Unlink leftover ring files: ours at orderly shutdown, or a
    killed worker's (by pid) from the supervising router.  Returns the
    number of files removed."""
    pat = os.path.join(_flight_dir(dir), "%s%s.bin" % (
        _FLIGHT_PREFIX, pid if pid is not None else os.getpid()))
    n = 0
    for p in _glob.glob(pat):
        try:
            os.unlink(p)
            n += 1
        except OSError:
            pass
    return n
