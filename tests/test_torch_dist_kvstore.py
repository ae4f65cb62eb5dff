"""The port's parameter server (``mxnet_tpu_torch/parallel/dist.py``),
its launcher (``mxnet_tpu_torch/tools/launch.py``) and ``multihost``
against the reference's, on the CPU.

The servers and workers run in this process (threads) on real sockets,
as ``tests/test_dist_kvstore.py`` runs the reference's; the launcher
cases start processes (``tests/_torch_dist_worker.py``, which imports
the port only), each with a timeout and killed on failure.  Sums are
exact; the server's SGD is held to the reference's run with
``jax_disable_jit`` (XLA:CPU contracts a jitted update into FMAs): bit
for bit in f32.  The wire is the reference's: a port worker works
against the reference's server and a reference worker against the
port's (sums only: a pickled optimizer names its package), and both
packages' frames are the same bytes.

``test_mpi_launcher_shim`` is marked ``slow``, as the reference's is: it
starts three processes that each import torch.
"""
import contextlib
import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as P
from mxnet_tpu_torch.parallel import dist as PD
from _torch_port import reference as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
LAUNCH = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"]
_ENV_LOCK = threading.Lock()


def _env(port, rank, nworkers, nservers=1):
    return {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
            "DMLC_NUM_WORKER": str(nworkers), "DMLC_WORKER_ID": str(rank),
            "DMLC_NUM_SERVER": str(nservers), "DMLC_ROLE": "worker"}


@contextlib.contextmanager
def _server(mod=PD, **kw):
    s = mod.DistServer(**kw)
    s.start()
    try:
        yield s
    finally:
        s.shutdown()


def _store(cls, port, rank=0, nworkers=1, nservers=1, name="dist_sync"):
    """A worker store made with its rank's environment (the store reads
    ``os.environ``; threads make theirs one at a time)."""
    with _ENV_LOCK:
        old = dict(os.environ)
        os.environ.update(_env(port, rank, nworkers, nservers))
        try:
            return cls(name)
        finally:
            os.environ.clear()
            os.environ.update(old)


def _threads(fn, n):
    out, errs = {}, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)
    ts = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    if errs:
        raise errs[0]
    assert len(out) == n
    return out


def _run(cmd, timeout=120, **kw):
    """``cmd`` in a session of its own, killed whole on a timeout."""
    p = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, **kw)
    try:
        out, _ = p.communicate(timeout=timeout)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, 9)
    return p.returncode, out


# --- the server and its worker, in process --------------------------------
def test_dist_async_applies_immediately():
    with _server(num_workers=1, sync_mode=False) as s:
        kv = _store(PD.DistKVStore, s.port, name="dist_async")
        kv.init("k", P.nd.zeros((2,), ctx=P.cpu()))
        kv.push("k", P.nd.ones((2,), ctx=P.cpu()))
        kv.push("k", P.nd.ones((2,), ctx=P.cpu()))
        out = P.nd.zeros((2,), ctx=P.cpu())
        kv.pull("k", out=out)
        assert np.all(out.asnumpy() == 2) and kv.type == "dist_async"
        kv.close()


def test_dist_sync_aggregates_every_worker_then_updates():
    """Three workers push different values per round; every pull of a
    round sees the sum of all three, never a partial one."""
    with _server(num_workers=3) as s:
        def worker(r):
            kv = _store(PD.DistKVStore, s.port, r, 3)
            kv.init("w", P.nd.zeros((5,), ctx=P.cpu()))
            seen = []
            for step in range(3):
                kv.push("w", P.nd.full((5,), r + 1.0 + step, ctx=P.cpu()))
                out = P.nd.zeros((5,), ctx=P.cpu())
                kv.pull("w", out=out)
                seen.append(out.asnumpy()[0])
            kv.barrier()
            assert (kv.rank, kv.num_workers) == (r, 3)
            kv.close()
            return seen
        res = _threads(worker, 3)
    for seen in res.values():
        assert seen == [6.0, 6.0 + 9.0, 15.0 + 12.0]


def _server_sgd(mod, mx, ctx_kw):
    with _server(mod, num_workers=1, **ctx_kw) as s:
        kv = _store(mod.DistKVStore, s.port)
        sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                          wd=1e-3, rescale_grad=0.5,
                                          lr_scheduler=sched))
        rng = np.random.RandomState(0)
        kv.init(7, mx.nd.array(rng.randn(6, 3).astype(np.float32)))
        out = mx.nd.zeros((6, 3))
        outs = []
        for _ in range(5):
            kv.push(7, mx.nd.array(rng.randn(6, 3).astype(np.float32)))
            kv.pull(7, out=out)
            outs.append(out.asnumpy())
        kv.close()
        return outs


def test_server_side_sgd_bit_for_bit():
    """``update_on_kvstore``: the optimizer worker 0 ships (pickled with
    its schedule) runs on the server's context; five rounds, the rate
    halving every two, bit for bit the reference's."""
    with P.cpu():
        got = _server_sgd(PD, P, {"ctx": P.cpu()})
    import jax
    from mxnet_tpu.parallel import dist as RD
    jax.config.update("jax_disable_jit", True)
    try:
        want = _server_sgd(RD, R, {})
    finally:
        jax.config.update("jax_disable_jit", False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_optimizer_pickles_with_its_schedule():
    sched = P.lr_scheduler.FactorScheduler(step=3, factor=0.5)
    opt = P.optimizer.SGD(learning_rate=0.2, momentum=0.9,
                          lr_scheduler=sched, param_dict={0: object()})
    for i in range(4):
        opt._update_count(0)
    back = pickle.loads(pickle.dumps(opt, protocol=pickle.HIGHEST_PROTOCOL))
    assert back.param_dict == {} and back.num_update == opt.num_update == 4
    assert back._get_lr(0) == opt._get_lr(0) == pytest.approx(0.1)
    for o in (opt, back):
        for _ in range(3):
            o._update_count(0)
    assert back._get_lr(0) == opt._get_lr(0) == pytest.approx(0.05)


def test_multi_server_key_sharding():
    """2 servers, 3 workers: the keys shard over the servers by the
    stable hash, disjointly, and the sums are the single server's."""
    base = _free_port_pair()
    keys = ["w%d" % i for i in range(16)]
    servers = [PD.DistServer(port=base + i, num_workers=3) for i in (0, 1)]
    for s in servers:
        s.start()
    try:
        def worker(r):
            kv = _store(PD.DistKVStore, base, r, 3, nservers=2)
            for k in keys:
                kv.init(k, P.nd.zeros((4,), ctx=P.cpu()))
            for k in keys:
                kv.push(k, P.nd.ones((4,), ctx=P.cpu()) * (r + 1))
            outs = {}
            for k in keys:
                o = P.nd.zeros((4,), ctx=P.cpu())
                kv.pull(k, out=o)
                outs[k] = o.asnumpy()
            kv.close()
            return outs
        res = _threads(worker, 3)
    finally:
        for s in servers:
            s.shutdown()
    for outs in res.values():
        for k in keys:
            np.testing.assert_array_equal(outs[k], 6.0)
    stored = [set(s.store) for s in servers]
    assert not stored[0] & stored[1] and stored[0] | stored[1] == set(keys)
    assert stored[0] and stored[1]
    import zlib
    assert all((zlib.crc32(k.encode()) % 2 == 0) == (k in stored[0])
               for k in keys)


def _free_port_pair():
    for base in range(20000, 40000, 7):
        try:
            socks = []
            for p in (base, base + 1):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", p))
                socks.append(s)
            for s in socks:
                s.close()
            return base
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def test_dist_push_compressed_wire():
    """A 2-bit push sends the packed codes: 4096 f32 values go as ~1 KiB
    and the server's value is the quantized one, ``wire_bytes`` counts
    what went."""
    sizes = []
    orig = PD._send

    def spy(sock, obj):
        if isinstance(obj, tuple) and obj and obj[0] in ("push", "cpush"):
            sizes.append((obj[0], len(pickle.dumps(obj))))
        return orig(sock, obj)

    PD._send = spy
    try:
        with _server(num_workers=1) as s:
            kv = _store(PD.DistKVStore, s.port)
            kv.init("w", P.nd.zeros((4096,), ctx=P.cpu()))
            kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
            before = kv.wire_bytes()
            kv.push("w", P.nd.full((4096,), 0.7, ctx=P.cpu()))
            out = P.nd.zeros((4096,), ctx=P.cpu())
            kv.pull("w", out=out)
            after = kv.wire_bytes()
            kv.close()
    finally:
        PD._send = orig
    np.testing.assert_array_equal(out.asnumpy(), 0.5)
    cp = [n for tag, n in sizes if tag == "cpush"]
    assert cp and cp[0] < 2048, cp
    assert after["sent"] - before["sent"] < 2048 + 200
    assert after["received"] - before["received"] > 4 * 4096


def test_async_push_overlaps_compute():
    """Pushes go from the sender thread: three pushes to a server slowed
    to 80 ms a push, beside 80 ms of the caller's work each, finish well
    under the serial time; the pull sees all three."""
    with _server(num_workers=1) as s:
        orig = s._apply_push

        def slow(key, agg):
            time.sleep(0.08)
            return orig(key, agg)
        s._apply_push = slow
        kv = _store(PD.DistKVStore, s.port)
        assert kv._async_push
        kv.init("w", P.nd.zeros((64,), ctx=P.cpu()))
        t0 = time.time()
        for _ in range(3):
            kv.push("w", P.nd.ones((64,), ctx=P.cpu()))
            time.sleep(0.08)
        overlapped = time.time() - t0
        out = P.nd.zeros((64,), ctx=P.cpu())
        kv.pull("w", out=out)
        kv.close()
    np.testing.assert_array_equal(out.asnumpy(), 3.0)
    assert overlapped < 0.40, overlapped


def test_async_push_error_surfaces_at_sync_point():
    with _server(num_workers=1) as s:
        kv = _store(PD.DistKVStore, s.port)
        kv.init("w", P.nd.zeros((4,), ctx=P.cpu()))
        for sock in kv._socks:
            sock.close()
        kv.push("w", P.nd.ones((4,), ctx=P.cpu()))
        with pytest.raises(P.MXNetError, match="async push failed"):
            kv.pull("w", out=P.nd.zeros((4,), ctx=P.cpu()))
        with pytest.raises(P.MXNetError, match="async push failed"):
            kv.pull("w", out=P.nd.zeros((4,), ctx=P.cpu()))
        with pytest.raises(P.MXNetError, match="distributed worker"):
            kv.save_optimizer_states("x")


def test_create_reads_the_dmlc_environment(monkeypatch):
    with _server(num_workers=1) as s:
        for k, v in _env(s.port, 0, 1).items():
            monkeypatch.setenv(k, v)
        kv = P.kv.create("dist_sync")
        assert isinstance(kv, PD.DistKVStore) and kv.type == "dist_sync"
        kv.close()


# --- the wire, both ways ---------------------------------------------------
def _sum_job(worker_mod, mx, port, ctx):
    kv = _store(worker_mod.DistKVStore, port)
    rng = np.random.RandomState(2)
    kv.init("w", mx.nd.zeros((3, 5), ctx=ctx))
    kv.init([1, 2], [mx.nd.ones((4,), ctx=ctx), mx.nd.ones((4,), ctx=ctx)])
    outs = []
    for _ in range(2):
        kv.push("w", mx.nd.array(rng.randn(3, 5).astype(np.float32),
                                 ctx=ctx))
        kv.push([1, 2], [mx.nd.full((4,), 0.5, ctx=ctx)] * 2)
        o, o1 = mx.nd.zeros((3, 5), ctx=ctx), mx.nd.zeros((4,), ctx=ctx)
        kv.pull("w", out=o)
        kv.pull(1, out=o1)
        outs += [o.asnumpy(), o1.asnumpy()]
    kv.barrier()
    kv.close()
    return outs


@pytest.mark.parametrize("worker,server", [("port", "ref"), ("ref", "port")])
def test_worker_and_server_of_the_two_packages_interoperate(worker, server):
    from mxnet_tpu.parallel import dist as RD
    smod = RD if server == "ref" else PD
    with _server(smod, num_workers=1) as s:
        if worker == "port":
            got = _sum_job(PD, P, s.port, P.cpu())
        else:
            got = _sum_job(RD, R, s.port, R.cpu())
    with _server(PD, num_workers=1) as s:
        want = _sum_job(PD, P, s.port, P.cpu())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_mixed_job_one_worker_of_each_package():
    """``dist_sync`` with a port worker and a reference worker on one
    port server: both pull the sum of both pushes."""
    from mxnet_tpu.parallel import dist as RD
    with _server(PD, num_workers=2) as s:
        def worker(r):
            mod, mx, ctx = (PD, P, P.cpu()) if r == 0 else (RD, R, R.cpu())
            kv = _store(mod.DistKVStore, s.port, r, 2)
            kv.init("w", mx.nd.zeros((4,), ctx=ctx))
            kv.push("w", mx.nd.full((4,), 1.5 + r, ctx=ctx))
            out = mx.nd.zeros((4,), ctx=ctx)
            kv.pull("w", out=out)
            kv.barrier()
            kv.close()
            return out.asnumpy()
        res = _threads(worker, 2)
    for out in res.values():
        np.testing.assert_array_equal(out, 4.0)


def test_frames_are_byte_identical():
    from mxnet_tpu.parallel import dist as RD
    meta = {"kind": "kv_pages", "rid": 7, "shape": (2, 3)}
    bufs = [np.arange(6, dtype=np.int8).tobytes(),
            np.linspace(0, 1, 5, dtype=np.float32), bytearray(b"xyz")]

    def wire(send, *args):
        a, b = socket.socketpair()
        with a, b:
            send(a, *args)
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                c = b.recv(1 << 16)
                if not c:
                    return b"".join(chunks)
                chunks.append(c)

    raw = wire(PD.send_frame, meta, bufs)
    assert raw == wire(RD.send_frame, meta, bufs)
    assert raw[7] & 0x80                          # the raw-frame flag bit
    msg = ("push", "w", np.ones((3,), np.float32), 1, 4)
    assert wire(PD._send, msg) == wire(RD._send, msg)
    for sender, reader in ((PD, RD), (RD, PD)):
        a, b = socket.socketpair()
        with a, b:
            sender.send_frame(a, meta, bufs)
            sender._send(a, msg)
            got_meta, got_bufs = reader.recv_frame(b)
            assert got_meta == meta
            assert [bytes(x) for x in got_bufs] == \
                [bytes(memoryview(x).cast("B")) for x in bufs]
            obj, none = reader.recv_frame(b)
            assert none is None and obj[:2] == msg[:2]
            a.close()
            assert reader.recv_frame(b) is None
    a, b = socket.socketpair()
    with a, b:
        a.sendall((PD.MAX_FRAME_BYTES + 1).to_bytes(8, "little"))
        with pytest.raises(P.MXNetError, match="MAX_FRAME_BYTES"):
            PD._recv(b)
        PD.send_frame(a, meta)
        with pytest.raises(P.MXNetError, match="raw frame"):
            PD._recv(b)


# --- the launcher and multihost --------------------------------------------
def test_launcher_runs_the_dist_sync_job():
    """``tests/dist_sync_kvstore.py``'s job through the port's launcher:
    one server, two workers; the workers import no JAX."""
    rc, out = _run(LAUNCH + ["-n", "2", "-s", "1", "--launcher", "local",
                             sys.executable, WORKER])
    assert rc == 0, out[-3000:]
    assert out.count("OK") == 2, out[-3000:]


def test_launcher_multihost_over_gloo():
    """``-s 0``: two processes join through ``multihost.initialize``
    (gloo), report their rank and count, and the horovod store refuses
    their job."""
    rc, out = _run(LAUNCH + ["-n", "2", "-s", "0", "--launcher", "local",
                             sys.executable, WORKER, "--multihost"])
    assert rc == 0, out[-3000:]
    assert "rank 0/2 OK" in out and "rank 1/2 OK" in out, out[-3000:]


def test_launcher_stops_the_job_when_a_worker_fails():
    t0 = time.time()
    rc, out = _run(LAUNCH + ["-n", "2", "-s", "1", "--launcher", "local",
                             sys.executable, "-c", "import sys, os; "
                             "sys.exit(3 if os.environ['DMLC_WORKER_ID'] "
                             "== '1' else __import__('time').sleep(60))"],
                   timeout=60)
    assert rc == 3 and time.time() - t0 < 30, out[-3000:]


def test_launcher_modes_not_ported_and_missing_runner(capsys,
                                                      monkeypatch):
    """The ``http`` mode, ported since, runs the front door's CLI as a
    ``-c`` entry with the command's tokens and ``-p`` (held on a stand-in
    for ``Popen``); ``yarn`` is refused; a missing mpi runner gives
    127."""
    import argparse
    from mxnet_tpu_torch.tools import launch
    seen = {}

    class _Proc:
        def __init__(self, cmd, env=None):
            seen["cmd"], seen["env"] = cmd, env

        def wait(self):
            return 0

    import signal
    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(launch.subprocess, "Popen", _Proc)
    assert launch.main(["--launcher", "http", "-p", "8123", "--",
                        "--device", "cpu", "--replicas", "2"]) == 0
    cmd = seen["cmd"]
    assert cmd[1] == "-c" and "mxnet_tpu_torch.serving.http_frontend" in \
        cmd[2]
    assert cmd[3:] == ["--port", "8123", "--device", "cpu", "--replicas",
                       "2"]
    assert ROOT in seen["env"]["PYTHONPATH"].split(os.pathsep)
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.undo()
    assert launch.main(["-n", "1", "--launcher", "yarn", "x"]) == 2
    args = argparse.Namespace(num_workers=2, num_servers=1, port=None,
                              launcher="mpi")
    assert launch.launch_mpi(args, ["python", "x.py"],
                             runner="mpirun_definitely_missing") == 127
    assert "mxnet_tpu_torch.parallel.dist" in launch._role_shim(
        {"DMLC_NUM_SERVER": "1"})


@pytest.mark.slow
def test_mpi_launcher_shim():
    """The mpi/slurm role shim with ``OMPI_COMM_WORLD_RANK`` set by hand:
    rank 0 is the server, ranks 1-2 the workers; the server exits on its
    own once they are gone."""
    from mxnet_tpu_torch.tools.launch import _role_shim
    port = _free_port_pair()
    shim = _role_shim({"DMLC_PS_ROOT_URI": "127.0.0.1",
                       "DMLC_PS_ROOT_PORT": str(port),
                       "DMLC_NUM_WORKER": "2", "DMLC_NUM_SERVER": "1"})
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", shim, sys.executable, WORKER], cwd=ROOT,
        env=dict(env, OMPI_COMM_WORLD_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(3)]
    outs = []
    try:
        for p in procs[1:]:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
            assert p.returncode == 0, out
        procs[0].communicate(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert sum(o.count("OK") for o in outs) == 2, outs


def test_multihost_single_process():
    from mxnet_tpu_torch.parallel import multihost
    multihost.initialize()
    assert multihost.is_initialized()
    assert (multihost.rank(), multihost.num_hosts()) == (0, 1)
    assert multihost.local_devices()
    for name in ("global_mesh", "host_staged_put"):
        with pytest.raises(NotImplementedError, match="7b"):
            getattr(multihost, name)
    multihost.shutdown()
    assert not multihost.is_initialized()
    with pytest.raises(P.MXNetError, match="lone single-host"):
        multihost.initialize(process_id=1)
