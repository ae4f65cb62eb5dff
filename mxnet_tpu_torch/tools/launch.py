"""The distributed job launcher.

Port of ``tools/launch.py`` (MXNet's ``tools/launch.py`` over the dmlc
tracker); run it as ``python -m mxnet_tpu_torch.tools.launch``::

    python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 --launcher local \\
        python train.py

starts one parameter server (``mxnet_tpu_torch.parallel.dist.run_server``)
and two workers running ``python train.py``, each with the ``DMLC_*``
environment the stores read (``DMLC_PS_ROOT_URI``, ``DMLC_PS_ROOT_PORT``,
``DMLC_NUM_WORKER``, ``DMLC_NUM_SERVER``, ``DMLC_ROLE``,
``DMLC_WORKER_ID``/``DMLC_SERVER_ID``).  With ``-s 0`` only the workers
start, and ``DMLC_PS_ROOT_*`` is the rendezvous of
``parallel.multihost.initialize``.

Launchers: ``local`` (every role a process on this host), ``ssh`` (one
worker a host of ``-H hostfile``, the servers on the first host),
``mpi`` and ``slurm`` (``mpirun``/``srun`` place the ranks; each rank
takes its role from its MPI or slurm rank through a small shim), and
``sge`` (a ``qsub`` job array).  ``yarn`` is refused, as in the
reference.  ``serve`` starts a disaggregated serving cluster's router
command and its prefill and decode workers (:func:`launch_serve`);
``http`` runs the HTTP/SSE front door (:func:`launch_http`).

The local launcher stops the servers when the workers are done, and
stops every process when one worker fails.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

_SERVER = ("from mxnet_tpu_torch.parallel.dist import run_server; "
           "run_server()")
# the directory that holds the package, put on the children's path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _with_root(env):
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _ROOT + os.pathsep + path if path else _ROOT
    return env


def _stop(procs, timeout=10.0):
    """SIGTERM each live process, then SIGKILL what is left after
    ``timeout`` seconds."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    end = time.time() + timeout
    for p in procs:
        try:
            p.wait(max(0.0, end - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_local(args, command):
    port = args.port or _free_port()
    base_env = _with_root(dict(os.environ))
    base_env.update({
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": str(args.num_servers),
    })
    servers, workers = [], []
    try:
        for i in range(args.num_servers):
            env = dict(base_env, DMLC_ROLE="server", DMLC_SERVER_ID=str(i))
            servers.append(subprocess.Popen(
                [sys.executable, "-c", _SERVER], env=env))
        for i in range(args.num_workers):
            env = dict(base_env, DMLC_ROLE="worker", DMLC_WORKER_ID=str(i))
            workers.append(subprocess.Popen(command, env=env))
        while True:
            codes = [p.poll() for p in workers]
            failed = [c for c in codes if c]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        _stop(workers + servers)


def launch_ssh(args, command):
    with open(args.hostfile) as f:
        hosts = [h.strip() for h in f if h.strip()]
    port = args.port or 9091
    root = hosts[0]
    base = [
        "DMLC_PS_ROOT_URI=%s" % root,
        "DMLC_PS_ROOT_PORT=%d" % port,
        "DMLC_NUM_WORKER=%d" % args.num_workers,
        "DMLC_NUM_SERVER=%d" % args.num_servers,
    ]
    server_cmd = '%s -c "%s"' % (sys.executable, _SERVER)
    # every server on the root host, server i on ROOT_PORT + i
    server_procs = []
    for i in range(args.num_servers):
        env_fwd = " ".join(base + ["DMLC_ROLE=server",
                                   "DMLC_SERVER_ID=%d" % i])
        server_procs.append(subprocess.Popen(
            ["ssh", root, env_fwd + " " + server_cmd]))
    worker_procs = []
    for i in range(args.num_workers):
        host = hosts[i % len(hosts)]
        env_fwd = " ".join(base + ["DMLC_ROLE=worker",
                                   "DMLC_WORKER_ID=%d" % i])
        worker_procs.append(subprocess.Popen(
            ["ssh", host, env_fwd + " " + " ".join(command)]))
    code = 0
    try:
        for p in worker_procs:
            p.wait()
            code = code or p.returncode
    finally:
        for p in server_procs:
            p.send_signal(signal.SIGTERM)
    return code


_ROLE_SHIM = (
    "import os,sys,subprocess;"
    "r=int(os.environ.get('OMPI_COMM_WORLD_RANK',"
    "os.environ.get('PMI_RANK',os.environ.get('SLURM_PROCID','0'))));"
    "ns=int(os.environ['DMLC_NUM_SERVER']);"
    "os.environ.update({'DMLC_ROLE':'server','DMLC_SERVER_ID':str(r)}"
    " if r<ns else"
    " {'DMLC_ROLE':'worker','DMLC_WORKER_ID':str(r-ns)});"
    "sys.exit(subprocess.call(sys.argv[1:])"
    " if r>=ns else"
    " __import__('mxnet_tpu_torch.parallel.dist',fromlist=['run_server'])"
    ".run_server())"
)


def _role_shim(env):
    """The shim with the rendezvous environment written into the
    program itself: OpenMPI starts remote ranks with the login shell's
    environment, not mpirun's."""
    baked = "".join("os.environ[%r]=%r;" % (k, str(v))
                    for k, v in env.items())
    head, rest = _ROLE_SHIM.split(";", 1)
    return head + ";" + baked + rest


def _rendezvous(args):
    return {
        "DMLC_PS_ROOT_URI": os.environ.get("DMLC_PS_ROOT_URI",
                                           socket.gethostname()),
        "DMLC_PS_ROOT_PORT": str(args.port or 9091),
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": str(args.num_servers),
    }


def launch_mpi(args, command, runner=None):
    """``mpirun``/``srun`` start num_servers + num_workers ranks; ranks
    [0, ns) are servers, the rest workers.  Export ``DMLC_PS_ROOT_URI``
    as the node of ranks [0, ns) on a multi-node allocation (the
    default, this host, is right only when they land here);
    ``-H/--hostfile`` is not read, placement is mpirun's."""
    nproc = args.num_workers + args.num_servers
    env = _rendezvous(args)
    if runner is None:
        runner = "srun" if args.launcher == "slurm" else "mpirun"
    cmd = [runner, "-n", str(nproc), sys.executable, "-c",
           _role_shim(env)] + list(command)
    try:
        return subprocess.call(cmd, env={**os.environ, **env})
    except FileNotFoundError:
        sys.stderr.write(
            "%s not found on PATH; the equivalent command is:\n  %s\n"
            % (runner, " ".join(cmd)))
        return 127


def launch_sge(args, command):
    """A ``qsub`` job array of num_servers + num_workers tasks; each
    task takes its role from ``$SGE_TASK_ID`` through the mpi shim
    (tasks [1, ns] are servers).  Export ``DMLC_PS_ROOT_URI`` as a host
    the compute nodes reach."""
    import tempfile
    nproc = args.num_workers + args.num_servers
    env = _rendezvous(args)
    script = "\n".join([
        "#!/bin/sh",
        "#$ -t 1-%d" % nproc,
        "#$ -cwd",
        "#$ -S /bin/sh",
        "export OMPI_COMM_WORLD_RANK=$(($SGE_TASK_ID - 1))",
        " ".join("export %s=%s;" % kv for kv in env.items()),
        "exec %s -c '%s' %s" % (
            sys.executable, _role_shim(env).replace("'", "'\\''"),
            " ".join(command)),
        "",
    ])
    with tempfile.NamedTemporaryFile("w", suffix=".sge.sh",
                                     delete=False) as f:
        f.write(script)
        path = f.name
    cmd = ["qsub", "-sync", "y", path]
    try:
        return subprocess.call(cmd, env={**os.environ, **env})
    except FileNotFoundError:
        sys.stderr.write(
            "qsub not found on PATH; submit the generated job script "
            "yourself:\n  %s\n" % path)
        return 127


_WORKER = ("from mxnet_tpu_torch.serving import run_worker; "
           "run_worker()")


def launch_serve(args, command):
    """The disaggregated serving launcher: ``--prefill`` + ``--decode``
    worker processes running ``mxnet_tpu_torch.serving.run_worker``, and
    ``command`` as the router process, wired through the
    ``MXNET_SERVE_*`` environment.  The router script builds
    ``DisaggServingCluster(..., spawn=False, prefill=<n>, decode=<m>,
    port=int(os.environ["MXNET_SERVE_ROUTER_PORT"]))``; the workers
    connect to it as spawned ones do.  ``--workers-only`` starts only
    workers, named from ``--worker-start``, against a live router at
    ``--router-host:-p`` (its ``add_worker(role, spawn=False)`` waits
    for exactly those names).  The workers are stopped when the router
    exits."""
    if args.workers_only and not args.port:
        sys.stderr.write(
            "--workers-only: -p/--port must name the live router's "
            "control port\n")
        return 2
    port = args.port or _free_port()
    base_env = _with_root(dict(os.environ))
    base_env.update({
        "MXNET_SERVE_ROUTER_HOST": args.router_host,
        "MXNET_SERVE_ROUTER_PORT": str(port),
        "MXNET_SERVE_PREFILL": str(args.prefill),
        "MXNET_SERVE_DECODE": str(args.decode),
    })
    router = None
    if not args.workers_only:
        router = subprocess.Popen(command, env=base_env)
    workers = []
    for role, n in (("prefill", args.prefill), ("decode", args.decode)):
        for i in range(n):
            env = dict(base_env, MXNET_SERVE_ROLE=role,
                       MXNET_SERVE_WORKER="%s%d" % (role,
                                                    args.worker_start + i))
            workers.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER], env=env))
    try:
        if router is not None:
            code = router.wait()
        else:
            code = 0
            for p in workers:
                p.wait()
                code = code or p.returncode
    finally:
        # the workers go with the router, and on an abnormal exit of a
        # --workers-only launcher
        _stop(workers)
    return code


_HTTP = ("import sys; from mxnet_tpu_torch.serving.http_frontend import "
         "main; sys.exit(main(sys.argv[1:]))")


def launch_http(args, command):
    """Run the streaming HTTP/SSE server
    (``mxnet_tpu_torch.serving.http_frontend``) as the foreground process.
    The command's tokens go to its CLI (``--disagg``, ``--replicas N``,
    ``--keys FILE|JSON``, ``--device``, the model's shape); ``-p``
    is its listening port (default: ``MXNET_SERVE_HTTP_PORT``, else one
    the OS assigns, printed as JSON at startup).  The server serves a
    GPT with seeded random weights; a deployment embeds
    :class:`mxnet_tpu_torch.serving.HttpFrontend` over its own cluster
    (``docs/http_api.md``)."""
    command = list(command)
    if command[:1] == ["--"]:              # argparse.REMAINDER keeps it
        command = command[1:]
    # a -c entry, not -m: the serving package imports http_frontend when
    # it is imported, so runpy would warn about a second module object
    cmd = [sys.executable, "-c", _HTTP]
    if args.port:
        cmd += ["--port", str(args.port)]
    cmd += command
    proc = subprocess.Popen(cmd, env=_with_root(dict(os.environ)))
    # a SIGTERM to the launcher stops the server the way ^C does: it
    # closes its front door and its cluster, and the launcher returns
    # its exit code
    prev = signal.signal(signal.SIGTERM,
                         lambda *a: proc.send_signal(signal.SIGTERM))
    try:
        return proc.wait()
    except KeyboardInterrupt:
        proc.send_signal(signal.SIGTERM)
        return proc.wait()
    finally:
        signal.signal(signal.SIGTERM, prev)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.launch",
        description="Start a parameter-server job: servers and workers "
                    "with the DMLC_* environment.")
    ap.add_argument("-n", "--num-workers", type=int, default=None)
    ap.add_argument("-s", "--num-servers", type=int, default=1)
    ap.add_argument("--launcher", choices=["local", "ssh", "mpi",
                                           "slurm", "sge", "yarn",
                                           "serve", "http"],
                    default="local")
    ap.add_argument("--prefill", type=int, default=1,
                    help="serve launcher: prefill worker processes")
    ap.add_argument("--decode", type=int, default=1,
                    help="serve launcher: decode worker processes")
    ap.add_argument("--workers-only", action="store_true",
                    help="serve launcher: start only workers against a "
                         "live router at --router-host:-p; no router "
                         "command runs")
    ap.add_argument("--router-host", default="127.0.0.1",
                    help="serve launcher: the router's control host")
    ap.add_argument("--worker-start", type=int, default=0,
                    help="serve launcher: the first worker index of "
                         "each role")
    ap.add_argument("-H", "--hostfile", default=None)
    ap.add_argument("-p", "--port", type=int, default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.launcher == "http":
        return launch_http(args, args.command)
    if args.launcher == "serve":
        if not args.command and not args.workers_only:
            ap.error("no command given")
        return launch_serve(args, args.command)
    if not args.command:
        ap.error("no command given")
    if args.num_workers is None:
        ap.error("-n/--num-workers is required for this launcher")
    if args.launcher == "local":
        return launch_local(args, args.command)
    if args.launcher in ("mpi", "slurm"):
        return launch_mpi(args, args.command)
    if args.launcher == "sge":
        return launch_sge(args, args.command)
    if args.launcher == "yarn":
        sys.stderr.write(
            "yarn launcher: not supported in this build (needs a Hadoop "
            "cluster + the dmlc-yarn client jar; use ssh/mpi/slurm/sge "
            "against the same DMLC_* contract instead)\n")
        return 2
    return launch_ssh(args, args.command)


if __name__ == "__main__":
    sys.exit(main())
