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
reference; ``serve`` and ``http`` belong to the serving cluster, which
is not ported (``ROADMAP.md`` item 8).

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


def launch_serve(args, command):
    from ..base import not_ported
    raise not_ported("the serve launcher (ROADMAP.md item 8)",
                     "tools/launch.py launch_serve")


def launch_http(args, command):
    from ..base import not_ported
    raise not_ported("the http launcher (ROADMAP.md item 8)",
                     "tools/launch.py launch_http")


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
    ap.add_argument("-H", "--hostfile", default=None)
    ap.add_argument("-p", "--port", type=int, default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.launcher == "http":
        return launch_http(args, args.command)
    if args.launcher == "serve":
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
