"""Worker script for the port's parameter-server jobs.

Started by the port's launcher, one process a worker::

    python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 --launcher local \\
        python tests/_torch_dist_worker.py [--multihost | --resnet DIR ...]

* no option: the twin of ``tests/dist_sync_kvstore.py`` on the CPU:
  ``dist_sync`` init, push and pull, the round-by-round sums, the keyed
  list API and the barrier; prints ``OK``.
* ``--multihost`` (``-s 0``): joins the job through
  ``parallel.multihost`` (``gloo``), prints its rank and process count
  and checks that the ``horovod`` store refuses a job of several
  processes.
* ``--resnet DIR``: ResNet-50 v1 at ImageNet width on the card, trained
  through the server: worker 0 ships ``SGD(0.1, momentum 0.9, wd 1e-4)``
  (the server updates, MXNet's ``update_on_kvstore``), each step runs
  forward and backward on the worker's own 32 images, pushes the 193
  gradients (102 MB) as one keyed list and pulls the weights.  After
  ``--steps N`` steps it writes the weights (``worker<rank>_plain.npz``
  in ``DIR``), turns on 2-bit compression for ``--compressed-steps M``
  more, then writes the final weights (``worker<rank>.npz``) and its
  timings and launch counts (``worker<rank>.json``).

``chip_smoke.py`` replays the ResNet run in its own process with the
same helpers (:func:`resnet_net`, :func:`resnet_batch`,
:data:`RESNET_OPT`).  The script imports the port only, never JAX.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402

RESNET_BATCH = 32          # a worker's share of bench.py's batch of 64
RESNET_WORKERS = 2
RESNET_SEED = 0
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
              "rescale_grad": 1.0 / (RESNET_BATCH * RESNET_WORKERS)}
RESNET_COMPRESSION = {"type": "2bit", "threshold": 0.5}


def dist_sync_check():
    """``tests/dist_sync_kvstore.py``'s checks, on the CPU."""
    kv = mx.kv.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    shape = (3, 4)
    ctx = mx.cpu()
    kv.init("w", mx.nd.zeros(shape, ctx=ctx))
    out = mx.nd.zeros(shape, ctx=ctx)
    kv.pull("w", out=out)
    assert np.all(out.asnumpy() == 0), "init pull mismatch"
    for step in range(3):
        kv.push("w", mx.nd.ones(shape, ctx=ctx))
        kv.pull("w", out=out)
        expect = (step + 1) * nw
        got = out.asnumpy()
        assert np.all(got == expect), \
            "rank %d step %d: got %r want %r" % (rank, step, got[0, 0],
                                                 expect)
    kv.barrier()
    kv.init([1, 2], [mx.nd.zeros(shape, ctx=ctx), mx.nd.ones(shape, ctx=ctx)])
    kv.push([1, 2], [mx.nd.ones(shape, ctx=ctx), mx.nd.ones(shape, ctx=ctx)])
    o1, o2 = mx.nd.zeros(shape, ctx=ctx), mx.nd.zeros(shape, ctx=ctx)
    kv.pull([1, 2], out=[o1, o2])
    assert np.all(o1.asnumpy() == nw)
    assert np.all(o2.asnumpy() == 1 + nw)
    kv.barrier()
    kv.close()
    assert not {"jax", "mxnet_tpu"} & set(sys.modules), "imported JAX"
    print("dist_sync_kvstore: rank %d/%d OK" % (rank, nw), flush=True)


def multihost_check():
    from mxnet_tpu_torch.parallel import multihost
    multihost.initialize()
    rank, n = multihost.rank(), multihost.num_hosts()
    assert rank == int(os.environ["DMLC_WORKER_ID"]), rank
    assert n == int(os.environ["DMLC_NUM_WORKER"]), n
    try:
        mx.kv.create("horovod")
    except mx.MXNetError as e:
        assert "%d-process" % n in str(e), e
    else:
        raise AssertionError("horovod store took a %d-process job" % n)
    multihost.shutdown()
    assert not {"jax", "mxnet_tpu"} & set(sys.modules), "imported JAX"
    print("multihost: rank %d/%d OK" % (rank, n), flush=True)


def deterministic():
    """The settings under which two processes compute the same bits."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resnet_net(ctx, seed=RESNET_SEED):
    """ResNet-50 v1 at ImageNet width, hybridized, its parameters made
    from ``seed`` (deferred shapes resolved by one forward)."""
    np.random.seed(seed)
    mx.random.seed(seed)
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.predict_mode():
        net(mx.nd.zeros((1, 3, 224, 224), ctx=ctx))
    net.hybridize()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    return net, params


def resnet_batch(rank, step, ctx, seed=RESNET_SEED):
    """Worker ``rank``'s images and labels of ``step``, drawn on the
    card from a generator of its own."""
    g = torch.Generator(device=ctx.torch_device)
    g.manual_seed(1000 * (seed + 1) + 100 * rank + step)
    x = torch.randn(RESNET_BATCH, 3, 224, 224, generator=g,
                    device=ctx.torch_device)
    y = torch.randint(0, 1000, (RESNET_BATCH,), generator=g,
                      device=ctx.torch_device).float()
    return mx.nd.NDArray(x), mx.nd.NDArray(y)


def resnet_grads(net, params, loss_fn, x, y, ctx):
    with mx.autograd.record():
        L = loss_fn(net(x), y)
    L.backward()
    return [p.grad(ctx) for p in params]


def _save(path, params, ctx):
    np.savez(path, *[p.data(ctx).asnumpy() for p in params])


def resnet_worker(out_dir, steps, compressed_steps):
    from mxnet_tpu_torch.kernels._counters import registered
    deterministic()
    ctx = mx.gpu(0)
    for h, a in registered():
        setattr(h, a, 0)
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    net, params = resnet_net(ctx)
    keys = list(range(len(params)))
    kv.set_optimizer(mx.optimizer.SGD(**RESNET_OPT))
    kv.init(keys, [p.data(ctx) for p in params])
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rows = []
    for step in range(steps + compressed_steps):
        if step == steps:
            _save(os.path.join(out_dir, "worker%d_plain.npz" % rank),
                  params, ctx)
            kv.set_gradient_compression(RESNET_COMPRESSION)
        x, y = resnet_batch(rank, step, ctx)
        torch.cuda.synchronize()
        w0 = kv.wire_bytes()
        t0 = time.perf_counter()
        grads = resnet_grads(net, params, loss_fn, x, y, ctx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kv.push(keys, grads)
        t2 = time.perf_counter()
        kv.pull(keys, out=[p.data(ctx) for p in params])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        w1 = kv.wire_bytes()
        rows.append({"compressed": step >= steps,
                     "step_ms": (t3 - t0) * 1e3,
                     "compute_ms": (t1 - t0) * 1e3,
                     "push_ms": (t2 - t1) * 1e3, "pull_ms": (t3 - t2) * 1e3,
                     "sent": w1["sent"] - w0["sent"],
                     "received": w1["received"] - w0["received"]})
    kv.barrier()
    _save(os.path.join(out_dir, "worker%d.npz" % rank), params, ctx)
    launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__), a):
                getattr(h, a) for h, a in registered()}
    with open(os.path.join(out_dir, "worker%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "steps": rows, "launches": launches,
                   "n_params": len(params),
                   "bytes": int(sum(p.data(ctx).size * 4 for p in params))},
                  f)
    kv.close()
    print("resnet worker %d OK" % rank, flush=True)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--resnet", default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--compressed-steps", type=int, default=2)
    args = ap.parse_args(argv)
    if args.multihost:
        multihost_check()
    elif args.resnet:
        resnet_worker(args.resnet, args.steps, args.compressed_steps)
    else:
        dist_sync_check()


if __name__ == "__main__":
    main(sys.argv[1:])
