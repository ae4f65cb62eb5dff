"""The port's public surface against the reference's, on the CPU.

The walk imports every module of ``mxnet_tpu`` that has a counterpart
file in ``mxnet_tpu_torch`` (the op implementation modules
``ops/<family>.py`` aside: the op registry's own coverage test,
``test_every_reference_op_is_ported_and_held``, holds those) and fails
on any public name of the reference module that the port module lacks:
for a package every public attribute but its submodules, for a module
what it defines or lists in ``__all__`` (not what it imports), and for
each class it defines every public attribute.  Submodules are files:
which of them a package holds as attributes depends on what else the
process imported, so the walk leaves them to a file check instead,
which holds the reference's files without a counterpart to the list and
the count in ``ROADMAP.md`` §A.  ``DEFERRED`` names each gap with the
``ROADMAP.md`` §A item that ports it, ``JAX_ONLY`` each name that has
no meaning without JAX, with the reason; the walk fails as well when a
name of either table is in the port (the table is stale then) or no
longer in the reference.

The parity cases below hold the names this table once lacked against
the reference: the top-level names, ``Block`` hooks (fired as often as
in the reference, pinned counts), ``apply``, ``summary``,
``infer_shape``, ``ParameterDict.get_constant``/``setattr``/``save``/
``load``, ``gluon.Constant``, ``Trainer.update``, ``sym.zeros``/
``ones``/``contrib``, ``NDArray(data, ctx=)`` and ``version``, the
serving re-exports and engine properties, and ``base``'s helpers.
Values are f32 results of one or two roundings: ``rtol 1e-6``.
"""
import importlib
import io
import os
import re
import subprocess
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
from _torch_port import cuda_device  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DIST = ["moe_param_shardings",
         "pipeline_apply", "ring_attention",
         "sequence_parallel_attention", "stack_layer_params",
         "ulysses_attention"]

# "module:name" -> the ROADMAP.md section A item that ports it
DEFERRED = {}
DEFERRED.update({"mxnet_tpu.parallel.mesh:init_sharded_opt_state": "A.7b",
                 "mxnet_tpu.parallel.mesh:opt_state_shardings": "A.7b",
                 "mxnet_tpu.parallel.mesh:zero1_sharding": "A.7b",
                 "mxnet_tpu.parallel.multihost:global_mesh": "A.7b",
                 "mxnet_tpu.parallel.multihost:host_staged_put": "A.7b",
                 # the sharding tables of expert parallelism over ep > 1
                 "mxnet_tpu.parallel.moe:moe_param_shardings": "A.7b",
                 "mxnet_tpu.parallel.moe:moe_param_specs": "A.7b"})
DEFERRED.update({"mxnet_tpu.parallel:%s" % n: "A.7b" for n in _DIST})

_SPECS = "a jax.sharding PartitionSpec table; the port's counterpart, if " \
    "any, comes with the multi-device item (A.7b)"
JAX_ONLY = {
    "mxnet_tpu.random:next_key": "splits the jax.random key; the port "
    "draws from torch's generators",
    "mxnet_tpu.random:push_trace_key": "threads a key through a jit trace",
    "mxnet_tpu.random:pop_trace_key": "threads a key through a jit trace",
    "mxnet_tpu.random:uses_rng_in_trace": "asks whether a jit trace drew "
    "from the key",
    "mxnet_tpu.autograd:record_op": "the reference's own tape; the port's "
    "tape is torch's graph",
    "mxnet_tpu.context:Context.jax_device": "the JAX device of a context; "
    "the port's is Context.torch_device",
    "mxnet_tpu.engine:Engine.note": "keeps JAX's asynchronous results for "
    "wait_for_all; torch's stream orders the port's",
    "mxnet_tpu.ops.registry:OpDef.cacheable": "the eager jit cache's flag; "
    "torch runs eagerly",
    "mxnet_tpu.kernels.fused_optimizer:group_flatten": "the Pallas "
    "kernel's padded flat buffer; the CUDA kernel reads each tensor in "
    "place through a pointer table",
    "mxnet_tpu.kernels.fused_optimizer:group_unflatten": "the inverse of "
    "group_flatten",
    "mxnet_tpu.rtc:PallasModule.get_kernel": "Pallas source cannot run on "
    "the card; PallasModule refuses, rtc.CudaModule takes CUDA source",
    "mxnet_tpu.models.gpt:decode_param_specs": _SPECS,
    "mxnet_tpu.models.transformer:param_shardings": _SPECS,
    "mxnet_tpu.models.transformer:param_specs": _SPECS,
    "mxnet_tpu.models.transformer:train_step_input_specs": _SPECS,
    "mxnet_tpu.models.transformer:train_step_output_specs": _SPECS,
    "mxnet_tpu.serving.engine:step_input_specs": _SPECS,
    "mxnet_tpu.serving.engine:step_output_specs": _SPECS,
    "mxnet_tpu.serving.paged_kv:PagedKVCache.POOL_SPEC": _SPECS,
    "mxnet_tpu.serving.paged_kv:PagedKVCache.S_POOL_SPEC": _SPECS,
}


def _modules(pkg):
    base = os.path.join(ROOT, pkg)
    out = set()
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), base)[:-3]
                rel = rel.replace(os.sep, ".")
                if rel.endswith("__init__"):
                    rel = rel[:-len("__init__")].rstrip(".")
                out.add(rel)
    return out


def _ported_modules():
    both = _modules("mxnet_tpu") & _modules("mxnet_tpu_torch")
    rels = sorted(m for m in both
                  if not m.startswith("ops.") or m == "ops.registry")
    pairs = []
    for rel in rels:
        suffix = "." + rel if rel else ""
        pairs.append((importlib.import_module("mxnet_tpu" + suffix),
                      importlib.import_module("mxnet_tpu_torch" + suffix)))
    return pairs


def _public(mod):
    """The public names of a reference module (see the docstring)."""
    is_pkg = mod.__file__.endswith("__init__.py")
    names = {n for n in getattr(mod, "__all__", ()) if hasattr(mod, n)}
    for n, v in vars(mod).items():
        if is_pkg or getattr(v, "__module__", None) == mod.__name__ or \
                (n.isupper() and not callable(v)):
            names.add(n)
    return sorted(n for n in names if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType))


def _walk():
    """(every "module:name" of the reference the port lacks, every one
    it has)."""
    missing, present = [], []
    pairs = _ported_modules()
    for ref, port in pairs:
        for n in _public(ref):
            key = "%s:%s" % (ref.__name__, n)
            (present if hasattr(port, n) else missing).append(key)
            a, b = getattr(ref, n), getattr(port, n, None)
            if isinstance(a, type) and a.__module__ == ref.__name__ \
                    and b is not None:
                for attr in dir(a):
                    if not attr.startswith("_"):
                        k = "%s.%s" % (key, attr)
                        (present if hasattr(b, attr) else missing).append(k)
    return missing, present


def test_every_public_name_is_ported_deferred_or_jax_only():
    missing, present = _walk()
    unlisted = [k for k in missing if k not in DEFERRED
                and k not in JAX_ONLY]
    assert not unlisted, unlisted
    stale = [k for k in list(DEFERRED) + list(JAX_ONLY) if k in present]
    assert not stale, "ported now, take out of the table: %s" % stale
    gone = [k for k in list(DEFERRED) + list(JAX_ONLY) if k not in missing]
    assert not gone, "no longer in the reference: %s" % gone
    assert set(DEFERRED.values()) <= {"A.%d" % i for i in range(1, 10)} | {
        "A.7b"}


def test_deferred_items_are_in_the_roadmap():
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    section = text[text.index("### A."):text.index("### B.")]
    for item in sorted(set(DEFERRED.values())):
        assert "\n%s. **" % item[2:] in section, item


def _files(pkg):
    base = os.path.join(ROOT, pkg)
    return {os.path.relpath(os.path.join(d, f), base)
            for d, _, fs in os.walk(base) for f in fs if f.endswith(".py")
            and "__pycache__" not in d}


def test_every_unported_file_is_queued_in_the_roadmap():
    """The reference's files without a counterpart are as many as
    ``ROADMAP.md`` §A counts, and §A names each (by its last two path
    components, or its name)."""
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    section = text[text.index("### A."):text.index("### B.")]
    missing = sorted(_files("mxnet_tpu") - _files("mxnet_tpu_torch"))
    count = re.search(r"The count is (\d+)", section)
    assert count and int(count.group(1)) == len(missing), len(missing)
    for path in missing:
        parts = path.split(os.sep)
        assert "/".join(parts[-2:]) in section or \
            "`%s`" % parts[-1] in section, path


# --- top level and context -------------------------------------------------
def test_import_builds_no_kernel_and_leaves_cuda_alone():
    """``import mxnet_tpu_torch`` gives ``mx.models``, ``mx.profiler``,
    ``mx.obs`` and the context names without building a kernel or
    initializing CUDA."""
    code = ("import torch, mxnet_tpu_torch as mx\n"
            "import mxnet_tpu_torch.kernels._build as b\n"
            "assert mx.models.gpt and mx.models.transformer\n"
            "assert mx.profiler.set_config and mx.obs\n"
            "assert mx.NDArray is mx.nd.NDArray\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not b._LOADED if hasattr(b, '_LOADED') else True\n"
            "print(mx.num_tpus(), mx.num_gpus())\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", str(torch.cuda.device_count())]


def test_context_names_match_the_reference():
    from _torch_port import reference as R
    assert P.Context.devtype2str == R.Context.devtype2str
    assert P.Context.devstr2type == R.Context.devstr2type
    for s in ("cpu", "cpu(0)", "gpu(1)", " cpu_pinned(2) "):
        a, b = P.context.device(s), R.context.device(s)
        assert (a.device_type, a.device_id, a.device_typeid) == \
            (b.device_type, b.device_id, b.device_typeid)
    assert P.cpu_pinned(1) == P.Context("cpu_pinned", 1) != P.cpu(1)
    assert P.cpu_pinned().torch_device == torch.device("cpu")
    with P.cpu():
        assert P.Context.default_ctx() == P.cpu()
    assert P.num_tpus() == 0
    assert P.num_gpus() == torch.cuda.device_count()
    with pytest.raises(P.base.NotPorted):
        P.tpu()
    with pytest.raises(P.base.NotPorted):
        P.Context("cpu_shared")


def test_pinned_arrays_need_cuda():
    """Page-locked memory needs CUDA: without it, making a
    ``cpu_pinned`` array raises instead of handing back pageable
    memory."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is here: the cuda case pins")
    with pytest.raises(RuntimeError):
        P.nd.zeros((2,), ctx=P.cpu_pinned())


@pytest.mark.cuda
def test_pinned_arrays_are_page_locked(cuda_device):
    a = P.nd.array(np.arange(4, dtype=np.float32), ctx=P.cpu_pinned())
    b = P.nd.ones((3,), ctx=P.gpu(0)).copyto(P.cpu_pinned())
    c = P.NDArray(np.ones(2, np.float32), ctx=P.cpu_pinned())
    for x in (a, b, c, P.nd.zeros((2, 2), ctx=P.cpu_pinned())):
        assert x._data.is_pinned() and x._data.device.type == "cpu"
    np.testing.assert_array_equal(b.asnumpy(), np.ones(3, np.float32))


def test_ndarray_constructor_and_version_match_the_reference():
    from _torch_port import reference as R
    src = np.arange(6, dtype=np.float64).reshape(2, 3)
    a, b = R.NDArray(src), P.NDArray(src, ctx=P.cpu())
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    t = torch.ones(2)
    assert P.NDArray(t)._data is t
    assert P.NDArray(P.NDArray(t))._data is t
    for x in (a, b):           # twin of tests/test_ndarray.py:48
        v0 = x.version
        x += 1
        assert x.version > v0
        x[0] = 5.0
    assert a.version == b.version


# --- Gluon blocks ----------------------------------------------------------
def _hooked_net(pkg, ctx, deferred):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="top_")
    with net.name_scope():
        if deferred:
            net.add(nn.Dense(4, prefix="d0_"), nn.Dense(2, prefix="d1_"))
        else:
            net.add(nn.Dense(4, in_units=3, prefix="d0_"),
                    nn.Dense(2, in_units=4, prefix="d1_"))
    net.initialize(ctx=ctx)
    counts = {}

    def counter(name):
        def hook(block, *args):
            assert isinstance(block, pkg.gluon.Block)
            counts[name] = counts.get(name, 0) + 1
        return hook
    net.register_forward_pre_hook(counter("top_pre"))
    net.register_forward_hook(counter("top"))
    net[0].register_forward_hook(counter("c0"))
    net[1].register_forward_pre_hook(counter("c1_pre"))
    return net, counts


def _hook_trace(pkg, ctx, hybrid, deferred):
    net, counts = _hooked_net(pkg, ctx, deferred)
    if hybrid:
        net.hybridize()
    x = pkg.nd.ones((2, 3), ctx=ctx)
    seen = []
    for _ in range(3):
        net(x)
        seen.append(dict(counts))
    for _ in range(2):
        with pkg.autograd.record():
            y = net(x)
        y.backward()
        seen.append(dict(counts))
    net(pkg.nd.ones((5, 3), ctx=ctx))
    seen.append(dict(counts))
    with pkg.autograd.train_mode():
        net(x)
    seen.append(dict(counts))
    return seen


# the reference's counts (measured with this counting hook): on a
# hybridized block the children's hooks fire twice for each new
# signature, plus once for the probe that finishes deferred shapes
HOOK_COUNTS = {
    (True, False): [(1, 2, 2, 1), (2, 2, 2, 2), (3, 2, 2, 3), (4, 4, 4, 4),
                    (5, 4, 4, 5), (6, 6, 6, 6), (7, 6, 6, 7)],
    (True, True): [(1, 3, 3, 1), (2, 3, 3, 2), (3, 3, 3, 3), (4, 5, 5, 4),
                   (5, 5, 5, 5), (6, 7, 7, 6), (7, 7, 7, 7)],
    (False, False): [(i, i, i, i) for i in range(1, 8)],
}


@pytest.mark.parametrize("hybrid,deferred", sorted(HOOK_COUNTS))
def test_forward_hooks_fire_as_often_as_in_the_reference(hybrid, deferred):
    """(top pre-hook, child 0 hook, child 1 pre-hook, top hook) after
    3 calls, 2 recorded calls with backward, a new batch size and a
    train-mode call."""
    from _torch_port import reference as R
    want = [tuple(c.get(k, 0) for k in ("top_pre", "c0", "c1_pre", "top"))
            for c in _hook_trace(R, R.cpu(), hybrid, deferred)]
    got = [tuple(c.get(k, 0) for k in ("top_pre", "c0", "c1_pre", "top"))
           for c in _hook_trace(P, P.cpu(), hybrid, deferred)]
    assert want == HOOK_COUNTS[(hybrid, deferred)]
    assert got == want


@pytest.mark.cuda
def test_forward_hooks_under_replayed_cuda_graphs(cuda_device):
    """On the card the entries are captured CUDA graphs (warm-up,
    capture, replicas): the hooks still fire the reference's counts."""
    got = [tuple(c.get(k, 0) for k in ("top_pre", "c0", "c1_pre", "top"))
           for c in _hook_trace(P, P.gpu(0), True, True)]
    assert got == HOOK_COUNTS[(True, True)]


def test_apply_summary_and_infer_shape_match_the_reference():
    from _torch_port import reference as R
    outs = []
    for pkg, ctx in ((R, R.cpu()), (P, P.cpu())):
        net, _ = _hooked_net(pkg, ctx, deferred=True)
        order = []
        assert net.apply(lambda b: order.append(b.name)) is net
        net[0].infer_shape(pkg.nd.ones((2, 3), ctx=ctx))
        buf = io.StringIO()
        with redirect_stdout(buf):
            net.summary(pkg.nd.ones((2, 3), ctx=ctx))
        outs.append((order, net[0].weight.shape, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[1][0] == ["top_d0", "top_d1", "top"]
    assert outs[1][1] == (4, 3)


# --- Gluon parameters and the Trainer -------------------------------------
def test_parameter_dict_constant_setattr_save_load(tmp_path):
    """``get_constant`` (and ``gluon.Constant``), ``setattr`` and
    ``save``/``load`` against the reference; each package loads the
    other's file, by ``ParameterDict.load`` and ``load_parameters``."""
    from _torch_port import reference as R
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    dicts = {}
    for name, pkg, ctx in (("ref", R, R.cpu()), ("port", P, P.cpu())):
        pd = pkg.gluon.ParameterDict("net_")
        c = pd.get_constant("c", value)
        assert isinstance(c, pkg.gluon.Constant)
        assert pd.get_constant("c") is c
        with pytest.raises(pkg.MXNetError):
            pd.get_constant("missing")
        w = pd.get("w", shape=(3, 2))
        pd.initialize(pkg.initializer.Uniform(0.5), ctx=ctx)
        w.set_data(pkg.nd.array(value.T * 0.5, ctx=ctx))
        pd.setattr("lr_mult", 0.5)
        assert w.lr_mult == c.lr_mult == 0.5
        assert c.grad_req == "null"
        np.testing.assert_array_equal(c.data().asnumpy(), value)
        pd.save(str(tmp_path / ("%s.params" % name)), strip_prefix="net_")
        dicts[name] = (pkg, ctx)
    for writer in ("ref", "port"):
        for reader, (pkg, ctx) in dicts.items():
            pd = pkg.gluon.ParameterDict("net_")
            pd.get("w", shape=(3, 2))
            pd.get_constant("c", np.zeros((2, 3), np.float32))
            pd.load(str(tmp_path / ("%s.params" % writer)), ctx=ctx,
                    restore_prefix="net_")
            np.testing.assert_array_equal(pd["net_w"].data().asnumpy(),
                                          value.T * 0.5)
            np.testing.assert_array_equal(pd["net_c"].data().asnumpy(),
                                          value)
    # a Block reads ParameterDict.save's full names
    dense = P.gluon.nn.Dense(2, in_units=3, prefix="net_")
    dense.collect_params().initialize(ctx=P.cpu())
    dense.collect_params().save(str(tmp_path / "dense.params"))
    twin = R.gluon.nn.Dense(2, in_units=3, prefix="net_")
    twin.load_parameters(str(tmp_path / "dense.params"))
    np.testing.assert_array_equal(twin.weight.data().asnumpy(),
                                  dense.weight.data().asnumpy())
    pd = P.gluon.ParameterDict("net_")
    pd.get("other", shape=(1,))
    with pytest.raises(P.MXNetError, match="missing"):
        pd.load(str(tmp_path / "port.params"), ctx=P.cpu(),
                restore_prefix="net_")


def _trained(pkg, ctx, clip, split):
    """One SGD step of a small net: ``step`` or, with ``split``,
    ``allreduce_grads`` + (clip) + ``update``."""
    net = pkg.gluon.nn.HybridSequential(prefix="t_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(5, in_units=4, activation="tanh",
                                   prefix="a_"),
                pkg.gluon.nn.Dense(3, in_units=5, prefix="b_"))
    net.initialize(pkg.initializer.Uniform(0.5), ctx=ctx)
    rng = np.random.RandomState(0)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(rng.randn(*p.shape).astype(np.float32),
                                ctx=ctx))
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9,
                            "wd": 1e-3})
    x = pkg.nd.array(rng.randn(6, 4).astype(np.float32), ctx=ctx)
    for _ in range(2):
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        if not split:
            tr.step(6)
            continue
        tr.allreduce_grads()
        if clip:
            pkg.gluon.utils.clip_global_norm(
                [p.grad() for p in net.collect_params().values()], 1.0)
        tr.update(6)
    return [p.data().asnumpy() for p in net.collect_params().values()]


def test_trainer_update_equals_step_bit_for_bit():
    step = _trained(P, P.cpu(), clip=False, split=False)
    update = _trained(P, P.cpu(), clip=False, split=True)
    for a, b in zip(step, update):
        np.testing.assert_array_equal(a, b)


def test_trainer_update_after_clip_matches_the_reference():
    from _torch_port import reference as R
    want = _trained(R, R.cpu(), clip=True, split=True)
    got = _trained(P, P.cpu(), clip=True, split=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# --- symbols, base, library, serving ---------------------------------------
def test_sym_zeros_ones_and_contrib_match_the_reference():
    from _torch_port import reference as R
    graphs = []
    for pkg in (R, P):
        with pkg.name.NameManager():
            s = pkg.sym.zeros((2, 3), name="z") + pkg.sym.ones((2, 3))
            graphs.append(s.tojson())
    assert graphs[0] == graphs[1]
    ref_contrib = {n for n in vars(R.sym.contrib) if not n.startswith("_")}
    got = {n for n in vars(P.sym.contrib) if not n.startswith("_")}
    assert got and got <= ref_contrib
    for n in got:
        assert P.ops.registry.op_exists("_contrib_" + n)


def test_base_helpers_match_the_reference(monkeypatch):
    from _torch_port import reference as R
    for v in (None, "0", "false", "off", "", "1", "yes"):
        if v is None:
            monkeypatch.delenv("MXT_SURFACE_FLAG", raising=False)
        else:
            monkeypatch.setenv("MXT_SURFACE_FLAG", v)
        assert P.base.env_flag("MXT_SURFACE_FLAG", True) == \
            R.base.env_flag("MXT_SURFACE_FLAG", True)
        assert P.base.env_int("MXT_SURFACE_FLAG", 7) == \
            R.base.env_int("MXT_SURFACE_FLAG", 7)
    assert (P.base.string_types, P.base.integer_types) == \
        (R.base.string_types, R.base.integer_types)
    for pkg in (R, P):
        class Conf(pkg.base.Parameter):
            mode = pkg.base.ParamSpec("mode", default="a", choices=("a",
                                                                    "b"))
            n = pkg.base.ParamSpec("n", required=True)

        assert Conf.init(n=3) == {"mode": "a", "n": 3}
        with pytest.raises(pkg.MXNetError):
            Conf.init(mode="c", n=1)
        with pytest.raises(pkg.MXNetError):
            Conf.init()

        class K:
            @pkg.base.classproperty
            def name(cls):
                return cls.__name__
        assert K.name == "K"
    assert P.base.Registry.get("optimizer").list() == \
        sorted(P.optimizer.optimizer._REG._entries)
    assert "sgd" in P.base.Registry.get("optimizer")
    assert P.library.LIB_API_VERSION == R.library.LIB_API_VERSION
    assert P.ops.OpDef is P.ops.registry.OpDef
    assert P.gluon.model_zoo.get_model is \
        P.gluon.model_zoo.vision.get_model


def test_serving_names_and_engine_properties():
    """The package re-exports ``PrefixCache`` and ``ngram_draft``; the
    engine's ``free_slots`` follows the reference's on the same
    requests, and its per-device bytes are its bytes (one card)."""
    import mxnet_tpu.serving as RS
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving import prefix_cache, drafters
    from _torch_port import configs, numpy_params, to_port
    assert serving.PrefixCache is prefix_cache.PrefixCache
    assert serving.ngram_draft is drafters.ngram_draft
    np.testing.assert_array_equal(
        serving.ngram_draft([1, 2, 3, 1, 2], 2),
        RS.ngram_draft([1, 2, 3, 1, 2], 2))
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, 0)
    eng = serving.ServingEngine(to_port(tree), tcfg, device="cpu",
                                num_slots=3, page_size=4)
    ref = RS.ServingEngine(tree, jcfg, num_slots=3, page_size=4)
    free = []
    for e in (ref, eng):
        seen = [e.free_slots]
        for n in (4, 6):
            e.submit(np.arange(1, n + 1), 3)
        e.step()
        seen.append(e.free_slots)
        seen.append(e.hbm_held_per_device == e.hbm_held > 0)
        seen.append(e.hbm_pool_per_device == e.hbm_pool > 0)
        free.append(seen)
    assert free[0] == free[1] == [3, 1, True, True]
    cfg = tcfg
    assert serving.paged_kv.contiguous_kv_bytes(cfg, 2, 16) == \
        RS.paged_kv.contiguous_kv_bytes(jcfg, 2, 16)
