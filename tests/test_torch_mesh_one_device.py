"""Port parity: a mesh whose axes all have size 1 is the single-device
path, as in the reference (``live_axis``), and the reference's argument
errors of the mesh options are its ``MXNetError``s.

* ``ServingEngine(mesh=serving_mesh(1))`` gives the tokens of
  ``mesh=None`` and of the reference's engine on its own one-device
  mesh, with ``tp == 1`` and ``mesh is None`` (the reference's
  tests/test_serving_tp.py pins both); a mesh without a ``tp`` axis, a
  ``tp`` that disagrees with the mesh's and MoE params at ``tp > 1``
  raise the reference's ``ValueError``s; a live ``tp`` axis raises
  ``NotImplementedError``.  A ``ServingCluster`` takes the one-device
  mesh too.
* ``make_train_step(mesh=<one device>)`` and ``shard_optimizer=True``
  without a live ``dp`` axis give the losses and parameters of the
  plain step bit for bit, and the reference's one-device-mesh step's
  within the limits of tests/test_torch_train.py; ``forward_with_aux``
  and ``_attention`` (with ``cfg.seq_parallel`` and no live ``sp``
  axis) are the plain path; live axes raise ``NotImplementedError``.
* ``bucket_overlap`` of a bad value, ``bucket_overlap`` without
  ``fsdp`` or with MoE, ``fsdp`` without a live ``dp`` axis, and a
  mixed dense/MoE stack over a live ``pp`` axis raise ``MXNetError``
  with the reference's messages.
* ``quantize_decode_params`` of MoE params is the reference's bit for
  bit: attention weights quantized in every layer, the FFN's only in
  dense layers."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx  # noqa: F401  (conftest device setup)
from _torch_port import (configs, numpy_params, port_engine, ref_engine,
                         to_port)

CPU = torch.device("cpu")
_TOL = 1e-5
_P_ATOL = 5e-6


def _port_mesh(shape, n=1):
    from mxnet_tpu_torch.parallel import make_mesh
    return make_mesh(shape, devices=[CPU] * n)


def _cases(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 90, P).astype(np.int32), N)
            for P, N in [(5, 8), (3, 12), (9, 4), (7, 6)]]


def _serve(eng, cases):
    rids = [eng.submit(p, n) for p, n in cases]
    outs = eng.run()
    return [list(outs[r]) for r in rids]


# ---------------------------------------------------------------- serving --
@pytest.mark.parametrize("moe", [False, True])
def test_engine_on_a_one_device_mesh_is_the_single_device_engine(moe):
    from mxnet_tpu.parallel import serving_mesh as jmesh
    from mxnet_tpu_torch.parallel import serving_mesh
    kw = dict(n_experts=4, moe_every=2) if moe else {}
    jcfg, tcfg = configs(**kw)
    tree = numpy_params(jcfg, 3)
    eng_kw = dict(num_slots=2, page_size=4, prefill_chunk=6)
    one = serving_mesh(1, devices=[CPU])
    eng = port_engine(tree, tcfg, mesh=one, **eng_kw)
    assert eng.tp == 1 and eng.mesh is None and eng.device == CPU
    ref = ref_engine(tree, jcfg, mesh=jmesh(1), **eng_kw)
    assert ref.tp == 1 and ref.mesh is None
    cases = _cases()
    got = _serve(eng, cases)
    assert got == _serve(port_engine(tree, tcfg, **eng_kw), cases)
    assert got == _serve(ref, cases)
    assert _serve(port_engine(tree, tcfg, mesh=one, tp=1, **eng_kw),
                  cases) == got


def test_engine_mesh_errors_are_the_reference_s():
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, 3)
    kw = dict(num_slots=2, page_size=4)
    with pytest.raises(ValueError, match="mesh has no 'tp' axis"):
        port_engine(tree, tcfg, mesh=_port_mesh({"dp": 1}), **kw)
    with pytest.raises(ValueError, match="disagrees with the mesh's tp"):
        port_engine(tree, tcfg, mesh=_port_mesh({"tp": 1}), tp=2, **kw)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        port_engine(tree, tcfg, tp=0, **kw)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        port_engine(tree, tcfg, tp=3, **kw)
    mjcfg, mtcfg = configs(n_experts=4, moe_every=2)
    with pytest.raises(ValueError, match="MoE decode params are tp=1"):
        port_engine(numpy_params(mjcfg, 3), mtcfg, tp=2, **kw)
    for live in (dict(tp=2), dict(mesh=_port_mesh({"tp": 2}, 2)),
                 dict(mesh=_port_mesh({"tp": 1, "dp": 2}, 2))):
        with pytest.raises(NotImplementedError):
            port_engine(tree, tcfg, **kw, **live)


def test_cluster_on_a_one_device_mesh():
    from mxnet_tpu_torch.parallel import serving_mesh
    from mxnet_tpu_torch.serving import ServingCluster
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, 3)
    cases = _cases(1)
    want = _serve(port_engine(tree, tcfg, num_slots=2, page_size=4,
                              prefill_chunk=6), cases)
    cl = ServingCluster(to_port(tree), tcfg, replicas=2, num_slots=2,
                        page_size=4, prefill_chunk=6,
                        mesh=serving_mesh(1, devices=[CPU]))
    try:
        assert cl.device == CPU
        rids = [cl.submit(p, n) for p, n in cases]
        assert [list(cl.result(r, timeout=120)) for r in rids] == want
    finally:
        cl.close(timeout=60)


# --------------------------------------------------------------- training --
def _bert(**kw):
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models.transformer import TransformerConfig
    base = dict(vocab_size=256, max_len=64, use_flash=False, remat=False,
                dropout=0.0, dtype="float32")
    base.update(kw)
    jcfg = JT.bert_tiny(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def _batch(seed=1, B=2, L=32):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 256, (B, L)).astype(np.int32)
    labels = np.where(rng.rand(B, L) < 0.25, tokens, -100).astype(np.int32)
    return dict(tokens=tokens, labels=labels, mask=np.ones((B, L), bool))


def _run(tcfg, tree, batch, steps=2, **kw):
    from mxnet_tpu_torch.convert import to_numpy
    from mxnet_tpu_torch.models import transformer as T
    init_state, step = T.make_train_step(tcfg, **kw)
    state = init_state(params=to_port(tree))
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch, None)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_leaves(to_numpy(state[0]))


@pytest.mark.parametrize("moe", [False, True])
def test_train_step_on_a_one_device_mesh_is_the_plain_step(moe):
    """Two steps: ``mesh={"dp": 1}``, ``{"dp": 1, "tp": 1}`` and
    ``shard_optimizer=True`` without a live dp axis are the plain step
    bit for bit, and the reference's step over its own one-device mesh
    within the train limits."""
    import optax
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu.parallel import make_mesh as jmesh
    jcfg, tcfg = _bert(**(dict(n_experts=4, moe_every=2) if moe else {}))
    tree = numpy_params(jcfg, 0)
    batch = _batch()
    plain = _run(tcfg, tree, batch, device="cpu")
    for kw in (dict(mesh=_port_mesh({"dp": 1})),
               dict(mesh=_port_mesh({"dp": 1, "tp": 1}), device="cpu"),
               dict(device="cpu", shard_optimizer=True),
               dict(mesh=_port_mesh({"dp": 1}), shard_optimizer=True)):
        got = _run(tcfg, tree, batch, **kw)
        assert got[0] == plain[0], kw
        assert all(np.array_equal(a, b) for a, b in zip(got[1], plain[1]))
    mesh = jmesh({"dp": 1}, devices=jax.devices()[:1])
    _, jstep = JT.make_train_step(jcfg, mesh=mesh, shard_optimizer=True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = optax.adamw(1e-4, weight_decay=0.01, b1=0.9, b2=0.999, eps=1e-6)
    jstate = (params, tx.init(params))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(2):
        jstate, jl = jstep(jstate, jb, jax.random.PRNGKey(i))
        np.testing.assert_allclose(plain[0][i], float(jl), rtol=_TOL,
                                   atol=_TOL)
    for a, b in zip(plain[1], jax.tree_util.tree_leaves(
            jax.device_get(jstate[0]))):
        np.testing.assert_allclose(a, b, rtol=_TOL, atol=_P_ATOL)


def test_forward_and_attention_on_one_device_meshes():
    from mxnet_tpu_torch.models import transformer as T
    _, tcfg = _bert(n_experts=4, moe_every=2)
    params = T.init_params(0, tcfg, device="cpu")
    tokens = torch.from_numpy(_batch()["tokens"])
    want = T.forward_with_aux(params, tokens, tcfg)
    for shape in ({"dp": 1}, {"dp": 1, "sp": 1, "tp": 1, "pp": 1,
                              "ep": 1}):
        got = T.forward_with_aux(params, tokens, tcfg,
                                 mesh=_port_mesh(shape))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for shape in ({"dp": 2}, {"tp": 2}, {"ep": 2}):
        with pytest.raises(NotImplementedError):
            T.forward_with_aux(params, tokens, tcfg,
                               mesh=_port_mesh(shape, 2))
    x = torch.randn(1, 8, 4, 16, generator=torch.Generator().manual_seed(0))
    plain = T._attention(x, x * 0.5, x + 1, None, tcfg)
    for sp in ("ring", "ulysses"):
        cfg = dataclasses.replace(tcfg, seq_parallel=sp)
        assert torch.equal(T._attention(x, x * 0.5, x + 1, None, cfg), plain)
        assert torch.equal(T._attention(x, x * 0.5, x + 1, None, cfg,
                                        mesh=_port_mesh({"sp": 1})), plain)
        with pytest.raises(NotImplementedError):
            T._attention(x, x, x, None, cfg, mesh=_port_mesh({"sp": 2}, 2))


def _errors(jcall, tcall):
    """The reference's ``MXNetError`` message and the port's."""
    from mxnet_tpu.base import MXNetError as JError
    from mxnet_tpu_torch.base import MXNetError
    with pytest.raises(JError) as want:
        jcall()
    with pytest.raises(MXNetError) as got:
        tcall()
    return str(got.value), str(want.value)


@pytest.mark.parametrize("case", ["bad_value", "no_fsdp", "moe",
                                  "fsdp_no_mesh", "fsdp_dead_dp"])
def test_train_step_argument_errors_are_the_reference_s(case):
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu.parallel import make_mesh as jmesh
    from mxnet_tpu_torch.models import transformer as T
    moe = dict(n_experts=4, moe_every=2) if case == "moe" else {}
    jcfg, tcfg = _bert(**moe)
    kw = {"bad_value": (dict(bucket_overlap="bucketed"),) * 2,
          "no_fsdp": (dict(bucket_overlap=True),) * 2,
          "moe": (dict(bucket_overlap=True, fsdp=True),) * 2,
          "fsdp_no_mesh": (dict(fsdp=True),) * 2,
          "fsdp_dead_dp": (
              dict(fsdp=True, mesh=jmesh({"dp": 1},
                                         devices=jax.devices()[:1])),
              dict(fsdp=True, mesh=_port_mesh({"dp": 1})))}[case]
    got, want = _errors(lambda: JT.make_train_step(jcfg, **kw[0]),
                        lambda: T.make_train_step(tcfg, device="cpu",
                                                  **kw[1]))
    assert got == want


def test_pipeline_argument_errors_are_the_reference_s():
    """A live ``pp`` axis: the reference refuses a mixed dense/MoE
    stack and ``seq_parallel`` before its pipeline; the port raises the
    same errors before it refuses the axis (``NotImplementedError``)."""
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu.parallel import make_mesh as jmesh
    from mxnet_tpu_torch.models import transformer as T
    tokens = _batch()["tokens"][:, :8]
    for kw in (dict(n_experts=4, moe_every=2), dict(seq_parallel="ring")):
        jcfg, tcfg = _bert(**kw)
        jtree = JT.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = T.init_params(0, tcfg, device="cpu")
        got, want = _errors(
            lambda: JT.forward_with_aux(
                jtree, jnp.asarray(tokens), jcfg,
                mesh=jmesh({"pp": 2}, devices=jax.devices()[:2])),
            lambda: T.forward_with_aux(
                tparams, torch.from_numpy(tokens), tcfg,
                mesh=_port_mesh({"pp": 2}, 2)))
        assert got == want
    _, tcfg = _bert(n_experts=4, moe_every=1)
    with pytest.raises(NotImplementedError):
        T.forward_with_aux(T.init_params(0, tcfg, device="cpu"),
                           torch.from_numpy(tokens), tcfg,
                           mesh=_port_mesh({"pp": 2}, 2))


# ---------------------------------------------------------------- decode --
def test_quantize_decode_params_of_moe_params_bit_for_bit():
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu_torch.convert import to_numpy
    from mxnet_tpu_torch.models import gpt as G
    jcfg, _ = configs(n_experts=4, moe_every=2, n_layers=4)
    tree = numpy_params(jcfg, 5)
    want = jax.device_get(JG.quantize_decode_params(tree))
    got = to_numpy(G.quantize_decode_params(to_port(tree)))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    layers = got["layers"]
    assert isinstance(layers[1]["wq"], dict) and "w1" not in layers[1]
    assert layers[1]["moe"]["w1"].dtype == np.float32
    assert isinstance(layers[0]["w1"], dict)
