"""Port parity: the Mixture-of-Experts FFN (``mxnet_tpu_torch/parallel/
moe.py``) and the models that reach it, against the reference's, on the
CPU with the reference's weights carried over by ``convert.from_jax``.

* ``moe_ffn`` at (G, S, D) = (2, 16, 32), E 4, top-k 1 and 2, capacity
  factors 0.25, 1.25 and 2.0, gelu and relu, and at the per-token
  grouping (T, 1, D): y and the aux loss within 1e-6, the dropped rows
  (exact zeros) the same rows, and the gradients of ``sum(y * w) + aux``
  with respect to x and every MoE leaf within 1e-5.  The twins of
  tests/test_pipeline_moe.py's cases (shapes and aux range, one expert
  equal to the dense FFN, overflow dropping all but C rows), a planted
  tie between two experts' gates (the lower index wins in both), and
  the argument errors.
* A tiny BERT with MoE layers (``moe_every`` 2 and 1): ``init_params``'
  tree against the reference's, ``forward_with_aux`` and 3
  ``make_train_step`` steps (losses within 1e-5, parameters within
  5e-6, the limits of tests/test_torch_train.py), and
  ``moe_aux_weight=0``.
* A tiny MoE GPT at capacity factors 1.25 and 2.0: ``generate`` (float
  and int8 KV, float and w8 weights) and ``generate_speculative`` (ngram
  and self drafting) token-identical to the reference's; the port's
  ``ServingEngine`` token-identical to the reference's engine with
  chunked prefill, and with speculation, the prefix cache and overlap;
  an in-process ``ServingCluster`` of 2 replicas identical to one
  engine; the weights a disaggregated worker receives (host copies
  through the wire frames) keep every MoE leaf and serve the same
  tokens.

All f32 with dropout 0 and the dense attention (the reference's own MoE
tests run it so).  Tolerances: the port's combine sums a token's k
expert rows where the reference's einsum sums over every (expert,
slot), and torch's and XLA's CPU matmuls sum in different orders.

The ``cuda`` case runs ``moe_ffn`` at BERT-base width in bf16 on the
card against the plain f32 composition on the same inputs (no JAX
there: this file imports the reference only inside its CPU tests)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import (assert_no_leak, configs, cuda_device,  # noqa: F401
                         numpy_params, port_engine, quantized, ref_generate,
                         run_both, to_port)

_TOL = 1e-6
_G_TOL = 1e-5
_LOSS_TOL = 1e-5
_P_ATOL = 5e-6

G, S, D, FF, E = 2, 16, 32, 64, 4


def _moe_tree(seed, D=D, FF=FF, E=E):
    """The reference's ``init_moe_ffn`` as numpy, biases re-drawn and
    the router widened (gates far from uniform, so slots overflow)."""
    import jax
    from mxnet_tpu.parallel import init_moe_ffn
    tree = {k: np.array(v) for k, v in jax.device_get(
        init_moe_ffn(jax.random.PRNGKey(seed), D, FF, E)).items()}
    rng = np.random.RandomState(seed + 100)
    tree["router"] = (0.3 * rng.randn(D, E)).astype(np.float32)
    tree["b1"] = (0.05 * rng.randn(E, FF)).astype(np.float32)
    tree["b2"] = (0.05 * rng.randn(E, D)).astype(np.float32)
    return tree


def _both(x, tree, w, **kw):
    """(reference, port) of ``moe_ffn``: y, aux and the gradients of
    ``sum(y * w) + aux`` w.r.t. x and every leaf, as numpy."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe_ffn as jmoe
    from mxnet_tpu_torch.parallel import moe_ffn

    def jloss(x, p):
        y, aux = jmoe(x, p, **kw)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, ja)), jg = jax.jit(jax.value_and_grad(jloss, (0, 1),
                                                   has_aux=True))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in tree.items()})
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}
    y, aux = moe_ffn(tx, tp, **kw)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    want = (np.asarray(jy), float(ja), np.asarray(jg[0]),
            {k: np.asarray(v) for k, v in jg[1].items()})
    got = (y.detach().numpy(), float(aux.detach()), tx.grad.numpy(),
           {k: v.grad.numpy() for k, v in tp.items()})
    return want, got


def _check(want, got):
    (jy, ja, jgx, jgp), (y, a, gx, gp) = want, got
    np.testing.assert_allclose(y, jy, rtol=_TOL, atol=_TOL)
    assert abs(a - ja) <= _TOL * max(1.0, abs(ja)), (a, ja)
    np.testing.assert_array_equal(np.all(y == 0, -1), np.all(jy == 0, -1))
    np.testing.assert_allclose(gx, jgx, rtol=_G_TOL, atol=_G_TOL)
    for k in jgp:
        np.testing.assert_allclose(gp[k], jgp[k], rtol=_G_TOL, atol=_G_TOL,
                                   err_msg=k)


# ---------------------------------------------------------------- moe_ffn --
@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("cf", [0.25, 1.25, 2.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_reference(top_k, cf, activation):
    rng = np.random.RandomState(7)
    x = rng.randn(G, S, D).astype(np.float32)
    w = rng.randn(G, S, D).astype(np.float32)
    want, got = _both(x, _moe_tree(1), w, n_experts=E, top_k=top_k,
                      capacity_factor=cf, activation=activation)
    _check(want, got)
    if cf == 0.25:           # C = ceil(k * 16 * 0.25 / 4): slots drop
        assert np.all(got[0] == 0, -1).sum() > 0


def test_moe_ffn_per_token_groups_match_reference():
    """The serving step's and ``_decode_one``'s grouping: T tokens as
    T groups of one, C = 1, so no slot ever drops."""
    rng = np.random.RandomState(8)
    x = rng.randn(24, 1, D).astype(np.float32)
    w = rng.randn(24, 1, D).astype(np.float32)
    want, got = _both(x, _moe_tree(2), w, n_experts=E, top_k=2,
                      capacity_factor=1.25)
    _check(want, got)
    assert not np.any(np.all(got[0] == 0, -1))


def test_moe_ffn_shapes_and_aux():
    """Twin of tests/test_pipeline_moe.py: the port's own init, the
    shapes, and the aux loss of a near-uniform router in (0.5, E)."""
    from mxnet_tpu_torch.parallel import init_moe_ffn, moe_ffn
    p = init_moe_ffn(0, 8, 32, 4, device="cpu")
    x = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(1))
    y, aux = moe_ffn(x, p, n_experts=4, top_k=2)
    assert y.shape == (2, 16, 8) and aux.shape == ()
    assert 0.5 < float(aux) < 4.0


def test_init_moe_ffn_tree():
    """The reference's shapes and dtypes, biases zero, and one seed one
    tree."""
    import jax
    from mxnet_tpu.parallel import init_moe_ffn as jinit
    from mxnet_tpu_torch.parallel import init_moe_ffn
    want = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), 8, 16, 3,
                                        param_dtype="bfloat16"))
    got = init_moe_ffn(5, 8, 16, 3, "bfloat16", device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == \
        {k: (tuple(v.shape), "torch." + str(v.dtype))
         for k, v in want.items()}
    assert not got["b1"].any() and not got["b2"].any()
    again = init_moe_ffn(5, 8, 16, 3, "bfloat16", device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert float(got["w1"].float().std()) == pytest.approx(0.02, rel=0.2)


def test_moe_single_expert_matches_dense():
    """E = 1, top-1, capacity 2: every token goes to expert 0, so MoE is
    the dense FFN with its weights (tests/test_pipeline_moe.py)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.parallel import init_moe_ffn, moe_ffn
    p = init_moe_ffn(3, 6, 12, 1, device="cpu")
    p["b1"] += 0.05
    p["b2"] -= 0.05
    x = torch.randn(2, 8, 6, generator=torch.Generator().manual_seed(2))
    y, _ = moe_ffn(x, p, n_experts=1, top_k=1, capacity_factor=2.0)
    ref = F.gelu(x @ p["w1"][0] + p["b1"][0], approximate="tanh") \
        @ p["w2"][0] + p["b2"][0]
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def test_moe_capacity_drops_overflow():
    """Capacity 1 and every token on one expert: one token a group has
    output, the rest are exactly zero (tests/test_pipeline_moe.py)."""
    from mxnet_tpu_torch.parallel import init_moe_ffn, moe_ffn
    p = init_moe_ffn(4, 4, 8, 2, device="cpu")
    p["b2"] += 0.05
    p["router"] = torch.zeros(4, 2)
    p["router"][:, 0] = 100.0
    y, _ = moe_ffn(torch.ones(1, 8, 4), p, n_experts=2, top_k=1,
                   capacity_factor=0.25)
    assert int((y[0].abs().sum(-1) > 1e-6).sum()) == 1


def test_tied_gates_go_to_the_lower_expert():
    """Experts 1 and 2 get the same router column, so their gates tie
    exactly for every token: ``jax.lax.top_k`` and the port both put
    expert 1 first (slot 0) and expert 2 second."""
    from mxnet_tpu_torch.parallel.moe import route
    tree = _moe_tree(5)
    tree["router"][:, 2] = tree["router"][:, 1]
    tree["router"][:, 1:3] += 1.0        # the tied pair on top
    rng = np.random.RandomState(9)
    x = np.abs(rng.randn(G, S, D)).astype(np.float32)
    w = rng.randn(G, S, D).astype(np.float32)
    idx, _, _, _, _ = route(torch.from_numpy(x),
                            torch.from_numpy(tree["router"]), E, 2, 2.0)
    assert (idx[..., 0] == 1).all() and (idx[..., 1] == 2).all()
    want, got = _both(x, tree, w, n_experts=E, top_k=2, capacity_factor=2.0)
    _check(want, got)


def test_moe_ffn_argument_errors():
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import make_mesh, moe_ffn
    p = to_port(_moe_tree(6))
    x = torch.zeros(1, 4, D)
    with pytest.raises(MXNetError, match="top_k=5 > n_experts=4"):
        moe_ffn(x, p, n_experts=E, top_k=5)
    with pytest.raises(MXNetError, match="unknown activation"):
        moe_ffn(x, p, n_experts=E, activation="tanh")
    one = make_mesh({"ep": 1, "dp": 1}, devices=["cpu"])
    y, aux = moe_ffn(x + 1, p, n_experts=E, mesh=one)
    y0, aux0 = moe_ffn(x + 1, p, n_experts=E)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    for shape in ({"ep": 2}, {"dp": 2, "ep": 1}):
        live = make_mesh(shape, devices=["cpu", "cpu"])
        with pytest.raises(NotImplementedError):
            moe_ffn(x, p, n_experts=E, mesh=live)


# ------------------------------------------------------------- BERT (MoE) --
def _bert_cfgs(**kw):
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models.transformer import TransformerConfig
    base = dict(vocab_size=256, max_len=64, use_flash=False, remat=False,
                dropout=0.0, dtype="float32", n_experts=4)
    base.update(kw)
    jcfg = JT.bert_tiny(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def _bert_batch(B=2, L=32, seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 256, (B, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    mask[1, 24:] = False
    labels = np.where(rng.rand(B, L) < 0.25, tokens, -100).astype(np.int32)
    labels[1, 24:] = -100
    return dict(tokens=tokens, labels=labels, mask=mask)


def test_init_params_places_moe_layers_as_the_reference():
    import jax
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models import transformer as T
    for every in (1, 2, 3):
        jcfg, tcfg = _bert_cfgs(moe_every=every, n_layers=3)
        want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
        got = T.init_params(0, tcfg, device="cpu")
        shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == \
            shapes


@pytest.mark.parametrize("moe_every", [2, 1])
def test_forward_with_aux_matches(moe_every):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models import transformer as T
    jcfg, tcfg = _bert_cfgs(moe_every=moe_every)
    tree = numpy_params(jcfg, 2)
    b = _bert_batch(seed=3)
    jl, ja = jax.jit(lambda p, t, m: JT.forward_with_aux(p, t, jcfg,
                                                         mask=m))(
        tree, jnp.asarray(b["tokens"]), jnp.asarray(b["mask"]))
    tl, ta = T.forward_with_aux(to_port(tree), torch.from_numpy(b["tokens"]),
                                tcfg, mask=torch.from_numpy(b["mask"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=_LOSS_TOL,
                               atol=_LOSS_TOL)
    assert abs(float(ta) - float(ja)) <= _LOSS_TOL
    n_moe = 2 // moe_every
    assert 0.5 * n_moe < float(ta) < 4.0 * n_moe


@pytest.mark.parametrize("moe_every,aux_weight", [(2, 0.01), (1, 0.01),
                                                  (2, 0.0)])
def test_bert_moe_train_step_matches(moe_every, aux_weight):
    """Three AdamW steps from one tree: each loss, then every parameter
    (the experts' and the router's included)."""
    import jax
    import jax.numpy as jnp
    import optax
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.convert import to_numpy
    from mxnet_tpu_torch.models import transformer as T
    jcfg, tcfg = _bert_cfgs(moe_every=moe_every, moe_aux_weight=aux_weight)
    tree = numpy_params(jcfg, 0)
    batch = _bert_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = optax.adamw(1e-4, weight_decay=0.01, b1=0.9, b2=0.999, eps=1e-6)
    jstate = (params, tx.init(params))
    _, jstep = JT.make_train_step(jcfg)
    init_state, step = T.make_train_step(tcfg, device="cpu")
    state = init_state(params=to_port(tree))
    losses = []
    for i in range(3):
        jstate, jl = jstep(jstate, jb, jax.random.PRNGKey(i))
        state, tl = step(state, batch, None)
        np.testing.assert_allclose(float(tl), float(jl), rtol=_LOSS_TOL,
                                   atol=_LOSS_TOL)
        losses.append(float(tl))
    got = jax.tree_util.tree_leaves(to_numpy(state[0]))
    want = jax.tree_util.tree_leaves(jax.device_get(jstate[0]))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=_LOSS_TOL, atol=_P_ATOL)
    if aux_weight == 0.0:    # the MLM loss alone: aux no longer in it
        _, tcfg1 = _bert_cfgs(moe_every=moe_every)
        l1 = T.mlm_loss(to_port(tree), {k: torch.from_numpy(v)
                                        for k, v in batch.items()},
                        None, tcfg1)
        l0 = T.mlm_loss(to_port(tree), {k: torch.from_numpy(v)
                                        for k, v in batch.items()},
                        None, tcfg)
        assert float(l1) - float(l0) > 1e-4


# -------------------------------------------------------------- GPT (MoE) --
def _gpt(cf, seed=3, moe_every=2):
    jcfg, tcfg = configs(n_experts=4, moe_every=moe_every,
                         capacity_factor=cf)
    return jcfg, tcfg, numpy_params(jcfg, seed)


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_generate_moe_matches(cf):
    """Greedy ``generate``: float and w8 weights (the experts stay
    float), float and int8 KV; the prefill routes a prompt as one group,
    so at 1.25 slots drop in it."""
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree = _gpt(cf)
    rng = np.random.RandomState(0)
    combos = [(False, False), (True, True)]
    if cf == 1.25:
        combos += [(True, False), (False, True)]
    for w8, kv_int8 in combos:
        t = quantized(tree) if w8 else tree
        prompt = rng.randint(1, 100, 20)
        want = ref_generate(t, jcfg, prompt, 10, kv_int8=kv_int8)
        got = G.generate(to_port(t), tcfg, prompt[None], 10,
                         kv_int8=kv_int8, device="cpu")[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=str((w8, kv_int8)))


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_generate_speculative_moe_matches(cf):
    """``generate_speculative`` routes each sequence's K+1 verify block
    as one group: ngram drafting, and at 1.25 self drafting too
    (``draft_slice_params``, the first layer), token-identical to the
    reference's."""
    import jax.numpy as jnp
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree = _gpt(cf, moe_every=1)
    prompt = np.tile(np.random.RandomState(1).randint(1, 100, 5), 3)[None]
    for drafter in ("ngram", "self") if cf == 1.25 else ("ngram",):
        kw = dict(K=3, drafter=drafter)
        jkw, tkw = dict(kw), dict(kw)
        if drafter == "self":
            jkw["draft_params"], jkw["draft_cfg"] = \
                JG.draft_slice_params(tree, jcfg, n_layers=1)
            tkw["draft_params"], tkw["draft_cfg"] = \
                G.draft_slice_params(to_port(tree), tcfg, n_layers=1)
        want = np.asarray(JG.generate_speculative(
            tree, jcfg, jnp.asarray(prompt), 12, **jkw))
        got = G.generate_speculative(to_port(tree), tcfg, prompt, 12,
                                     device="cpu", **tkw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=drafter)


_ENGINE_CASES = [(5, 8), (3, 12), (9, 4), (14, 6), (2, 10), (11, 7)]


def _cases(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 90, P).astype(np.int32), N)
            for P, N in _ENGINE_CASES]


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_engine_moe_matches_the_reference_engine(cf):
    """Six requests on three slots with chunked prefill, through the
    reference's ``ServingEngine`` and the port's: the same tokens, the
    same schedule."""
    jcfg, tcfg, tree = _gpt(cf)
    ref, eng, rids = run_both(tree, jcfg, tcfg, _cases(), num_slots=3,
                              page_size=4, prefill_chunk=6)
    for rid in rids:
        assert list(eng.requests[rid].generated) == \
            list(ref.requests[rid].generated), rid
    assert ref.stats["steps"] == eng.stats["steps"]
    assert_no_leak(eng)


def test_engine_moe_options_match_the_reference_engine():
    """Speculation (K 2), the prefix cache and the overlapped schedule
    together, w8 weights."""
    jcfg, tcfg, tree = _gpt(1.25)
    tree = quantized(tree)
    shared = np.arange(3, 11, dtype=np.int32)
    cases = [(np.concatenate([shared, p]), n) for p, n in _cases(1)]
    ref, eng, rids = run_both(tree, jcfg, tcfg, cases, num_slots=3,
                              page_size=4, prefill_chunk=6, spec_K=2,
                              prefix_cache=True, overlap=True)
    for rid in rids:
        assert list(eng.requests[rid].generated) == \
            list(ref.requests[rid].generated), rid
    assert eng.stats["spec_drafted"] > 0
    assert eng.stats["prefix_hit_tokens"] > 0
    assert_no_leak(eng)


def test_cluster_moe_equals_one_engine():
    """Two in-process replicas on one prepared MoE tree: every output
    equals one engine's."""
    from mxnet_tpu_torch.serving import ServingCluster
    _, tcfg, tree = _gpt(1.25)
    cases = _cases(2)
    eng = port_engine(tree, tcfg, num_slots=2, page_size=4, prefill_chunk=6)
    rids = [eng.submit(p, n) for p, n in cases]
    want = eng.run()
    cl = ServingCluster(to_port(tree), tcfg, replicas=2, num_slots=2,
                        page_size=4, prefill_chunk=6, device="cpu")
    try:
        crids = [cl.submit(p, n) for p, n in cases]
        for r, c in zip(rids, crids):
            np.testing.assert_array_equal(cl.result(c, timeout=120),
                                          want[r])
        assert len({cl.requests[c].replica for c in crids}) == 2
        assert all("moe" in layer for layer in
                   cl.replicas[1].engine.params["layers"][1:2])
    finally:
        cl.close(timeout=60)


def test_shipped_moe_weights_serve_as_the_originals():
    """A disaggregated worker's weights: the router's host copies
    (``cluster._host_tree``) through the wire frames
    (``transport.tree_to_frames``/``frames_to_tree``) keep every MoE
    leaf, and an engine built on them serves the same tokens."""
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.serving.cluster import _host_tree
    from mxnet_tpu_torch.serving.transport import (frames_to_tree,
                                                   tree_to_frames)
    _, tcfg, tree = _gpt(1.25)
    prepared = G.prepare_params(to_port(tree), tcfg, "cpu")
    meta, bufs = tree_to_frames(_host_tree(prepared))
    shipped = frames_to_tree(meta, [bytes(b) for b in bufs])
    moe = prepared["layers"][1]["moe"]
    assert set(shipped["layers"][1]["moe"]) == set(moe)
    assert all(torch.equal(shipped["layers"][1]["moe"][k], v)
               for k, v in moe.items())
    outs = []
    for params in (prepared, shipped):
        eng = ServingEngine(params, tcfg, num_slots=2, page_size=4,
                            prefill_chunk=6, device="cpu")
        rids = [eng.submit(p, n) for p, n in _cases(3)]
        res = eng.run()
        outs.append([list(res[r]) for r in rids])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------- the card --
@pytest.mark.cuda
def test_moe_ffn_bf16_on_card_against_plain_f32(cuda_device):
    """``moe_ffn`` at BERT-base width (a 16 x 512 batch, E 4, top-2,
    capacity 1.25) in bf16 on the card against the f32 composition on
    the same inputs: the same dispatch (routing runs in f32 on the same
    x), y within ``chip_smoke.moe_limit`` and the relative RMS error
    within ``chip_smoke.MOE_RMS``."""
    from chip_smoke import MOE_RMS, moe_case
    dev = cuda_device
    err, over, rms, same, _ = moe_case(dev, seed=0)
    assert same, "dispatch indices differ"
    assert over <= 1.0 and rms <= MOE_RMS, (err, over, rms)
