"""Port parity: ``make_train_step``'s one-card options in
``mxnet_tpu_torch.models`` against ``mxnet_tpu.models`` —
``remat_policy="dots"`` (the reference's ``dots_saveable``) and
``scan_steps``/``scan_superbatch`` (the reference's ``lax.scan`` of K
steps) — on the CPU, with the reference's Pallas flash kernels in
interpreter mode.

Tolerances, each from what differs:
* the port against itself (``"dots"`` against no remat, one step with
  dropout 0.1 from one state and generator seed): loss 1e-6 and
  gradients 1e-6 relative + 1e-7 absolute, as
  ``test_torch_train.py::test_remat_equals_no_remat`` (identical CPU
  ops on identical inputs; the saved matmuls and the recompute only
  move rounding);
* the port against the reference (dropout 0, f32): losses 1e-5 and
  parameters 5e-6 absolute, ``test_torch_train.py``'s limits (torch's
  and XLA's CPU kernels sum in different orders);
* a scanned call against single calls: bit for bit, under
  ``torch.use_deterministic_algorithms`` (the CPU's threaded embedding
  backward otherwise adds in a varying order).

The ``cuda`` case (skipped without a card) holds the scanned graph
against single captured calls bit for bit; the captured ``"dots"``
step is a case of ``test_torch_compiled_steps.py``'s
``test_train_steps_captured_equal_eager``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import cuda_device, numpy_params, to_port  # noqa: F401

_TOL = 1e-5
_P_ATOL = 5e-6
K = 3


@pytest.fixture
def _interpret():
    from mxnet_tpu.kernels import flash_attention as JFA
    old = JFA._INTERPRET
    JFA._INTERPRET = True
    yield
    JFA._INTERPRET = old


@pytest.fixture
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _cfgs(gpt=False, **kw):
    """(JAX config, port config): BERT-tiny or GPT-tiny at dh 64, f32,
    flash on, T <= 128."""
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models.transformer import TransformerConfig
    base = dict(d_model=128, n_heads=2, d_ff=256, vocab_size=256,
                max_len=128, dtype="float32", dropout=0.0, remat=False,
                use_flash=True)
    base.update(kw)
    jcfg = (JG.gpt_tiny if gpt else JT.bert_tiny)(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def _batch(seed, B=2, L=128, lead=()):
    """tokens, 15% labels, a padded tail on row 1 (with a leading
    ``lead`` axis for a superbatch)."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 256, lead + (B, L)).astype(np.int32)
    mask = np.ones(lead + (B, L), bool)
    mask[..., 1, 100:] = False
    labels = np.where(rng.rand(*lead, B, L) < 0.15, tokens, -100) \
        .astype(np.int32)
    labels[..., 1, 100:] = -100
    return dict(tokens=tokens, labels=labels, mask=mask)


def _jax_state(tree):
    import jax
    import jax.numpy as jnp
    import optax
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = optax.adamw(1e-4, weight_decay=0.01, b1=0.9, b2=0.999, eps=1e-6)
    return params, tx.init(params)


def _close_params(got, want):
    import jax
    from mxnet_tpu_torch.convert import to_numpy
    got = jax.tree_util.tree_leaves(to_numpy(got))
    want = jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=_TOL,
                                   atol=_P_ATOL)


def _flash_forwards(monkeypatch):
    """A count of the flash forward's calls (its plain version on the
    CPU)."""
    from mxnet_tpu_torch.kernels import flash_attention as FA
    calls = {"n": 0}
    plain = FA.flash_fwd_reference

    def counted(*a, **kw):
        calls["n"] += 1
        return plain(*a, **kw)
    monkeypatch.setattr(FA, "flash_fwd_reference", counted)
    return calls


def _mm_in_backward(cfg, batch):
    """How many matmuls one step's backward runs (recomputed forward
    matmuls included)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from mxnet_tpu_torch.models import transformer as T
    dots = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func in dots
            return func(*args, **(kwargs or {}))

    from mxnet_tpu_torch.convert import tree_map
    params = tree_map(lambda t: t.requires_grad_(),
                      T.init_params(3, cfg, device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = T.mlm_loss(params, tb, torch.Generator().manual_seed(1), cfg)
    with Count():
        loss.backward()
    return Count.n


@pytest.mark.parametrize("use_flash", [True, False])
def test_dots_equals_no_remat(use_flash, monkeypatch):
    """One step with dropout 0.1 from one state and generator seed,
    under ``"dots"`` and without remat: the same loss and gradients.
    The flash forward runs twice a layer under ``"dots"`` (the
    reference's jaxpr of the ``"dots"`` gradient holds 4 ``pallas_call``
    a layer, as under ``"nothing"``: the forward is recomputed), once
    without remat."""
    from mxnet_tpu_torch.convert import tree_leaves
    from mxnet_tpu_torch.models import transformer as T
    _, tcfg = _cfgs(dropout=0.1, use_flash=use_flash)
    batch = _batch(6)
    calls = _flash_forwards(monkeypatch)
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy="dots")
        init_state, step = T.make_train_step(cfg, device="cpu")
        state = init_state(seed=3)
        calls["n"] = 0
        state, loss = step(state, batch, torch.Generator().manual_seed(9))
        runs.append((float(loss), [p.grad.clone() for p in
                                   tree_leaves(state[0])], calls["n"]))
    (l0, g0, n0), (l1, g1, n1) = runs
    assert np.isfinite(l0)
    np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    if use_flash:
        assert (n0, n1) == (tcfg.n_layers, 2 * tcfg.n_layers)


def test_dots_saves_the_matmuls():
    """The backward under ``"dots"`` runs no forward matmul again: as
    many matmuls as without remat, where ``"nothing"`` runs the
    layers' forward matmuls once more (8 a layer: q, k, v, o, the two
    FFN products and, on the dense attention path, the scores and the
    probabilities times v)."""
    _, tcfg = _cfgs(dropout=0.1, use_flash=False)
    batch = {k: v for k, v in _batch(2).items()}
    n = {pol: _mm_in_backward(dataclasses.replace(
        tcfg, remat=pol is not None, remat_policy=pol or "nothing"), batch)
        for pol in (None, "dots", "nothing")}
    assert n["dots"] == n[None]
    assert n["nothing"] == n[None] + 8 * tcfg.n_layers


@pytest.mark.parametrize("gpt,use_flash", [(False, True), (False, False),
                                           (True, True)],
                         ids=["bert-flash", "bert-dense", "gpt-flash"])
def test_dots_matches_reference(_interpret, gpt, use_flash):
    """Two ``"dots"`` steps from one tree against the reference's
    ``"dots"`` steps (dropout 0): each loss and every parameter after
    them."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.models import transformer as T
    jcfg, tcfg = _cfgs(gpt=gpt, use_flash=use_flash, remat=True,
                       remat_policy="dots")
    tree = numpy_params(jcfg, 4)
    batch = _batch(5)
    if gpt:
        batch = {"tokens": batch["tokens"], "mask": batch["mask"]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = _jax_state(tree)
    _, jstep = (JG if gpt else JT).make_train_step(jcfg)
    init_state, step = (G if gpt else T).make_train_step(tcfg, device="cpu")
    state = init_state(params=to_port(tree))
    for i in range(2):
        jstate, jl = jstep(jstate, jb, jax.random.PRNGKey(i))
        state, tl = step(state, batch, None)
        np.testing.assert_allclose(float(tl), float(jl), rtol=_TOL,
                                   atol=_TOL)
    _close_params(state[0], jstate[0])


@pytest.mark.parametrize("superbatch", [False, True])
def test_scan_equals_single_calls(_deterministic, superbatch):
    """One ``scan_steps=3`` call against 3 single calls from one state
    and one generator seed, dropout 0.1: losses, parameters, AdamW
    state, the last step's gradients and the generator's state bit for
    bit; with ``scan_superbatch`` step i takes slice i."""
    from mxnet_tpu_torch.convert import tree_leaves
    from mxnet_tpu_torch.models import transformer as T
    _, tcfg = _cfgs(dropout=0.1)
    batch = _batch(7, lead=(K,) if superbatch else ())
    runs = []
    for scan in (None, K):
        init_state, step = T.make_train_step(
            tcfg, device="cpu", scan_steps=scan, scan_superbatch=superbatch)
        state = init_state(seed=3)
        gen = torch.Generator().manual_seed(9)
        if scan is None:
            losses = torch.stack([step(state, {k: v[i] for k, v in
                                               batch.items()}
                                       if superbatch else batch, gen)[1]
                                  for i in range(K)])
        else:
            state, losses = step(state, batch, gen)
        leaves = tree_leaves(state[0])
        runs.append((losses, [p.detach().clone() for p in leaves],
                     [p.grad.clone() for p in leaves],
                     [v.clone() for p in leaves
                      for v in state[1].state[p].values()],
                     gen.get_state()))
    (l0, p0, g0, s0, r0), (l1, p1, g1, s1, r1) = runs
    assert l1.shape == (K,) and torch.equal(l0, l1)
    assert len(np.unique(l1.numpy())) == K
    for a, b in zip(p0 + g0 + s0, p1 + g1 + s1):
        assert torch.equal(a, b)
    assert torch.equal(r0, r1)


def test_scan_superbatch_checks_the_leading_axis():
    from mxnet_tpu_torch.models import transformer as T
    _, tcfg = _cfgs()
    init_state, step = T.make_train_step(tcfg, device="cpu", scan_steps=K,
                                         scan_superbatch=True)
    with pytest.raises(ValueError, match="leading axis"):
        step(init_state(seed=0), _batch(1, lead=(K + 1,)), None)
    for bad in (0, -2, 1.5, True):
        with pytest.raises(ValueError, match="scan_steps"):
            T.make_train_step(tcfg, device="cpu", scan_steps=bad)


@pytest.mark.parametrize("superbatch", [False, True])
def test_scan_matches_reference(_interpret, superbatch):
    """The port's (K,) losses and parameters after one scanned call
    against the reference's ``scan_steps=3`` call (dropout 0)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models import transformer as T
    jcfg, tcfg = _cfgs()
    tree = numpy_params(jcfg, 2)
    batch = _batch(3, lead=(K,) if superbatch else ())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jstep = JT.make_train_step(jcfg, scan_steps=K,
                                  scan_superbatch=superbatch)
    jstate, jl = jstep(_jax_state(tree), jb, jax.random.PRNGKey(0))
    init_state, step = T.make_train_step(tcfg, device="cpu", scan_steps=K,
                                         scan_superbatch=superbatch)
    state, tl = step(init_state(params=to_port(tree)), batch, None)
    assert tuple(tl.shape) == tuple(jl.shape) == (K,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=_TOL,
                               atol=_TOL)
    _close_params(state[0], jstate[0])


@pytest.mark.cuda
@pytest.mark.parametrize("superbatch", [False, True])
def test_scanned_graph_equals_single_calls(cuda_device, superbatch):
    """On the card (bf16, dropout 0.1, flash kernels): two scanned
    calls of 3 steps, one graph replayed, against 6 single captured
    calls from one seed: losses, parameters, AdamW state and the
    generator's state bit for bit; each flash kernel counted once a
    layer a step."""
    from mxnet_tpu_torch.convert import tree_leaves
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.models import transformer as T
    cfg = T.bert_tiny(d_model=128, n_heads=2, d_ff=256, vocab_size=256,
                      max_len=128, dropout=0.1, remat=False)
    rng = np.random.RandomState(4)
    lead = (K,) if superbatch else ()
    tokens = rng.randint(1, 256, lead + (2, 64))
    batch = {"tokens": tokens,
             "labels": np.where(rng.rand(*tokens.shape) < 0.2, tokens,
                                -100)}
    runs = []
    for scan in (None, K):
        init_state, step = T.make_train_step(
            cfg, device=cuda_device, scan_steps=scan,
            scan_superbatch=superbatch)
        state = init_state(seed=2)
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            getattr(FA, k).launches = 0
        if scan is None:
            losses = [step(state, {k: v[i] for k, v in batch.items()}
                           if superbatch else batch, gen)[1]
                      for _ in range(2) for i in range(K)]
            losses = torch.stack(losses)
        else:
            losses = torch.cat([step(state, batch, gen)[1]
                                for _ in range(2)])
            assert len(step._graphs) == 1
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert getattr(FA, k).launches == 2 * K * cfg.n_layers, k
        leaves = tree_leaves(state[0])
        runs.append((losses.cpu(), [p.detach().cpu() for p in leaves],
                     [v.cpu() for p in leaves
                      for v in state[1].state[p].values()],
                     gen.get_state()))
    (l0, p0, s0, r0), (l1, p1, s1, r1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(p0 + s0, p1 + s1):
        assert torch.equal(a, b)
    assert torch.equal(r0, r1)
