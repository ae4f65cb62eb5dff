"""Port parity: the training path of ``mxnet_tpu_torch.models`` against
``mxnet_tpu.models`` — ``_attention`` (flash and dense, with dropout),
``forward``, ``mlm_loss``, the BERT ``make_train_step`` over 3 steps and
the GPT one over 2 — on one numpy parameter tree (the reference init
with re-drawn biases and layer norms), f32 compute, the reference's
Pallas flash kernels in interpreter mode.  d_model 128 with 2 heads
gives dh 64, a head width the reference's flash kernels take.

Tolerances, each from what differs (torch's and XLA's CPU kernels sum
in different orders):
* outputs, logits and losses 1e-5;
* gradients 1e-6 absolute + 1e-4 relative: a leaf whose gradient is
  zero in exact arithmetic (the key bias: softmax ignores a constant
  shift of the scores) holds only rounding noise of ~1e-8;
* parameters after the steps 5e-6 absolute: AdamW moves a leaf by
  about lr = 1e-4 a step, and by lr*g/eps (~1e-6) on such noise.
The hidden dropouts draw from different generators by design, so the
train-step comparisons run with dropout 0; the attention dropout, given
the same seed, is the reference's bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx  # noqa: F401  (conftest device setup)
from _torch_port import numpy_params, to_port

_TOL = 1e-5
_G_ATOL, _G_RTOL = 1e-6, 1e-4
_P_ATOL = 5e-6


@pytest.fixture(autouse=True)
def _interpret():
    from mxnet_tpu.kernels import flash_attention as JFA
    old = JFA._INTERPRET
    JFA._INTERPRET = True
    yield
    JFA._INTERPRET = old


def _cfgs(gpt=False, **kw):
    """(JAX config, port config): BERT-tiny (or GPT-tiny) widened to
    dh 64, f32, dropout 0, no remat, flash on, T <= 128."""
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models.transformer import TransformerConfig
    base = dict(d_model=128, n_heads=2, d_ff=256, vocab_size=256,
                max_len=128, dtype="float32", dropout=0.0, remat=False,
                use_flash=True)
    base.update(kw)
    jcfg = (JG.gpt_tiny if gpt else JT.bert_tiny)(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def _batch(B=2, L=128, vocab=256, seed=1):
    """tokens, 15% labels, a padded tail on row 1, two segments."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    mask[1, 100:] = False
    labels = np.where(rng.rand(B, L) < 0.15, tokens, -100).astype(np.int32)
    labels[1, 100:] = -100
    type_ids = np.repeat((np.arange(L) >= L // 2)[None], B, 0) \
        .astype(np.int32)
    return dict(tokens=tokens, labels=labels, mask=mask, type_ids=type_ids)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_state(tree, lr=1e-4, wd=0.01):
    """The reference step's state for ``tree``: exactly what its
    ``init_state`` builds, ``(params, tx.init(params))``."""
    import optax
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = optax.adamw(lr, weight_decay=wd, b1=0.9, b2=0.999, eps=1e-6)
    return params, tx.init(params)


def _close_trees(got, want, atol, rtol):
    got = jax.tree_util.tree_leaves(got)
    want = jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_with_seed_matches(use_flash, causal):
    """The port's ``_attention`` given the seed that the reference
    draws from its ``dropout_key``: output and q/k/v gradients."""
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models import transformer as T
    jcfg, tcfg = _cfgs(dropout=0.2, use_flash=use_flash, causal=causal)
    rng = np.random.RandomState(5)
    q, k, v, g = (rng.randn(2, 128, 2, 64).astype(np.float32)
                  for _ in range(4))
    mask = np.asarray(_batch()["mask"])
    key = jax.random.PRNGKey(7)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1, jnp.int32))

    def jloss(q, k, v):
        out = JT._attention(q, k, v, jnp.asarray(mask), jcfg,
                            dropout_key=key)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = T._attention(tq, tk, tv, torch.from_numpy(mask), tcfg,
                       dropout_seed=torch.tensor([seed], dtype=torch.int32))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=_TOL, atol=_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=_G_RTOL, atol=_G_ATOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_and_mlm_loss_match(use_flash):
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.models import transformer as T
    jcfg, tcfg = _cfgs(use_flash=use_flash)
    tree = numpy_params(jcfg, 2)
    batch = _batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = JT.forward(tree, jb["tokens"], jcfg, type_ids=jb["type_ids"],
                      mask=jb["mask"])
    params, tb = to_port(tree), _tensors(batch)
    got = T.forward(params, tb["tokens"], tcfg, type_ids=tb["type_ids"],
                    mask=tb["mask"])
    assert got.dtype == torch.float32 and got.shape == (2, 128, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_TOL,
                               atol=_TOL)
    jl = JT.mlm_loss(tree, jb, jax.random.PRNGKey(0), jcfg)
    tl = T.mlm_loss(params, tb, None, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=_TOL, atol=_TOL)
    x = np.random.RandomState(4).randn(2, 128, 128).astype(np.float32)
    jh = JT._mlm_head_loss(tree, jnp.asarray(x), jb, jcfg)
    th = T._mlm_head_loss(params, torch.from_numpy(x), tb, tcfg)
    np.testing.assert_allclose(float(th), float(jh), rtol=_TOL, atol=_TOL)


def test_bert_train_step_matches():
    """Three steps from one tree: each step's loss, step 1's gradient
    of every leaf, and every parameter after step 3."""
    from mxnet_tpu.models import transformer as JT
    from mxnet_tpu_torch.convert import to_numpy, tree_map
    from mxnet_tpu_torch.models import transformer as T
    jcfg, tcfg = _cfgs()
    tree = numpy_params(jcfg, 0)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = _jax_state(tree)
    jgrads = jax.grad(lambda p: JT.mlm_loss(p, jb, jax.random.PRNGKey(0),
                                            jcfg))(jstate[0])
    _, jstep = JT.make_train_step(jcfg)
    init_state, step = T.make_train_step(tcfg, device="cpu")
    state = init_state(params=to_port(tree))
    for i in range(3):
        jstate, jl = jstep(jstate, jb, jax.random.PRNGKey(i))
        state, tl = step(state, batch, None)
        np.testing.assert_allclose(float(tl), float(jl), rtol=_TOL,
                                   atol=_TOL)
        if i == 0:
            grads = to_numpy(tree_map(lambda p: p.grad, state[0]))
            _close_trees(grads, jgrads, _G_ATOL, _G_RTOL)
    _close_trees(to_numpy(state[0]), jstate[0], _P_ATOL, _TOL)


def test_gpt_train_step_matches():
    """Two causal-LM steps (labels shifted left, padded positions
    ignored) from one tree: losses and parameters."""
    from mxnet_tpu.models import gpt as JG
    from mxnet_tpu_torch.convert import to_numpy
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg = _cfgs(gpt=True)
    tree = numpy_params(jcfg, 4)
    batch = _batch(seed=5)
    batch = {"tokens": batch["tokens"], "mask": batch["mask"]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate = _jax_state(tree)
    _, jstep = JG.make_train_step(jcfg)
    init_state, step = G.make_train_step(tcfg, device="cpu")
    state = init_state(params=to_port(tree))
    for i in range(2):
        jstate, jl = jstep(jstate, jb, jax.random.PRNGKey(i))
        state, tl = step(state, batch, None)
        np.testing.assert_allclose(float(tl), float(jl), rtol=_TOL,
                                   atol=_TOL)
    _close_trees(to_numpy(state[0]), jstate[0], _P_ATOL, _TOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_remat_equals_no_remat(use_flash):
    """One training step with dropout 0.1 from one state and one
    generator seed, with and without per-layer checkpointing: the
    recompute sees the same pre-drawn dropout, so the loss and every
    gradient agree (identical CPU ops on identical inputs; 1e-6 covers
    nothing but the recompute's own rounding)."""
    from mxnet_tpu_torch.convert import tree_leaves
    from mxnet_tpu_torch.models import transformer as T
    _, tcfg = _cfgs(dropout=0.1, use_flash=use_flash)
    batch = _batch(seed=6)
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        init_state, step = T.make_train_step(cfg, device="cpu")
        state = init_state(seed=3)
        state, loss = step(state, batch, torch.Generator().manual_seed(9))
        runs.append((float(loss), [p.grad.clone() for p in
                                   tree_leaves(state[0])]))
    (l0, g0), (l1, g1) = runs
    assert np.isfinite(l0)
    np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_dropout_draws_follow_the_generator():
    """Training with dropout draws only from the generator it is given:
    the same seed gives the same loss, another seed another loss."""
    from mxnet_tpu_torch.models import transformer as T
    _, tcfg = _cfgs(dropout=0.1)
    params = T.init_params(0, tcfg, device="cpu")
    tb = _tensors(_batch(seed=8))

    def loss(seed):
        return float(T.mlm_loss(params, tb,
                                torch.Generator().manual_seed(seed), tcfg))

    assert loss(1) == loss(1) != loss(2)
    with pytest.raises(ValueError, match="Generator"):
        T.mlm_loss(params, tb, None, tcfg)


def test_unported_options_raise():
    from mxnet_tpu_torch.models import transformer as T
    _, tcfg = _cfgs()
    for kw in (dict(fsdp=True), dict(shard_optimizer=True),
               dict(bucket_overlap=True), dict(scan_steps=4),
               dict(mesh=object())):
        with pytest.raises(NotImplementedError):
            T.make_train_step(tcfg, device="cpu", **kw)
    x = torch.zeros(1, 4, 2, 64)
    with pytest.raises(NotImplementedError):
        T._attention(x, x, x, None,
                     dataclasses.replace(tcfg, seq_parallel="ring"))
    with pytest.raises(NotImplementedError):
        T.forward(T.init_params(0, tcfg, device="cpu"),
                  torch.zeros(1, 4, dtype=torch.long),
                  dataclasses.replace(tcfg, remat=True, remat_policy="dots"))
