"""BERT-style encoder and the transformer core shared by the GPT model:
config, parameter init, layer norm, the forward pass, the masked-LM
loss and the single-device train step.  Port of
``mxnet_tpu/models/transformer.py``.

The parameter tree has the reference's structure and shapes exactly
(a dict of tensors, ``layers`` a list of per-layer dicts), so a tree
converted from the JAX package (``convert.from_jax``) and one drawn
here are interchangeable.  The draws differ: JAX's random streams
cannot be reproduced in torch, so parity tests convert the JAX tree.

Attention goes through ``kernels/flash_attention.py`` (the flash
forward and backward kernels on the card) when ``cfg.use_flash``, and
through the reference's dense path otherwise.  The reference's mesh
paths (tp/dp/sp sharding, ring/Ulysses attention, the GPipe ``pp``
stack, FSDP, ZeRO-1, bucketed overlap, scanned steps) and MoE layers
are not ported; they raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import types
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .._graphs import GraphCache, Program, warm_up
from ..convert import tree_leaves, tree_map
from ..kernels.flash_attention import dense_keep_mask, flash_attention

__all__ = ["TransformerConfig", "init_params", "forward",
           "forward_with_aux", "mlm_loss", "make_train_step", "bert_base",
           "bert_tiny"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Field-for-field copy of the reference ``TransformerConfig``.
    Fields that only the JAX training/mesh paths read (remat, fast_rng,
    seq_parallel, pp/ep, ...) are kept so configs convert one to one."""
    vocab_size: int = 30522
    max_len: int = 512
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    dropout: float = 0.1
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_flash: bool = True
    remat: bool = True
    remat_policy: str = "nothing"
    fast_rng: bool = True
    type_vocab_size: int = 2
    seq_parallel: Optional[str] = None
    n_experts: int = 0
    moe_every: int = 2
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    pp_microbatches: int = 2
    causal: bool = False


def bert_base(**kw):
    return TransformerConfig(**kw)


def bert_tiny(**kw):
    base = dict(vocab_size=1024, max_len=128, d_model=64, n_heads=4,
                n_layers=2, d_ff=128)
    base.update(kw)
    return TransformerConfig(**base)


def torch_dtype(name):
    """``torch.dtype`` for a config dtype string ("bfloat16", ...)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError("unknown dtype %r" % (name,))
    return dt


def init_params(seed, cfg: TransformerConfig, *, device=None):
    """Random parameters with the reference tree and shapes: weights
    ``N(0, 0.02)``, biases 0, layer-norm gains 1.  Drawn on the CPU
    from a ``torch.Generator`` seeded with ``seed`` (so a seed gives
    the same tree on every device), then moved to ``device``."""
    if cfg.n_experts:
        raise NotImplementedError("mxnet_tpu_torch: MoE layers are not "
                                  "ported yet")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    pdt = torch_dtype(cfg.param_dtype)
    D, F = cfg.d_model, cfg.d_ff

    def dense(*shape):
        return (torch.randn(*shape, generator=gen) * 0.02).to(dev, pdt)

    def zeros(n):
        return torch.zeros(n, dtype=pdt, device=dev)

    def ln():
        return {"g": torch.ones(D, dtype=pdt, device=dev), "b": zeros(D)}

    params = {
        "tok_emb": dense(cfg.vocab_size, D),
        "pos_emb": dense(cfg.max_len, D),
        "type_emb": dense(cfg.type_vocab_size, D),
        "emb_ln": ln(),
        "mlm_dense": dense(D, D),
        "mlm_ln": ln(),
        "mlm_bias": zeros(cfg.vocab_size),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": dense(D, D), "wk": dense(D, D), "wv": dense(D, D),
            "wo": dense(D, D),
            "bq": zeros(D), "bk": zeros(D), "bv": zeros(D), "bo": zeros(D),
            "ln1": ln(), "ln2": ln(),
            "w1": dense(D, F), "b1": zeros(F),
            "w2": dense(F, D), "b2": zeros(D),
        })
    return params


def _layer_norm(x, g, b, eps=1e-12):
    """Reference ``_layer_norm``: population variance, eps 1e-12, all
    arithmetic in ``x``'s dtype."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


# ---------------------------------------------------------------- forward --
def _not_ported(what):
    raise NotImplementedError("mxnet_tpu_torch: %s is not ported yet" % what)


def _attention(q, k, v, mask, cfg: TransformerConfig, mesh=None,
               dropout_seed=None):
    """(B, T, H, dh) attention: the reference ``_attention`` without its
    sequence-parallel branch.  With ``cfg.use_flash`` the flash kernels
    (dropout fused into them); otherwise the dense path (-1e9 masking,
    f32 softmax cast to q's dtype, ``dense_keep_mask``).

    ``dropout_seed`` non-None (an int32 tensor of one element, or an
    int) enables attention-probability dropout at ``cfg.dropout``.  It
    is the seed the reference draws from its ``dropout_key`` with
    ``jax.random.randint(key, (), 0, 2**31 - 1)``.  Kernel errors
    raise: nothing falls back to the dense path."""
    if dropout_seed is not None and not 0.0 <= float(cfg.dropout) < 1.0:
        raise ValueError("attention dropout must be in [0, 1), got %r"
                         % (cfg.dropout,))
    if mesh is not None or cfg.seq_parallel:
        _not_ported("sequence-parallel (mesh) attention")
    drop = dropout_seed is not None and cfg.dropout > 0
    if cfg.use_flash:
        return flash_attention(q, k, v, mask=mask, causal=cfg.causal,
                               dropout=cfg.dropout if drop else 0.0,
                               dropout_seed=dropout_seed if drop else None)
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if mask is not None:
        logits = logits.masked_fill(~mask.to(torch.bool)[:, None, None, :],
                                    -1e9)
    B, T, H, _ = q.shape
    if cfg.causal:
        tri = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tri, -1e9)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if drop:
        keep = dense_keep_mask(B, H, T, dropout_seed, cfg.dropout, q.device)
        probs = torch.where(keep, probs / (1 - cfg.dropout), 0).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _layer_draws(cfg: TransformerConfig, B, T, generator, device):
    """One layer's training randomness from ``generator``: the attention
    dropout seed (int32, drawn on ``device`` so it costs no host sync)
    and the keep masks of the two hidden dropouts."""
    def keep():
        return torch.empty(B, T, cfg.d_model, device=device).bernoulli_(
            1 - cfg.dropout, generator=generator).bool()

    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)
    return {"attn_seed": seed, "attn_keep": keep(), "ffn_keep": keep()}


def _encoder_layer(x, layer, mask, cfg: TransformerConfig, train,
                   draws=None):
    """One post-LN encoder layer, the reference ``_encoder_layer`` with
    a dense FFN.  ``draws`` (from :func:`_layer_draws`) carries the
    layer's randomness when training with dropout; it is drawn outside
    so that a remat recompute drops the same units as the forward."""
    if "moe" in layer:
        _not_ported("MoE layers")
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    cdt = x.dtype
    r = cfg.dropout
    drop = train and r > 0

    def dn(w):
        return w.to(cdt)

    q = (x @ dn(layer["wq"]) + dn(layer["bq"])).reshape(B, T, H, dh)
    k = (x @ dn(layer["wk"]) + dn(layer["bk"])).reshape(B, T, H, dh)
    v = (x @ dn(layer["wv"]) + dn(layer["bv"])).reshape(B, T, H, dh)
    attn = _attention(q, k, v, mask, cfg,
                      dropout_seed=draws["attn_seed"] if drop else None)
    attn = attn.reshape(B, T, D) @ dn(layer["wo"]) + dn(layer["bo"])
    if drop:
        attn = torch.where(draws["attn_keep"], attn / (1 - r), 0).to(cdt)
    x = _layer_norm(x + attn, dn(layer["ln1"]["g"]), dn(layer["ln1"]["b"]))
    h = F.gelu(x @ dn(layer["w1"]) + dn(layer["b1"]), approximate="tanh")
    h = h @ dn(layer["w2"]) + dn(layer["b2"])
    if drop:
        h = torch.where(draws["ffn_keep"], h / (1 - r), 0).to(cdt)
    return _layer_norm(x + h, dn(layer["ln2"]["g"]), dn(layer["ln2"]["b"]))


def _make_layer_fn(cfg: TransformerConfig):
    """The encoder layer, wrapped in ``torch.utils.checkpoint`` when
    ``cfg.remat`` (the reference's ``jax.checkpoint`` with the
    "nothing" policy: only the layer's input is kept, the rest is
    recomputed in the backward)."""
    if not cfg.remat:
        return _encoder_layer
    if cfg.remat_policy == "dots":
        _not_ported("remat_policy='dots'")
    if cfg.remat_policy != "nothing":
        raise ValueError("remat_policy must be 'nothing' or 'dots', got %r"
                         % (cfg.remat_policy,))

    def layer_fn(x, layer, mask, cfg, train, draws=None):
        # all randomness is in `draws`, so no RNG state needs restoring
        return checkpoint(_encoder_layer, x, layer, mask, cfg, train, draws,
                          use_reentrant=False, preserve_rng_state=False)
    return layer_fn


def _mlm_head(outer, x):
    """gelu(mlm_dense) -> LN -> logits tied to ``tok_emb`` (+ bias), in
    ``x``'s (the compute) dtype, returned as float32."""
    cdt = x.dtype
    h = F.gelu(x @ outer["mlm_dense"].to(cdt), approximate="tanh")
    h = _layer_norm(h, outer["mlm_ln"]["g"].to(cdt),
                    outer["mlm_ln"]["b"].to(cdt))
    logits = h @ outer["tok_emb"].T.to(cdt) + outer["mlm_bias"].to(cdt)
    return logits.float()


def _masked_nll(logits, labels):
    """Mean token NLL over positions with ``labels >= 0`` (-100 ≡
    ignored)."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    tok = -torch.gather(logp, -1, safe[..., None])[..., 0]
    tok = torch.where(valid, tok, 0.0)
    return tok.sum() / torch.clamp_min(valid.sum(), 1)


def forward(params, tokens, cfg: TransformerConfig, *, type_ids=None,
            mask=None, train=False, generator=None, mesh=None):
    """tokens (B, T) int -> MLM logits (B, T, V) float32."""
    return forward_with_aux(params, tokens, cfg, type_ids=type_ids,
                            mask=mask, train=train, generator=generator,
                            mesh=mesh)[0]


def forward_with_aux(params, tokens, cfg: TransformerConfig, *,
                     type_ids=None, mask=None, train=False, generator=None,
                     mesh=None):
    """Like :func:`forward` but also returns the auxiliary loss: a zero
    float32 scalar, since it is the MoE load-balancing loss in the
    reference and MoE is not ported.

    ``train=True`` with ``cfg.dropout > 0`` draws each layer's dropout
    from ``generator`` (a ``torch.Generator`` on the tokens' device):
    the attention seed with ``torch.randint`` and the hidden keep masks
    with ``bernoulli_``.  JAX's threefry/RBG streams cannot be
    reproduced in torch, so the hidden masks differ from the
    reference's by design; the attention mask, given the same seed, is
    the reference's bit for bit."""
    if mesh is not None:
        _not_ported("the mesh (tp/dp/sp/pp) forward")
    cdt = torch_dtype(cfg.dtype)
    tokens = tokens.long()
    B, T = tokens.shape
    x = params["tok_emb"][tokens].to(cdt)
    x = x + params["pos_emb"][:T][None].to(cdt)
    if type_ids is not None:
        x = x + params["type_emb"][type_ids.long()].to(cdt)
    x = _layer_norm(x, params["emb_ln"]["g"].to(cdt),
                    params["emb_ln"]["b"].to(cdt))
    drop = train and cfg.dropout > 0
    if drop and generator is None:
        raise ValueError("forward: train=True with dropout > 0 needs a "
                         "torch.Generator")
    layer_fn = _make_layer_fn(cfg)
    for layer in params["layers"]:
        draws = _layer_draws(cfg, B, T, generator, x.device) if drop \
            else None
        x = layer_fn(x, layer, mask, cfg, train, draws)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _mlm_head(params, x), aux


# ------------------------------------------------------------- train step --
def _mlm_head_loss(outer, x, batch, cfg: TransformerConfig):
    """MLM head + masked NLL on an encoder output ``x``, over the
    non-layer params only (the reference's factoring for its bucketed
    step)."""
    return _masked_nll(_mlm_head(outer, x), batch["labels"])


def mlm_loss(params, batch, generator, cfg: TransformerConfig, mesh=None):
    """Masked-LM objective: mean token NLL over the masked positions
    (``labels`` -100 ≡ unmasked); the reference's MoE auxiliary term is
    zero here.  ``batch``: dict of tensors ``tokens``, ``labels`` and
    optionally ``mask`` and ``type_ids``."""
    logits = forward(params, batch["tokens"], cfg,
                     type_ids=batch.get("type_ids"), mask=batch.get("mask"),
                     train=True, generator=generator, mesh=mesh)
    return _masked_nll(logits, batch["labels"])


@contextlib.contextmanager
def _restored(leaves, opt, generator):
    """The parameters, the AdamW state and the generator as on entry,
    again on exit (a warm-up step leaves no trace).  AdamW state made
    inside is zeroed, which is AdamW's initial state."""
    with torch.no_grad():
        saved = [p.detach().clone() for p in leaves]
        moments = {id(p): {k: v.clone() for k, v in opt.state[p].items()
                           if torch.is_tensor(v)}
                   for p in leaves if p in opt.state}
    gen = None if generator is None else generator.get_state()
    try:
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(leaves, saved):
                p.copy_(v)
            for p in leaves:
                was = moments.get(id(p), {})
                for k, v in opt.state[p].items():
                    if not torch.is_tensor(v):
                        continue
                    if k in was:
                        v.copy_(was[k])
                    else:
                        v.zero_()
        if gen is not None:
            generator.set_state(gen)


class _TrainStep:
    """``step(state, batch, generator) -> (state, loss)``: one AdamW
    step of ``mlm_loss`` over ``prepare(batch)`` (the batch as given
    for BERT; GPT sets its label shift), updating ``state`` IN PLACE.

    On CUDA each batch signature (keys, shapes, dtypes) gets one CUDA
    graph of the whole step, forward, backward and the AdamW update,
    replayed for every batch of that signature, as the reference's
    ``jax.jit`` retraces on a new shape.  The graphs bind one state
    and, with dropout, one generator: a call with another state drops
    the cached graphs, one with another generator captures its
    signature again.  The batch is copied into static buffers and the
    loss comes back as a copy of the graph's output.  Before a capture
    one warm-up step runs and the parameters, the AdamW state and the
    generator are put back (:func:`_restored`), so replay 1 is step 1.
    The generator is registered with the graph, so replay k draws the
    dropout of eager step k.  Gradients are the graph's: a leaf the
    loss reaches gets the graph's gradient tensor (bound to ``.grad``
    again at every call); one it does not reach keeps a zero gradient
    made once, before the capture.

    On the CPU nothing is captured: the same signature and
    static-buffer code runs the eager step.  ``_eager = True`` runs the
    eager step on CUDA too (to compare it with the captured one)."""

    def __init__(self, cfg, device, prepare=None):
        self.cfg = cfg
        self.device = device
        self.prepare = prepare or (lambda batch: batch)
        self._eager = False
        self._graphs = GraphCache(device)
        self._opt = None                # the state the graphs bind

    def _loss_backward(self, params, batch, generator):
        loss = mlm_loss(params, self.prepare(batch), generator, self.cfg)
        loss.backward()
        return loss.detach()

    def _eager_step(self, params, opt, batch, generator):
        """The step op by op: (loss, the leaves the loss did not
        reach, whose gradient is set to zeros as under ``jax.grad``)."""
        opt.zero_grad(set_to_none=True)
        loss = self._loss_backward(params, batch, generator)
        unreached = [p for p in tree_leaves(params) if p.grad is None]
        for p in unreached:
            p.grad = torch.zeros_like(p)
        opt.step()
        return loss, unreached

    def __call__(self, state, batch, generator):
        params, opt = state
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self._eager:
            batch = {k: v.to(self.device) for k, v in batch.items()}
            return state, self._eager_step(params, opt, batch,
                                           generator)[0]
        if self._opt is not opt:
            self._graphs.clear()
            self._opt = opt
        generator_key = generator if self.cfg.dropout > 0 else None
        key = tuple(sorted((k, tuple(v.shape), v.dtype)
                           for k, v in batch.items()))
        entry = self._graphs.get(key)
        if entry is None or entry.generator is not generator_key:
            entry = self._graphs.put(key, self._entry(
                params, opt, batch, generator, generator_key))
        for k, v in batch.items():
            entry.batch[k].copy_(v)
        loss = entry.program()
        if entry.grads is not None:
            for p, g in zip(tree_leaves(params), entry.grads):
                p.grad = g
        return state, loss.clone()

    def _entry(self, params, opt, batch, generator, generator_key):
        """A signature's static batch buffers and its step over them as
        a :class:`Program` (captured on CUDA)."""
        dev = self.device
        static = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                  for k, v in batch.items()}
        entry = types.SimpleNamespace(generator=generator_key, batch=static,
                                      grads=None)
        if dev.type != "cuda":
            entry.program = Program(lambda: self._eager_step(
                params, opt, static, generator)[0], dev)
            return entry
        if generator_key is None and self.cfg.dropout > 0:
            raise ValueError("step: dropout > 0 needs a torch.Generator")
        for k, v in batch.items():
            static[k].copy_(v)
        leaves = tree_leaves(params)
        with _restored(leaves, opt, generator):
            got = []
            warm_up(lambda: got.append(self._eager_step(
                params, opt, static, generator)[1]))
        unreached = {id(p) for p in got[0]}
        for p in leaves:
            p.grad = torch.zeros_like(p) if id(p) in unreached else None

        def body():
            loss = self._loss_backward(params, static, generator)
            opt.step()
            return loss

        entry.program = Program(body, dev, self._graphs.pool(), generators=(
            [] if generator_key is None else [generator]))
        entry.grads = [p.grad for p in leaves]
        return entry


def make_train_step(cfg: TransformerConfig, mesh=None, learning_rate=1e-4,
                    weight_decay=0.01, shard_optimizer=False,
                    scan_steps=None, scan_superbatch=False, fsdp=False,
                    bucket_overlap=False, *, device=None):
    """Build ``(init_state, step)`` for MLM pretraining on one device.

    ``init_state(seed=0, params=None)`` -> ``(params, optimizer)``: a
    copy of ``params`` (or :func:`init_params` of ``seed``) as leaf
    tensors in ``cfg.param_dtype`` on ``device``, and its
    ``torch.optim.AdamW`` (``capturable`` on CUDA).  ``step(state,
    batch, generator)`` -> ``(state, loss)`` updates the state IN PLACE
    (the reference donates and returns a new one) and leaves this
    step's gradients in each leaf's ``.grad``; on CUDA it replays one
    CUDA graph per batch signature (:class:`_TrainStep`).  ``batch``:
    dict of ``tokens``, ``labels`` (-100 ≡ unmasked) and optionally
    ``mask`` and ``type_ids``, as tensors or numpy arrays.
    ``generator``: the ``torch.Generator`` (on ``device``) that dropout
    draws from; see :func:`forward_with_aux`.

    The reference's ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-6, no
    decay mask) becomes ``torch.optim.AdamW`` with the same constants.
    Both decay every leaf, biases and layer norms included, and both
    compute ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` on the
    old ``p``, so the two are the same update up to rounding.  A leaf
    the loss does not reach (``type_emb`` without ``type_ids``) gets a
    zero gradient, as under ``jax.grad``, so it is decayed like the
    reference's.  The mesh options raise ``NotImplementedError``."""
    for name, on in (("mesh", mesh is not None),
                     ("shard_optimizer", shard_optimizer),
                     ("scan_steps", scan_steps is not None),
                     ("scan_superbatch", scan_superbatch),
                     ("fsdp", fsdp), ("bucket_overlap", bucket_overlap)):
        if on:
            _not_ported("make_train_step(%s=...)" % name)
    if cfg.n_experts:
        _not_ported("MoE layers")
    dev = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)

    def init_state(seed=0, params=None):
        if params is None:
            params = init_params(seed, cfg, device=dev)
        params = tree_map(
            lambda t: t.detach().to(dev, pdt).clone().requires_grad_(),
            params)
        opt = torch.optim.AdamW(tree_leaves(params), lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-6,
                                weight_decay=weight_decay,
                                capturable=dev.type == "cuda")
        return params, opt

    return init_state, _TrainStep(cfg, dev)
