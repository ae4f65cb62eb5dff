"""Decoder-only (GPT-style) language model: causal-LM training,
prefill, cached decode and ``generate``.  Port of
``mxnet_tpu/models/gpt.py``.

Training (:func:`make_train_step`) reuses the transformer core's train
step with ``causal=True`` and next-token labels; the functions from
:func:`prepare_params` on are the decode path.

Plain functions on tensors over a dict of parameter tensors.  The JAX
reference casts each float32 master weight to the compute dtype at
every use; :func:`prepare_params` does the same cast once (and fuses
the q/k/v weights once), which gives the same values bit for bit
because both casts round to nearest even.  Every function below that
takes ``params`` expects a prepared tree.

An MoE layer's FFN (``parallel/moe.py``) routes its tokens in the
reference's groups at each call site: a prompt at a time in the
prefill, a sequence's verify block at a time in :func:`_decode_block`,
and each token alone in :func:`_decode_one` and the serving step.
Expert capacity depends on the group, so under a capacity factor that
drops slots these functions may disagree with each other, as the
reference's do; each is held to its reference counterpart.

The full-sequence prefill attention goes through the flash-forward
kernel (``kernels/flash_attention.py``); the single-row decode
attention (:func:`_attend_rows`) and the block attention of the
speculative verify (:func:`_attend_block`) are plain torch, as they are
plain XLA in the reference.

:func:`generate_speculative` drafts K tokens an iteration (prompt
lookup, :func:`_draft_ngram`, or a small self-drafting model, such as
:func:`draft_slice_params` makes) and verifies them in one block
forward (:func:`_decode_block`); greedy output is token-identical to
:func:`generate` under float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..kernels.flash_attention import flash_attention
from ..parallel.moe import moe_ffn
from . import transformer as T

__all__ = ["gpt_config", "gpt_tiny", "init_params", "forward",
           "make_train_step", "prepare_params", "quantize_decode_params",
           "generate", "generate_speculative", "draft_slice_params"]

init_params = T.init_params
forward = T.forward


def gpt_config(**kw):
    """A TransformerConfig preset for decoder-only LM use."""
    base = dict(causal=True, type_vocab_size=1)
    base.update(kw)
    return T.TransformerConfig(**base)


def gpt_tiny(**kw):
    base = dict(vocab_size=1024, max_len=128, d_model=64, n_heads=4,
                n_layers=2, d_ff=128, causal=True, type_vocab_size=1)
    base.update(kw)
    return T.TransformerConfig(**base)


def make_train_step(cfg, mesh=None, learning_rate=1e-4, weight_decay=0.01,
                    *, device=None):
    """``(init_state, step)`` for causal-LM training on one device (see
    ``transformer.make_train_step``); ``step(state, batch, generator)``
    where batch = dict(tokens[, mask]).  Labels are the tokens shifted
    left (next-token prediction); the last position and every position
    whose next token is padding (the shifted mask) get -100.  The shift
    runs inside the step, in its CUDA graph on the card."""
    if not cfg.causal:
        cfg = dataclasses.replace(cfg, causal=True)
    init_state, step = T.make_train_step(
        cfg, mesh=mesh, learning_rate=learning_rate,
        weight_decay=weight_decay, device=device)
    step.prepare = _lm_batch
    return init_state, step


def _lm_batch(batch):
    """The masked-LM batch of a causal-LM one: next-token labels, -100
    at the last position and where the next token is padding."""
    tokens = batch["tokens"].long()
    dev = tokens.device
    mask = batch.get("mask")
    mask = (torch.ones(tokens.shape, dtype=torch.bool, device=dev)
            if mask is None else mask.bool())
    B = tokens.shape[0]
    labels = torch.cat([tokens[:, 1:],
                        torch.full((B, 1), -100, dtype=tokens.dtype,
                                   device=dev)], dim=1)
    shifted = torch.cat([mask[:, 1:],
                         torch.zeros(B, 1, dtype=torch.bool, device=dev)],
                        dim=1)
    labels = torch.where(shifted, labels, -100)
    return {"tokens": tokens, "labels": labels, "mask": mask}


def quantize_decode_params(params):
    """Weight-only int8 quantization of the decode-path matmul weights,
    bit-exact with the reference: per-output-channel symmetric s8
    ``{"q": int8, "s": f32}`` for every 2-D weight, per-row for
    ``tok_emb`` (one table serves the lookup and the tied logits).
    The attention weights of every layer are quantized, the FFN weights
    only in dense layers: an MoE layer's experts stay float.
    ``torch.round`` rounds half to even like ``jnp.round``."""
    def q_cols(w):                       # (in, out): per-column scale
        s = torch.clamp_min(w.abs().amax(dim=0) / 127.0, 1e-8)
        qw = torch.clamp(torch.round(w / s[None, :]), -127, 127)
        return {"q": qw.to(torch.int8), "s": s.float()}

    def q_rows(w):                       # (vocab, d): per-row scale
        s = torch.clamp_min(w.abs().amax(dim=1) / 127.0, 1e-8)
        qw = torch.clamp(torch.round(w / s[:, None]), -127, 127)
        return {"q": qw.to(torch.int8), "s": s.float()}

    out = dict(params)
    out["tok_emb"] = q_rows(params["tok_emb"])
    out["mlm_dense"] = q_cols(params["mlm_dense"])
    layers = []
    for layer in params["layers"]:
        nl = dict(layer)
        for k in ("wq", "wk", "wv", "wo") + (
                () if "moe" in layer else ("w1", "w2")):
            nl[k] = q_cols(layer[k])
        layers.append(nl)
    out["layers"] = layers
    return out


def prepare_params(params, cfg, device=None):
    """The decode tree the functions below read: every float leaf cast
    once to the compute dtype on ``device``, q/k/v fused into one
    ``wqkv``/``bqkv`` per layer, and the leaves the reference reads in
    float32 (``mlm_bias``, the int8 embedding's per-row scales) kept
    in float32.  Weight-only int8 ``{"q", "s"}`` weights keep their
    structure with both parts in the compute dtype, exactly the
    operands the reference's ``_wmm`` builds per call.  An MoE layer's
    ``moe`` subtree takes the dtypes its ``moe_ffn`` reads: the router
    float32, the experts the compute dtype.  Idempotent."""
    dev = resolve_device(device)
    cdt = T.torch_dtype(cfg.dtype)
    f32 = torch.float32

    def w(x):
        if isinstance(x, dict):
            return {"q": x["q"].to(dev, cdt), "s": x["s"].to(dev, cdt)}
        return x.to(dev, cdt)

    def ln(x):
        return {"g": x["g"].to(dev, cdt), "b": x["b"].to(dev, cdt)}

    def fuse(layer):
        if "wqkv" in layer:
            return w(layer["wqkv"]), layer["bqkv"].to(dev, cdt)
        ws = [layer[k] for k in ("wq", "wk", "wv")]
        if isinstance(ws[0], dict):
            wqkv = {"q": torch.cat([x["q"] for x in ws], dim=1),
                    "s": torch.cat([x["s"] for x in ws])}
        else:
            wqkv = torch.cat(ws, dim=1)
        bqkv = torch.cat([layer[k].to(cdt) for k in ("bq", "bk", "bv")])
        return w(wqkv), bqkv.to(dev)

    emb = params["tok_emb"]
    if isinstance(emb, dict):
        emb = {"q": emb["q"].to(dev, cdt), "s": emb["s"].to(dev, f32)}
    else:
        emb = emb.to(dev, cdt)
    out = {"tok_emb": emb,
           "pos_emb": params["pos_emb"].to(dev, cdt),
           "emb_ln": ln(params["emb_ln"]),
           "mlm_dense": w(params["mlm_dense"]),
           "mlm_ln": ln(params["mlm_ln"]),
           "mlm_bias": params["mlm_bias"].to(dev, f32),
           "layers": []}
    for layer in params["layers"]:
        wqkv, bqkv = fuse(layer)
        nl = {"wqkv": wqkv, "bqkv": bqkv,
              "wo": w(layer["wo"]), "bo": layer["bo"].to(dev, cdt),
              "ln1": ln(layer["ln1"]), "ln2": ln(layer["ln2"])}
        if "moe" in layer:
            nl["moe"] = {k: v.to(dev, f32 if k == "router" else cdt)
                         for k, v in layer["moe"].items()}
        else:
            nl.update({"w1": w(layer["w1"]), "b1": layer["b1"].to(dev, cdt),
                       "w2": w(layer["w2"]), "b2": layer["b2"].to(dev, cdt)})
        out["layers"].append(nl)
    return out


def _wmm(x, w):
    """x @ W for a float or weight-only-int8 ({"q","s"}) weight."""
    if isinstance(w, dict):
        return (x @ w["q"]) * w["s"]
    return x @ w


def _embed(params, tokens, cdt):
    """Token embedding lookup for float or weight-only-int8 tables."""
    emb = params["tok_emb"]
    if isinstance(emb, dict):
        return emb["q"][tokens] * emb["s"][tokens].to(cdt)[..., None]
    return emb[tokens]


def _qkv(layer, x):
    """Fused QKV matmul, bias included (prefill and decode)."""
    return _wmm(x, layer["wqkv"]) + layer["bqkv"]


def _ffn(layer, x, cfg):
    """The FFN of a dense or an MoE layer.  MoE routes the reference's
    groups: x (B, S, D) as B groups of S tokens, x (R, D) as R groups
    of one token."""
    if "moe" in layer:
        g = x if x.dim() == 3 else x[:, None, :]
        h, _ = moe_ffn(g, layer["moe"], n_experts=cfg.n_experts,
                       top_k=cfg.expert_top_k,
                       capacity_factor=cfg.capacity_factor, dtype=x.dtype)
        return h.view(x.shape)
    h = F.gelu(_wmm(x, layer["w1"]) + layer["b1"], approximate="tanh")
    return _wmm(h, layer["w2"]) + layer["b2"]


def _lm_head(params, x, cdt):
    """gelu(mlm_dense) -> LN -> tied-embedding logits (+bias), f32."""
    h = F.gelu(_wmm(x, params["mlm_dense"]), approximate="tanh")
    h = T._layer_norm(h, params["mlm_ln"]["g"], params["mlm_ln"]["b"])
    emb = params["tok_emb"]
    if isinstance(emb, dict):
        logits = (h @ emb["q"].T).float() * emb["s"][None, :]
    else:
        logits = (h @ emb.T).float()
    return logits + params["mlm_bias"]


def _kv_quantize(k, v):
    """Per-(row, token) symmetric s8 KV quantization over the head dim,
    in float32: returns (kv_q int8 (..., 2*dh), scales f32 (..., 2))."""
    kf, vf = k.float(), v.float()
    sk = torch.clamp_min(kf.abs().amax(dim=-1) / 127.0, 1e-8)
    sv = torch.clamp_min(vf.abs().amax(dim=-1) / 127.0, 1e-8)
    kq = torch.clamp(torch.round(kf / sk[..., None]), -127, 127)
    vq = torch.clamp(torch.round(vf / sv[..., None]), -127, 127)
    return (torch.cat([kq, vq], dim=-1).to(torch.int8),
            torch.stack([sk, sv], dim=-1))


def _sqrt_f32(n):
    # jnp.sqrt(jnp.float32(n)), as a Python float holding the f32 value
    return float(np.sqrt(np.float32(n)))


def _attend_rows(q, ckv, cs, pos, dh):
    """Single-token attention over a fused (R, L, 2*dh) KV view.

    q: (R, dh); pos: int or (R,) per-row absolute position — row r
    attends to view slots <= pos[r].  cs: the int8-KV (R, L, 2) scale
    view, or None for a float view.  Returns (R, dh) f32.  The dots
    run on operands in the compute dtype with float32 accumulation
    (the reference's ``preferred_element_type``); the k scale
    multiplies the scores, the v scale folds into the weights."""
    cdt = q.dtype
    L = ckv.shape[1]
    qf = q.float()[:, :, None]                         # (R, dh, 1)
    k = ckv[:, :, :dh].to(cdt).float()
    v = ckv[:, :, dh:].to(cdt).float()
    s = torch.bmm(k, qf)[:, :, 0]                      # (R, L)
    if cs is not None:
        s = s * cs[:, :, 0]
    s = s / _sqrt_f32(dh)
    slots = torch.arange(L, device=q.device)[None, :]
    valid = slots <= (pos if isinstance(pos, int) else pos.reshape(-1, 1))
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    if cs is not None:
        p = p * cs[:, :, 1]
    p = p.to(cdt).float()
    return torch.bmm(p[:, None, :], v)[:, 0, :]        # (R, dh)


def _layer(layer, x, attn_fn, cfg):
    """One decoder layer around an attention callable (post-LN)."""
    attn = _wmm(attn_fn(_qkv(layer, x)), layer["wo"]) + layer["bo"]
    x = T._layer_norm(x + attn, layer["ln1"]["g"], layer["ln1"]["b"])
    return T._layer_norm(x + _ffn(layer, x, cfg), layer["ln2"]["g"],
                         layer["ln2"]["b"])


def _prefill_full(params, cfg, tokens, total, kv_int8=False):
    """Whole-prompt prefill in one causal forward pass.

    tokens: (B, P) int.  Returns (last_logits (B, V) f32, caches) with
    per-layer caches sized ``total`` and positions [0, P) filled:
    ``{"kv": (B*H, total, 2*dh)}`` in the compute dtype, or
    ``{"kv": int8, "s": (B*H, total, 2) f32}`` with ``kv_int8``."""
    cdt = T.torch_dtype(cfg.dtype)
    B, P = tokens.shape
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    dev = tokens.device

    x = _embed(params, tokens, cdt) + params["pos_emb"][:P][None]
    x = T._layer_norm(x, params["emb_ln"]["g"], params["emb_ln"]["b"])
    caches = []
    for layer in params["layers"]:
        kv = {}

        def attend(qkv):
            q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, P, H, dh)
                       for i in range(3))
            kf = k.permute(0, 2, 1, 3).reshape(B * H, P, dh)
            vf = v.permute(0, 2, 1, 3).reshape(B * H, P, dh)
            if kv_int8:
                kvq, skv = _kv_quantize(kf, vf)
                kv["kv"] = torch.zeros(B * H, total, 2 * dh,
                                       dtype=torch.int8, device=dev)
                kv["kv"][:, :P] = kvq
                kv["s"] = torch.zeros(B * H, total, 2,
                                      dtype=torch.float32, device=dev)
                kv["s"][:, :P] = skv
            else:
                kv["kv"] = torch.zeros(B * H, total, 2 * dh, dtype=cdt,
                                       device=dev)
                kv["kv"][:, :P] = torch.cat([kf, vf], dim=2)
            return flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True) \
                .reshape(B, P, D)

        x = _layer(layer, x, attend, cfg)
        caches.append(kv)
    return _lm_head(params, x[:, -1], cdt), caches


def _decode_one(params, cfg, token, pos, caches):
    """One decode step: token (B,) at position ``pos`` (int).  Writes
    this position's k/v into ``caches`` IN PLACE (the reference
    returns updated copies; torch can update the buffers it owns) and
    returns (logits (B, V) f32, caches)."""
    cdt = T.torch_dtype(cfg.dtype)
    B = token.shape[0]
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H

    x = _embed(params, token, cdt) + params["pos_emb"][pos]
    x = T._layer_norm(x, params["emb_ln"]["g"], params["emb_ln"]["b"])
    for layer, cache in zip(params["layers"], caches):
        def attend(qkv):
            q, k, v = (qkv[:, i * D:(i + 1) * D].reshape(B * H, dh)
                       for i in range(3))
            if "s" in cache:
                kvq, skv = _kv_quantize(k, v)
                cache["kv"][:, pos] = kvq
                cache["s"][:, pos] = skv
                attn = _attend_rows(q, cache["kv"], cache["s"], pos, dh)
            else:
                cache["kv"][:, pos] = torch.cat([k, v], dim=1)
                attn = _attend_rows(q, cache["kv"], None, pos, dh)
            return attn.to(cdt).reshape(B, D)

        x = _layer(layer, x, attend, cfg)
    return _lm_head(params, x, cdt), caches


def generate(params, cfg, prompt, max_new_tokens, *, temperature=0.0,
             generator=None, kv_int8=False, device=None):
    """Autoregressive generation with KV caches.

    prompt: (B, P) ints (numpy or tensor).  ``temperature`` 0 is greedy
    argmax; otherwise softmax sampling from ``generator`` (a
    ``torch.Generator`` on ``device``; seeded with 0 when omitted).
    Returns (B, P + max_new_tokens) int64 on ``device``.  The decode
    loop is a Python loop of ``_decode_one`` steps; ``kv_int8`` stores
    the caches as per-token symmetric s8."""
    dev = resolve_device(device)
    if not cfg.causal:
        cfg = dataclasses.replace(cfg, causal=True)
    prompt = torch.as_tensor(prompt).to(dev).long()
    B, P = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    total = P + max_new_tokens
    if total > cfg.max_len:
        raise ValueError("generate: %d tokens > cfg.max_len=%d"
                         % (total, cfg.max_len))
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def sample(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    with torch.inference_mode():
        dparams = prepare_params(params, cfg, dev)
        logits, caches = _prefill_full(dparams, cfg, prompt, total,
                                       kv_int8=kv_int8)
        toks = []
        for i in range(max_new_tokens - 1):
            tok = sample(logits)
            toks.append(tok)
            logits, caches = _decode_one(dparams, cfg, tok, P + i, caches)
        toks.append(sample(logits))
        return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


def _attend_block(q, ckv, cs, pos, dh):
    """Block (multi-token) attention over a fused (R, L, 2*dh) KV view:
    q is (R, S, dh) at positions [pos, pos+S), block row i attending to
    view slots <= pos+i; ``cs`` as in :func:`_attend_rows`.  Returns
    (R, S, dh) f32, with the dots' operands in the compute dtype and
    float32 accumulation, as :func:`_attend_rows`."""
    cdt = q.dtype
    L, S = ckv.shape[1], q.shape[1]
    k = ckv[:, :, :dh].to(cdt).float()
    v = ckv[:, :, dh:].to(cdt).float()
    s = torch.bmm(k, q.float().transpose(1, 2))        # (R, L, S)
    if cs is not None:
        s = s * cs[:, :, 0:1]
    s = s / _sqrt_f32(dh)
    dev = q.device
    valid = torch.arange(L, device=dev)[None, :, None] <= \
        pos + torch.arange(S, device=dev)[None, None, :]
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=1)
    if cs is not None:
        p = p * cs[:, :, 1:2]
    p = p.to(cdt).float()
    return torch.bmm(p.transpose(1, 2), v)             # (R, S, dh)


def _decode_block(params, cfg, tokens, pos, caches):
    """Batched multi-token decode step (the speculative verify
    forward): ``tokens`` (B, S) at positions [pos, pos+S), one causal
    forward over the block.  Writes the block's k/v into ``caches`` at
    [pos, pos+S) IN PLACE first, then attends with the per-row causal
    mask, so :func:`_decode_one` is the S=1 case.  Returns (logits
    (B, S, V) f32, caches).

    Stale cache slots past the committed length need no rollback: the
    next block write at the committed position overwrites them before
    any mask exposes them."""
    cdt = T.torch_dtype(cfg.dtype)
    B, S = tokens.shape
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H

    x = _embed(params, tokens, cdt) + params["pos_emb"][pos:pos + S][None]
    x = T._layer_norm(x, params["emb_ln"]["g"], params["emb_ln"]["b"])
    for layer, cache in zip(params["layers"], caches):
        def attend(qkv):
            q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, S, H, dh)
                       .permute(0, 2, 1, 3).reshape(B * H, S, dh)
                       for i in range(3))
            if "s" in cache:
                kvq, skv = _kv_quantize(k, v)
                cache["kv"][:, pos:pos + S] = kvq
                cache["s"][:, pos:pos + S] = skv
                attn = _attend_block(q, cache["kv"], cache["s"], pos, dh)
            else:
                cache["kv"][:, pos:pos + S] = torch.cat([k, v], dim=2)
                attn = _attend_block(q, cache["kv"], None, pos, dh)
            return attn.to(cdt).reshape(B, H, S, dh).permute(0, 2, 1, 3) \
                .reshape(B, S, D)

        x = _layer(layer, x, attend, cfg)
    return _lm_head(params, x, cdt), caches


def draft_slice_params(params, cfg, n_layers=2):
    """Self-drafting: the draft model is the target's own first
    ``n_layers`` decoder layers with the shared embedding and LM head.
    Returns (draft_params, draft_cfg) for
    ``generate_speculative(drafter="self")``."""
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    dparams = dict(params)
    dparams["layers"] = list(params["layers"][:n_layers])
    return dparams, dcfg


def _draft_ngram(token_buf, n_next, K, g):
    """Prompt-lookup drafter on the device: find the most recent earlier
    occurrence of the last ``g`` committed tokens of each row and
    propose the K tokens that followed it; repeat the last committed
    token where no match covers.  token_buf (B, BUF) with positions
    [0, n_next) committed.  Returns (B, K) proposals for positions
    [n_next, n_next+K), in token_buf's dtype.  The twin of
    ``serving/drafters.py ngram_draft``."""
    B, BUF = token_buf.shape
    dev = token_buf.device
    W = BUF - g + 1                       # candidate window starts
    # the reference's dynamic_slice clamps its start into [0, BUF-g]
    st = min(max(n_next - g, 0), BUF - g)
    key = token_buf[:, st:st + g]
    eq = torch.ones(B, W, dtype=torch.bool, device=dev)
    for j in range(g):
        eq &= token_buf[:, j:W + j] == key[:, j:j + 1]
    # a usable match ends before the key, its continuation starting
    # inside the committed region
    starts = torch.arange(W, device=dev)[None, :]
    eq &= starts + g < n_next
    s_star = torch.where(eq, starts, -1).amax(dim=1)   # (B,)
    idx = s_star[:, None] + g + torch.arange(K, device=dev)[None, :]
    ok = (s_star >= 0)[:, None] & (idx < n_next)
    cand = torch.gather(token_buf, 1, idx.clamp(0, BUF - 1))
    lt = min(max(n_next - 1, 0), BUF - 1)
    last = token_buf[:, lt:lt + 1].expand(B, K)
    return torch.where(ok, cand, last)


def generate_speculative(params, cfg, prompt, max_new_tokens, *, K=4,
                         drafter="ngram", draft_params=None,
                         draft_cfg=None, ngram=2, temperature=0.0,
                         generator=None, kv_int8=False,
                         return_stats=False, device=None):
    """Speculative generation: draft K tokens an iteration, verify them
    in ONE causal block forward of the target (:func:`_decode_block`)
    and accept the longest prefix that matches what the target itself
    produces, plus the target's token at the first mismatch.  Greedy
    decoding is token-identical to :func:`generate` (bit-exact under
    float32); ``temperature > 0`` uses the draft-rejection rule (accept
    d with probability min(1, p(d)/q(d)), else sample the renormalised
    residual max(p - q, 0)), drawing from ``generator`` (a
    ``torch.Generator`` on ``device``; seeded with 0 when omitted).

    ``drafter="ngram"`` proposes by prompt lookup over the last
    ``ngram`` tokens (:func:`_draft_ngram`); ``drafter="self"`` runs a
    small GPT (``draft_params``/``draft_cfg``, same vocabulary; e.g.
    :func:`draft_slice_params`) for K+1 cached decode steps an
    iteration.  Acceptance is synchronised across the batch (the
    pointer advances by the smallest accept count + 1); rejected
    positions roll back by pointer only.  Needs ``P + max_new_tokens +
    K <= cfg.max_len``.  Returns (B, P + max_new_tokens) int64 on
    ``device``, and with ``return_stats`` also ``{"iters", "drafted",
    "accepted", "tokens"}``."""
    dev = resolve_device(device)
    if not cfg.causal:
        cfg = dataclasses.replace(cfg, causal=True)
    if K < 1:
        raise ValueError("generate_speculative: K must be >= 1")
    if drafter == "self":
        if draft_params is None or draft_cfg is None:
            raise ValueError("drafter='self' needs draft_params and "
                             "draft_cfg")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft model must share the vocab")
        if not draft_cfg.causal:
            draft_cfg = dataclasses.replace(draft_cfg, causal=True)
    elif drafter != "ngram":
        raise ValueError("drafter must be 'ngram' or 'self'")
    prompt = torch.as_tensor(prompt).to(dev).long()
    B, P = prompt.shape
    if max_new_tokens <= 0:
        stats = {"iters": 0, "drafted": 0, "accepted": 0, "tokens": 0}
        return (prompt, stats) if return_stats else prompt
    total = P + max_new_tokens + K      # the verify may overshoot by <= K
    if total > cfg.max_len:
        raise ValueError(
            "generate_speculative: %d tokens (incl. K=%d overshoot "
            "headroom) > cfg.max_len=%d" % (total, K, cfg.max_len))
    if drafter == "self" and total > draft_cfg.max_len:
        raise ValueError("draft_cfg.max_len too small: need %d" % total)
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def sample(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    with torch.inference_mode():
        tparams = prepare_params(params, cfg, dev)
        logits, caches = _prefill_full(tparams, cfg, prompt, total,
                                       kv_int8=kv_int8)
        pending = sample(logits)                       # (B,)
        # prompt + committed tokens; slots past the committed pointer
        # hold stale drafts, which the drafter masks out
        token_buf = torch.zeros(B, total, dtype=torch.long, device=dev)
        token_buf[:, :P] = prompt
        token_buf[:, P] = pending
        if drafter == "self":
            dparams = prepare_params(draft_params, draft_cfg, dev)
            _, dcaches = _prefill_full(dparams, draft_cfg, prompt, total)
        emitted, iters, accepted = 1, 0, 0
        while emitted < max_new_tokens:
            n = P + emitted - 1           # cache position of `pending`
            q = None
            if drafter == "ngram":
                drafts = _draft_ngram(token_buf, n + 1, K, ngram)
            else:
                # K+1 steps: the draft caches end the iteration filled
                # through n+K; the last proposal is discarded
                tok, toks, lgs = pending, [], []
                for i in range(K + 1):
                    lg, dcaches = _decode_one(dparams, draft_cfg, tok,
                                              n + i, dcaches)
                    tok = sample(lg)
                    toks.append(tok)
                    lgs.append(lg)
                drafts = torch.stack(toks[:K], dim=1)
                if temperature != 0.0:
                    q = torch.softmax(torch.stack(lgs[:K], dim=1).float()
                                      / temperature, dim=-1)  # (B, K, V)
            block = torch.cat([pending[:, None], drafts], dim=1)
            logits_blk, caches = _decode_block(tparams, cfg, block, n,
                                               caches)  # (B, K+1, V)
            if temperature == 0.0:
                tgt = torch.argmax(logits_blk, dim=-1)
                ok = drafts == tgt[:, :K]
            else:
                p = torch.softmax(logits_blk.float() / temperature, dim=-1)
                p_d = torch.gather(p[:, :K], 2, drafts[:, :, None])[:, :, 0]
                if q is None:              # deterministic (one-hot) draft
                    ratio = p_d
                else:
                    q_d = torch.gather(q, 2, drafts[:, :, None])[:, :, 0]
                    ratio = p_d / q_d.clamp_min(1e-30)
                u = torch.rand(B, K, generator=generator, device=dev)
                ok = u < ratio
            a_b = torch.cumprod(ok.int(), dim=1).sum(dim=1)    # (B,)
            a = int(a_b.min())            # batch-synchronised commit
            if temperature == 0.0:
                cont = tgt[:, a]
            else:
                # residual sampling at the first rejected position; rows
                # that accepted past `a` keep their verified draft
                j = min(a, K - 1)
                p_a = p[:, a]
                q_a = (F.one_hot(drafts[:, j], cfg.vocab_size).float()
                       if q is None else q[:, j])
                res = (p_a - (0.0 if a >= K else 1.0) * q_a).clamp_min(0.0)
                rs = res.sum(dim=-1, keepdim=True)
                res = torch.where(rs > 0, res / rs.clamp_min(1e-30), p_a)
                cont_s = torch.multinomial(res, 1, generator=generator)[:, 0]
                cont = torch.where(a_b > a, drafts[:, j], cont_s)
            token_buf[:, n + 1:n + 1 + K] = drafts
            token_buf[:, n + a + 1] = cont
            pending = cont
            emitted += a + 1
            iters += 1
            accepted += a
        out = token_buf[:, :P + max_new_tokens]
    if return_stats:
        return out, {"iters": iters, "drafted": iters * K,
                     "accepted": accepted, "tokens": emitted}
    return out
