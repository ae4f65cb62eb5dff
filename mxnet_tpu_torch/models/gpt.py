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

The full-sequence prefill attention goes through the flash-forward
kernel (``kernels/flash_attention.py``); the single-row decode
attention (:func:`_attend_rows`) is plain torch, as it is plain XLA in
the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..kernels.flash_attention import flash_attention
from . import transformer as T

__all__ = ["gpt_config", "gpt_tiny", "init_params", "forward",
           "make_train_step", "prepare_params", "quantize_decode_params",
           "generate"]

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
        for k in ("wq", "wk", "wv", "wo", "w1", "w2"):
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
    operands the reference's ``_wmm`` builds per call.  Idempotent."""
    dev = resolve_device(device)
    cdt = T.torch_dtype(cfg.dtype)
    f32 = torch.float32
    if any("moe" in layer for layer in params["layers"]):
        raise NotImplementedError("mxnet_tpu_torch: MoE layers are not "
                                  "ported yet")

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
        out["layers"].append({
            "wqkv": wqkv, "bqkv": bqkv,
            "wo": w(layer["wo"]), "bo": layer["bo"].to(dev, cdt),
            "ln1": ln(layer["ln1"]), "ln2": ln(layer["ln2"]),
            "w1": w(layer["w1"]), "b1": layer["b1"].to(dev, cdt),
            "w2": w(layer["w2"]), "b2": layer["b2"].to(dev, cdt)})
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


def _ffn(layer, x):
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


def _layer(layer, x, attn_fn):
    """One decoder layer around an attention callable (post-LN)."""
    attn = _wmm(attn_fn(_qkv(layer, x)), layer["wo"]) + layer["bo"]
    x = T._layer_norm(x + attn, layer["ln1"]["g"], layer["ln1"]["b"])
    return T._layer_norm(x + _ffn(layer, x), layer["ln2"]["g"],
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

        x = _layer(layer, x, attend)
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

        x = _layer(layer, x, attend)
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
