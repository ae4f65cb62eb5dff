"""Transformer core shared by the GPT model: config, parameter init and
layer norm.  Port of ``mxnet_tpu/models/transformer.py``.

The parameter tree has the reference's structure and shapes exactly
(a dict of tensors, ``layers`` a list of per-layer dicts), so a tree
converted from the JAX package (``convert.from_jax``) and one drawn
here are interchangeable.  The draws differ: JAX's random streams
cannot be reproduced in torch, so parity tests convert the JAX tree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device

__all__ = ["TransformerConfig", "init_params"]


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
