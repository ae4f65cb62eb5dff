"""Mixture-of-Experts FFN on one device.

Port of ``mxnet_tpu/parallel/moe.py`` (the GShard/Switch recipe): a
learned router picks the top-k experts of each token, tokens are packed
into per-expert buffers of a fixed capacity, every expert runs its FFN
over its buffer, and each token's output is the gate-weighted sum of
its experts' outputs.  An auxiliary load-balancing loss (Switch eq. 4)
keeps the router from collapsing onto a few experts.

The semantics are the reference's exactly: router logits and softmax
gates in float32; the aux loss ``E * sum(frac * prob)`` with ``frac``
from the first argmax; the top-k gate values renormalised; a capacity
of ``C = max(1, ceil(k * S * capacity_factor / E))`` per group of S
tokens, positions counted slot-major (every token's first choice before
any second choice), so slot-0 picks win; a slot past its expert's
capacity contributes nothing.  Where the reference packs and unpacks
with dense one-hot einsums, this port moves rows by index: the dispatch
is an ``index_select`` of the token rows (exact), the combine a gather
of each token's k expert rows summed in float32.  Each expert's two
products are one batched matmul over all experts (``torch.bmm``), as
they are XLA's work in the reference, outside any Pallas kernel.

Every shape is static and nothing is read back to the host, so the FFN
runs inside the CUDA graphs of the serving step and the train step.

Ties between gates: ``jax.lax.top_k`` puts the lower expert index first.
The port picks the k experts by k successive ``torch.argmax`` calls,
each masking the previous picks, and ``torch.argmax`` returns the first
of equal maxima on every device, so a tie goes to the lower index here
too.

Expert parallelism over a live ``ep`` (or ``dp``) mesh axis is not
ported; ``moe_param_specs`` and ``moe_param_shardings`` come with it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..base import MXNetError, not_ported
from .mesh import check_one_device

__all__ = ["init_moe_ffn", "moe_ffn"]


def init_moe_ffn(seed, d_model, d_ff, n_experts, param_dtype="float32", *,
                 device=None):
    """Router and per-expert FFN parameters with the reference's tree
    and shapes: ``router (D, E)``, ``w1 (E, D, F)``, ``b1 (E, F)``,
    ``w2 (E, F, D)``, ``b2 (E, D)``; weights ``N(0, 0.02)``, biases 0.
    Drawn on the CPU from a ``torch.Generator`` seeded with ``seed`` (an
    int, or a generator to draw from), then moved to ``device``."""
    dev = resolve_device(device)
    dt = getattr(torch, str(param_dtype))
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    D, Fd, E = d_model, d_ff, n_experts

    def normal(*shape):
        return (torch.randn(*shape, generator=gen) * 0.02).to(dev, dt)

    return {"router": normal(D, E),
            "w1": normal(E, D, Fd), "b1": torch.zeros(E, Fd, dtype=dt,
                                                      device=dev),
            "w2": normal(E, Fd, D), "b2": torch.zeros(E, D, dtype=dt,
                                                      device=dev)}


def capacity(S, n_experts, top_k, capacity_factor):
    """Slots an expert has in a group of S tokens (the reference's C)."""
    return max(1, math.ceil(top_k * S * capacity_factor / n_experts))


def route(x, router, n_experts, top_k, capacity_factor):
    """The router's decisions for x (G, S, D): ``(idx, val, pos, keep,
    aux)`` with idx, pos (G, S, k) int64 (the expert of each slot and
    its position in that expert's buffer), val (G, S, k) the
    renormalised float32 gate values, keep (G, S, k) bool (the slot
    fits its expert's capacity) and aux the float32 load-balancing
    loss."""
    G, S, _ = x.shape
    E, k = n_experts, top_k
    C = capacity(S, E, k, capacity_factor)
    gates = torch.softmax(x.float() @ router.float(), dim=-1)   # (G,S,E)
    ids = torch.arange(E, device=x.device)
    # top-k by successive argmax: ties go to the lower expert index
    rest, idx, val = gates.detach(), [], []
    for _ in range(k):
        i = rest.argmax(dim=-1, keepdim=True)
        idx.append(i)
        val.append(gates.gather(-1, i))
        rest = rest.scatter(-1, i, -1.0)      # gates are >= 0
    idx, val = torch.cat(idx, -1), torch.cat(val, -1)           # (G,S,k)
    frac = (idx[..., :1] == ids).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * gates.mean(dim=(0, 1)))
    val = val / torch.clamp_min(val.sum(-1, keepdim=True), 1e-9)
    # slot-major positions: cumsum over (slot, token) of each expert
    onehot = (idx[..., None] == ids).long()                 # (G,S,k,E)
    flat = onehot.transpose(1, 2).reshape(G, k * S, E)
    before = (flat.cumsum(1) - flat).reshape(G, k, S, E).transpose(1, 2)
    pos = (before * onehot).sum(-1)                             # (G,S,k)
    return idx, val, pos, pos < C, aux


def dispatch(x, router, n_experts, top_k, capacity_factor, cdt):
    """Route x (G, S, D) and pack the expert buffers: ``(xin, row, keep,
    val, aux)`` with xin (E, G*C, D) in ``cdt`` (each expert's C slots of
    each group, a slot no token fills zero), row (G, S, k) each token
    slot's row in the flat (E*G*C, D) buffers where ``keep``, and val
    and aux as :func:`route` gives them."""
    G, S, D = x.shape
    E, k = n_experts, top_k
    C = capacity(S, E, k, capacity_factor)
    idx, val, pos, keep, aux = route(x, router, E, k, capacity_factor)
    # each dropped slot gets a row of its own past the buffers, so every
    # scatter index below is unique
    dev = x.device
    n_buf = E * G * C
    slot = torch.arange(G * S * k, device=dev).view(G, S, k)
    row = (idx * G + torch.arange(G, device=dev)[:, None, None]) * C + pos
    row = torch.where(keep, row, n_buf + slot)
    # the token (or the zero row G*S) that fills each buffer row
    src = torch.full((n_buf + G * S * k,), G * S, dtype=torch.long,
                     device=dev)
    src.scatter_(0, row.reshape(-1), (slot // k).reshape(-1))
    xs = F.pad(x.reshape(G * S, D).to(cdt), (0, 0, 0, 1))
    xin = xs.index_select(0, src[:n_buf]).view(E, G * C, D)
    return xin, row, keep, val, aux


def combine(y, row, keep, val, cdt):
    """Each token's k expert rows of y (E*G*C, D), weighted by its gate
    values rounded to ``cdt`` (a dropped slot by 0) and summed in
    float32: (G, S, D) float32."""
    G, S, k = row.shape
    got = y.index_select(0, torch.where(keep, row, 0).reshape(-1))
    w = torch.where(keep, val.to(cdt), 0).float()
    return (w[..., None] * got.view(G, S, k, -1).float()).sum(2)


def experts(xin, params, activation, cdt):
    """Every expert's FFN over its buffer: xin (E, N, D) -> (E, N, D),
    one batched matmul a layer, in ``cdt``."""
    h = torch.bmm(xin, params["w1"].to(cdt)) + params["b1"].to(cdt)[:, None]
    if activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif activation == "relu":
        h = F.relu(h)
    else:
        raise MXNetError("unknown activation %r" % (activation,))
    return torch.bmm(h, params["w2"].to(cdt)) + params["b2"].to(cdt)[:, None]


def moe_ffn(x, params, *, n_experts, top_k=2, capacity_factor=1.25,
            mesh=None, activation="gelu", dtype=None):
    """MoE FFN: x (G, S, D) -> (y (G, S, D) in x's dtype, aux float32
    scalar).  G token groups of S tokens, each group routed on its own
    with ``C`` slots an expert (:func:`capacity`); a token slot past
    its expert's capacity adds nothing to y.  ``dtype`` is the compute
    dtype of the expert products (x's by default).  ``mesh``: None or a
    mesh whose axes all have size 1; a live axis raises ``not_ported``
    (expert parallelism)."""
    if mesh is not None:
        check_one_device(mesh, "moe_ffn")
    if top_k > n_experts:
        raise MXNetError("moe_ffn: top_k=%d > n_experts=%d (lower "
                         "expert_top_k or add experts)" % (top_k, n_experts))
    cdt = dtype or x.dtype
    xin, row, keep, val, aux = dispatch(x, params["router"], n_experts,
                                        top_k, capacity_factor, cdt)
    y = experts(xin, params, activation, cdt)
    out = combine(y.view(-1, x.shape[-1]), row, keep, val, cdt)
    return out.to(x.dtype), aux


def __getattr__(name):
    """The reference's sharding tables (``moe_param_specs``,
    ``moe_param_shardings``) come with expert parallelism."""
    if name.startswith("__"):
        raise AttributeError(name)
    raise not_ported("parallel.moe.%s" % name, "mxnet_tpu.parallel.moe")
