"""``mx.random``: seeding the generators the random ops draw from.

Port of ``mxnet_tpu/random.py``.  The reference threads a JAX key
through every random op; here a ``needs_rng`` op that ``invoke`` runs
draws from torch's default generator of its device (the CPU's, or each
card's), so seeding those generators seeds ``mx.nd.random_*``,
``Dropout`` and the samplers alike.  A hybridized block's CUDA graph
reads its device's default generator at every replay (torch registers
it with the graph), so each replay draws new values and a re-seed
repeats the sequence, as the reference's per-call key does
(``push_trace_key``).  A bound symbolic executor keeps generators of
its own, seeded from the default generator when it is bound.
"""
from __future__ import annotations

import torch

from .context import Context

__all__ = ["seed"]


def seed(seed_state, ctx="all"):
    """Seed the default generators: the CPU's and every card's with
    ``ctx="all"``, else the one of the given context."""
    seed_state = int(seed_state)
    if isinstance(ctx, str) and ctx == "all":
        torch.manual_seed(seed_state)      # the CPU's and every card's
        return
    if not isinstance(ctx, Context):
        raise TypeError("ctx must be 'all' or a Context, got %r" % (ctx,))
    if ctx.device_type == "cpu":
        torch.default_generator.manual_seed(seed_state)
    else:
        with torch.cuda.device(ctx.torch_device):   # raises without it
            torch.cuda.manual_seed(seed_state)
