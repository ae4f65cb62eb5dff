"""Continuous-batching (iteration-level) GPT decode engine over a paged
KV pool.  Port of ``mxnet_tpu/serving/engine.py`` with its serial
schedule.

Each step feeds one fixed-shape batch of ``n_rows = num_slots +
prefill_chunk`` token rows, each row a (token, slot, position): every
running request contributes one decode row, freshly admitted requests
contribute up to ``prefill_chunk`` prompt rows (chunked prefill), and
leftover rows are dead padding aimed at the scratch page.  The step
writes every row's k/v into the pools, attends through
``kernels/paged_attention.py`` (the CUDA kernel on the card, its plain
version on the CPU) and reads the greedy argmax at each slot's last
live row.

Scheduling is host-side Python, as in the reference: retire finished
requests and recycle their pages; admit queued requests while the pool
covers their prompt (+1 decode) pages; top up pages as sequences cross
a page boundary, preempting the YOUNGEST running request when the pool
is dry (it re-prefills its committed tokens on re-admission, which
under greedy decode is exact); build the row batch, run the step,
commit the sampled tokens.  The step's inputs travel in one static
int32 buffer (one host-to-device copy a step), and on the card the step
is one CUDA graph, captured at the first step and replayed after, as
the reference compiles it once with ``jax.jit``.

Under float32 greedy decode the outputs are token-identical to
``models/gpt.py generate`` (the port's and the reference's), whatever
the batch mix, admission order, page reuse or preemption.

Not ported yet (the constructor raises ``NotImplementedError``):
``prefix_cache``, ``tier_bytes``, ``spec_K > 0``, ``overlap``,
``tp > 1``/``mesh`` and ``metrics``.  The engine is single-threaded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .._graphs import GraphCache, Program, warm_up
from ..kernels.paged_attention import paged_attention
from ..models import gpt as G
from ..models.transformer import _layer_norm, torch_dtype
from .paged_kv import PagedKVCache

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    """One generation request and its in-flight bookkeeping."""
    rid: int
    prompt: np.ndarray                    # (P,) int32, immutable
    max_new_tokens: int
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"                 # queued|running|done|cancelled
    slot: Optional[int] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    n_prefilled: int = 0                  # input rows already fed
    n_cached: int = 0                     # positions written to cache
    pending: Optional[int] = None         # sampled, not yet in cache

    @property
    def resume_input(self):
        """Prefill source: prompt + committed tokens (after a
        preemption the whole committed sequence re-prefills)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def output(self):
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])


def _step(params, cfg, pools, tokens, row_slot, row_pos, row_live, bt,
          slot_rows, page_size):
    """The fixed-shape unified prefill+decode step (the body of the
    reference's ``_make_step``; on the card the engine replays it as
    one CUDA graph, ``ServingEngine._program``).  Scatters every row's
    k/v into ``pools`` IN PLACE (the reference donates the pools to the
    jitted step; here the engine owns them) before attending, so each
    row sees its own k/v.  Returns the (S, 1) argmax tokens."""
    cdt = torch_dtype(cfg.dtype)
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    T = tokens.shape[0]
    rpos = row_pos.long()

    x = G._embed(params, tokens.long(), cdt) + params["pos_emb"][rpos]
    x = _layer_norm(x, params["emb_ln"]["g"], params["emb_ln"]["b"])
    # dead rows write to the scratch page and read garbage the host
    # never looks at; bt carries one extra all-zero row (index
    # num_slots) that dead rows point at, so they touch only page 0
    slot = row_slot.long()
    page = torch.where(row_live != 0, bt[slot, rpos // page_size],
                       torch.zeros_like(row_pos)).long()
    off = rpos % page_size
    row_pages = bt[slot]                               # (T, PP) int32

    for layer, pool in zip(params["layers"], pools):
        def attend(qkv):
            q, k, v = (qkv[:, i * D:(i + 1) * D].reshape(T, H, dh)
                       for i in range(3))
            if "s" in pool:
                kvq, skv = G._kv_quantize(k, v)        # (T,H,2dh), (T,H,2)
                pool["kv"][page, off] = kvq
                # scale planes (pages, 2, ps, H): row r's pair lands
                # at [page_r, :, off_r]
                pool["s"][page, :, off] = skv.transpose(1, 2)
            else:
                pool["kv"][page, off] = torch.cat([k, v], dim=-1)
            attn = paged_attention(q.contiguous(), pool["kv"],
                                   pool.get("s"), row_pages, row_pos,
                                   page_size=page_size)
            return attn.to(cdt).reshape(T, D)

        x = G._layer(layer, x, attend)
    logits = G._lm_head(params, x, cdt)                # (T, V) f32
    return torch.argmax(logits[slot_rows.long()], dim=-1)


class _StepBuffers:
    """The step inputs, packed in ONE int32 buffer: a host copy the
    scheduler fills (pinned on CUDA) and a static device copy that one
    host-to-device ``copy_`` a step refreshes.  The step reads six
    views of the device copy, so a captured step replays on new
    inputs."""

    def __init__(self, n_rows, num_slots, pages_per_slot, device):
        T, S, PP = n_rows, num_slots, pages_per_slot
        n = 4 * T + S + (S + 1) * PP
        self.host = torch.zeros(n, dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        self.dev = torch.zeros(n, dtype=torch.int32, device=device)
        f = self.flat = self.host.numpy()
        self.tokens = f[0:T]
        self.row_slot = f[T:2 * T]
        self.row_pos = f[2 * T:3 * T]
        self.row_live = f[3 * T:4 * T]
        self.slot_rows = f[4 * T:4 * T + S]
        self.bt = f[4 * T + S:].reshape(S + 1, PP)
        d = self.dev
        # (tokens, row_slot, row_pos, row_live, bt, slot_rows), as
        # _step takes them
        self.views = (d[0:T], d[T:2 * T], d[2 * T:3 * T], d[3 * T:4 * T],
                      d[4 * T + S:].view(S + 1, PP), d[4 * T:4 * T + S, None])
        self.shape = (T, S, PP)

    def reset(self, num_slots):
        self.flat[:4 * self.shape[0] + num_slots] = 0
        self.row_slot.fill(num_slots)

    def stage(self):
        """Copy the host buffer into the device buffer (asynchronous
        from pinned memory; the step's token read-back orders the next
        refill after it)."""
        self.dev.copy_(self.host, non_blocking=True)

    def stage_dead(self, num_slots):
        """Fill the device buffer with an all-dead row batch (every row
        aimed at the all-scratch block-table row ``num_slots``), on the
        device, leaving the host buffer alone."""
        T = self.shape[0]
        self.dev.zero_()
        self.dev[T:2 * T].fill_(num_slots)


class _Plan:
    """One built step: its buffers and what the commit needs."""

    def __init__(self, buf):
        self.buf = buf
        self.samplers = []          # requests sampling a token
        self.decode_pos = {}        # rid -> its sampling row's pos
        self.prefill_mid = []       # (req, n_prefilled) mid-prefill


class ServingEngine:
    """Continuous-batching greedy decode over a ``PagedKVCache``.

    Parameters
    ----------
    params, cfg : GPT decode params (float, or ``quantize_decode_params``
        weight-only int8) and config — the same formats as ``generate``.
        The weights are cast to the compute dtype once, here.
    num_slots : concurrent sequences per iteration.
    page_size : tokens per KV page.
    num_pages : pool capacity; default ``num_slots * pages_per_slot + 1``.
    pages_per_slot : per-request length cap in pages; default covers
        ``cfg.max_len``.
    prefill_chunk : prompt rows fed per iteration.
    kv_int8 : int8 KV pages with f32 scale planes.
    device : where the engine runs; None means the CUDA device (and
        raises without one), ``"cpu"`` runs the plain versions.
    """

    def __init__(self, params, cfg, *, num_slots, page_size=16,
                 num_pages=None, pages_per_slot=None, prefill_chunk=8,
                 kv_int8=False, device=None, prefix_cache=False,
                 tier_bytes=None, spec_K=0, overlap=None, tp=1,
                 mesh=None, metrics=None):
        unported = {"prefix_cache": bool(prefix_cache),
                    "tier_bytes": bool(tier_bytes),
                    "spec_K": spec_K != 0, "overlap": bool(overlap),
                    "tp": tp != 1, "mesh": mesh is not None,
                    "metrics": bool(metrics)}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(
                    "ServingEngine: %s is not ported to mxnet_tpu_torch "
                    "yet (ROADMAP.md)" % name)
        if not cfg.causal:
            cfg = dataclasses.replace(cfg, causal=True)
        if num_slots < 1:
            raise ValueError("ServingEngine: num_slots must be >= 1")
        if prefill_chunk < 1:
            raise ValueError("ServingEngine: prefill_chunk must be >= 1")
        self.device = resolve_device(device)
        if pages_per_slot is None:
            pages_per_slot = -(-cfg.max_len // page_size)
        if num_pages is None:
            num_pages = num_slots * pages_per_slot + 1
        if num_pages < pages_per_slot + 1:
            raise ValueError(
                "ServingEngine: num_pages (%d) cannot hold one "
                "max-length request (%d pages + scratch)"
                % (num_pages, pages_per_slot))
        with torch.inference_mode():
            self.params = G.prepare_params(params, cfg, self.device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.prefill_chunk = prefill_chunk
        self.kv_int8 = bool(kv_int8)
        self.max_seq = pages_per_slot * page_size
        self.n_rows = num_slots + prefill_chunk
        self.cache = PagedKVCache(cfg, num_pages, page_size,
                                  kv_int8=self.kv_int8, device=self.device)
        self._queue: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._next_rid = 0
        self.requests: Dict[int, Request] = {}
        self.stats = {"steps": 0, "preemptions": 0, "admitted": 0,
                      "decode_rows": 0, "prefill_rows": 0,
                      "dead_rows": 0, "peak_pages": 0}
        self._buf = _StepBuffers(self.n_rows, num_slots, pages_per_slot,
                                 self.device)
        self._graphs = GraphCache(self.device)
        self._eager = False        # True: run _step op by op (comparisons)
        # canonical block table, patched at page alloc/free; row
        # num_slots stays all-scratch for dead rows
        self._bt = np.zeros((num_slots + 1, pages_per_slot), np.int32)

    # ------------------------------------------------------- intake --
    def submit(self, prompt, max_new_tokens, eos_id=None):
        """Queue a request; returns its id.  prompt: (P,) ints."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("submit: empty prompt")
        if max_new_tokens < 1:
            raise ValueError("submit: max_new_tokens must be >= 1")
        total = prompt.size + max_new_tokens
        if total > self.max_seq:
            raise ValueError("submit: %d tokens > engine max_seq %d "
                             "(pages_per_slot * page_size)"
                             % (total, self.max_seq))
        if total > self.cfg.max_len:
            raise ValueError("submit: %d tokens > cfg.max_len=%d"
                             % (total, self.cfg.max_len))
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), eos_id=eos_id)
        self._next_rid += 1
        self.requests[req.rid] = req
        self._queue.append(req)
        return req.rid

    def cancel(self, rid):
        """Force-retire a request, freeing its slot and pages now; a
        cancel after completion is a no-op."""
        req = self.requests[rid]
        if req.state in ("done", "cancelled"):
            return
        if req.state == "queued":
            self._queue.remove(req)
        elif req.state == "running":
            self._release(req)
        req.state = "cancelled"

    def preempt(self, rid):
        """Force-preempt one RUNNING request (recompute on resume).
        Returns False: there is no host tier to swap pages into."""
        req = self.requests[rid]
        if req.state != "running":
            raise ValueError("preempt(%d): request is %s, not running"
                             % (rid, req.state))
        self._preempt_victim(req)
        return False

    # ----------------------------------------------------- plumbing --
    def _bt_set(self, slot, pages):
        row = self._bt[slot]
        n = min(len(pages), row.size)
        row[:n] = pages[:n]
        row[n:] = 0

    def _release(self, req):
        if req.slot is not None:
            self._bt[req.slot, :] = 0
        if req.pages:
            self.cache.free(req.pages)
            req.pages = []
        if req.slot is not None:
            self._slots[req.slot] = None
            req.slot = None

    def _preempt_for(self, req):
        """Preempt the youngest running request other than ``req``;
        True if one was preempted."""
        victims = [r for r in self._slots if r is not None and r is not req]
        if not victims:
            return False
        self._preempt_victim(max(victims, key=lambda r: r.rid))
        return True

    def _preempt_victim(self, victim):
        """Evict ``victim`` from its slot and requeue it at the front."""
        self._release(victim)
        victim.state = "queued"
        victim.n_prefilled = 0
        victim.n_cached = 0
        victim.pending = None
        self._queue.insert(0, victim)
        self.stats["preemptions"] += 1

    def _ensure_page(self, req, pos):
        """Make req's block table cover position pos (allocating, or
        preempting another request when the pool is dry)."""
        idx = pos // self.page_size
        grew = idx >= len(req.pages)
        while idx >= len(req.pages):
            got = self.cache.alloc(1)
            if got is None:
                if not self._preempt_for(req):
                    raise RuntimeError(
                        "ServingEngine: page pool exhausted by a single "
                        "request — grow num_pages")
                continue
            req.pages.extend(got)
        if grew and req.slot is not None:
            self._bt_set(req.slot, req.pages)

    def _admit(self):
        while self._queue:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                return
            req = self._queue[0]
            inp = req.resume_input
            got = self.cache.alloc(
                -(-min(inp.size + 1, self.max_seq) // self.page_size))
            if got is None:
                return                     # stall admission, not decode
            self._queue.pop(0)
            req.pages = got
            req.slot = free[0]
            req.state = "running"
            req.n_prefilled = 0
            req.n_cached = 0
            req.pending = None
            self._slots[req.slot] = req
            self._bt_set(req.slot, req.pages)
            self.stats["admitted"] += 1

    # --------------------------------------------------------- step --
    def _build_plan(self):
        """Admission, page allocation and the fixed-shape row batch.
        All allocation (which may preempt) happens before any row is
        built, so no built row can target a page freed later."""
        self._admit()
        for req in list(self._slots):
            if req is not None and req.pending is not None:
                self._ensure_page(req, req.n_cached)
        budget = self.prefill_chunk
        pre = {}
        for req in list(self._slots):
            if req is None or req.pending is not None or budget <= 0:
                continue
            n = min(budget, req.resume_input.size - req.n_prefilled)
            if (req.n_prefilled + n - 1) // self.page_size >= len(req.pages):
                raise RuntimeError("ServingEngine: prefill rows past the "
                                   "admitted pages")
            pre[req.rid] = n
            budget -= n

        buf = self._buf
        buf.reset(self.num_slots)
        np.copyto(buf.bt, self._bt)
        plan = _Plan(buf)
        r = 0
        for req in list(self._slots):      # decode rows
            if req is None or req.pending is None:
                continue
            buf.tokens[r] = req.pending
            buf.row_slot[r] = req.slot
            buf.row_pos[r] = req.n_cached
            buf.row_live[r] = 1
            buf.slot_rows[req.slot] = r
            plan.samplers.append(req)
            plan.decode_pos[req.rid] = req.n_cached
            self.stats["decode_rows"] += 1
            r += 1
        for req in list(self._slots):      # chunked prefill rows
            if req is None or req.pending is not None:
                continue
            inp = req.resume_input
            sampled = False
            for _ in range(pre.get(req.rid, 0)):
                p = req.n_prefilled
                buf.tokens[r] = inp[p]
                buf.row_slot[r] = req.slot
                buf.row_pos[r] = p
                buf.row_live[r] = 1
                req.n_prefilled += 1
                self.stats["prefill_rows"] += 1
                if req.n_prefilled == inp.size:
                    buf.slot_rows[req.slot] = r
                    plan.samplers.append(req)
                    plan.decode_pos[req.rid] = p
                    sampled = True
                r += 1
            if not sampled:
                plan.prefill_mid.append((req, req.n_prefilled))
        self.stats["dead_rows"] += self.n_rows - r
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.cache.pages_in_use)
        return plan

    def _step_body(self):
        buf = self._buf
        return _step(self.params, self.cfg, self.cache.pools, *buf.views,
                     self.page_size)

    def _program(self):
        """The step as one :class:`Program` over the static buffers,
        made at the first dispatch (the reference's ``_step_cache``
        entry: the shape is fixed per engine).  On CUDA it is warmed up
        on an all-dead row batch, which writes only scratch page 0,
        and captured in inference mode, the mode it replays in; the
        pools are captured in place (the reference donates them)."""
        prog = self._graphs.get("step")
        if prog is None:
            if self.device.type == "cuda":
                self._buf.stage_dead(self.num_slots)
                warm_up(self._step_body)
            prog = self._graphs.put("step", Program(
                self._step_body, self.device, self._graphs.pool()))
        return prog

    def _dispatch(self, plan):
        """Stage the plan with one host-to-device copy, run the step
        (replay the captured one, or op by op when ``_eager``), and
        read the sampled tokens back (the one sync per step)."""
        with torch.inference_mode():
            run = self._step_body if self._eager else self._program()
            plan.buf.stage()
            tok = run()
        return tok.cpu().numpy()

    def _commit(self, plan, next_tok):
        """Consume the step's sampled tokens: stop conditions, retire."""
        self.stats["steps"] += 1
        finished = []
        for req in plan.samplers:
            if req.slot is None or req.state != "running":
                continue
            req.n_cached = plan.decode_pos[req.rid] + 1
            tok = int(next_tok[req.slot, 0])
            req.generated.append(tok)
            req.pending = tok
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)):
                req.state = "done"
                self._release(req)
                finished.append(req.rid)
        for req, p1 in plan.prefill_mid:
            if req.slot is not None and req.state == "running":
                req.n_cached = max(req.n_cached, p1)
        return finished

    def step(self):
        """One engine iteration: the ids of requests that finished in
        it (possibly empty), or False when there is nothing to do."""
        if not self._queue and all(r is None for r in self._slots):
            return False
        plan = self._build_plan()
        return self._commit(plan, self._dispatch(plan))

    def run(self):
        """Step until every submitted request is done or cancelled.
        Returns {rid: (P + generated,) int32} for the done ones."""
        while self.step() is not False:
            pass
        return {rid: req.output for rid, req in self.requests.items()
                if req.state == "done"}
