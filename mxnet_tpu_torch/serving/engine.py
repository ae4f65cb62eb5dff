"""Continuous-batching (iteration-level) GPT decode engine over a paged
KV pool.  Port of ``mxnet_tpu/serving/engine.py``.

Each step feeds one fixed-shape batch of ``n_rows = num_slots * (1 +
spec_K) + prefill_chunk`` token rows, each row a (token, slot,
position): every running request contributes one decode row (plus up
to ``spec_K`` draft rows), freshly admitted requests contribute up to
``prefill_chunk`` prompt rows (chunked prefill), and leftover rows are
dead padding aimed at the scratch page.  The step writes every row's
k/v into the pools, attends through ``kernels/paged_attention.py`` (the
CUDA kernel on the card, its plain version on the CPU) and reads the
greedy argmax at each slot's sampling and draft rows.

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

Options, with the reference's semantics:

* ``prefix_cache=True`` (``serving/prefix_cache.py``): prompts that
  match cached chains map those pages read-only and skip their prefill
  rows; completed prompt pages are donated back; refcount-0 chains are
  evicted under pool pressure (the allocator's ``pressure_cb``).  Where
  a request's first write falls inside a mapped page, that page is
  copied on write (``PagedKVCache.copy_page``, in place, on the
  engine's stream, before the step that reads the copy: the captured
  step keeps reading the same storage).
* ``spec_K=K``: each running decode slot feeds its pending token plus
  K drafted rows (``spec_drafter="ngram"``, ``serving/drafters.py``, or
  a callable); the one step verifies every row against its own
  argmaxes, accepted tokens commit by advancing ``n_cached`` over k/v
  already written, and rejections roll back by pointer only.
* ``overlap=True`` (or ``MXNET_SERVE_OVERLAP=1``): the step takes a
  per-row ``tok_src`` selector, so a decode row's input token can come
  from the PREVIOUS step's argmax on the device, and a planner thread
  builds step N+1 (admission, prefix match, pages, rows) into the
  second host buffer set while step N runs; the host commits one step
  behind.  A stop, eos, cancel or preemption that invalidates the
  step already dispatched reconciles exactly (its rows land past every
  committed position), and a step that drafts runs serially (the
  speculation fence: drafting reads committed host tokens).  The
  planner touches host state only: copy-on-write copies it plans run
  on the engine thread at dispatch.

Under float32 greedy decode the outputs are token-identical to
``models/gpt.py generate`` (the port's and the reference's), whatever
the options, drafter, batch mix, admission order, page reuse or
preemption.

Not ported yet (the constructor raises ``NotImplementedError``):
``tier_bytes``, ``tp > 1``/``mesh``, ``metrics`` and ``kernel``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .._graphs import GraphCache, Program, warm_up
from ..kernels.paged_attention import paged_attention
from ..models import gpt as G
from ..models.transformer import _layer_norm, torch_dtype
from . import drafters
from .paged_kv import PagedKVCache
from .prefix_cache import PrefixCache

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
    # shared-prefix bookkeeping (empty without a prefix cache)
    prefix_entries: List[Any] = dataclasses.field(default_factory=list)
    shared_pages: set = dataclasses.field(default_factory=set)
    chain_upto: int = 0                   # leading pages known to cache
    prefix_hit_tokens: int = 0            # prefill rows skipped via hits

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
          slot_rows, page_size, tok_src=None, prev_tok=None):
    """The fixed-shape unified prefill+decode step (the body of the
    reference's ``_make_step``; on the card the engine replays it as
    one CUDA graph, ``ServingEngine._program``).  Scatters every row's
    k/v into ``pools`` IN PLACE (the reference donates the pools to the
    jitted step; here the engine owns them) before attending, so each
    row sees its own k/v.  Returns the (S, 1 + spec_K) argmax tokens:
    column 0 at each slot's sampling row, the others at its draft rows.

    With ``tok_src`` (overlap), row r's input token is ``prev_tok[
    tok_src[r], 0]`` where ``tok_src[r] >= 0`` (the previous step's
    argmax, on the device) and ``tokens[r]`` elsewhere: an exact
    integer select, so a carried step computes what the serial schedule
    feeding the same token computes."""
    cdt = torch_dtype(cfg.dtype)
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    T = tokens.shape[0]
    rpos = row_pos.long()
    tokens = tokens.long()
    if tok_src is not None:
        S = prev_tok.shape[0]
        tokens = torch.where(tok_src >= 0,
                             prev_tok[tok_src.clamp(0, S - 1).long(), 0],
                             tokens)

    x = G._embed(params, tokens, cdt) + params["pos_emb"][rpos]
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
    """One set of host-side step inputs, packed in ONE int32 buffer
    (pinned on CUDA) that one host-to-device ``copy_`` a step moves into
    the engine's static device buffer.  The engine owns two sets and
    rotates: while step N (staged from one set) runs, step N+1 is built
    into the other.  ``copied`` is the CUDA event recorded after the
    last copy out of this set: the set is refilled only once it has
    passed (:meth:`wait_free`)."""

    def __init__(self, n_rows, num_slots, n_sample, pages_per_slot,
                 pinned):
        T, S, PP = n_rows, num_slots, pages_per_slot
        self.layout = (T, S, n_sample, PP)
        self.host = torch.zeros(self.size(*self.layout), dtype=torch.int32,
                                pin_memory=pinned)
        f = self.flat = self.host.numpy()
        self.tokens, self.row_slot, self.row_pos, self.row_live, \
            self.tok_src, self.slot_rows, self.bt = self.views(f,
                                                               *self.layout)
        self.copied = None

    @staticmethod
    def size(T, S, n_sample, PP):
        return 5 * T + S * n_sample + (S + 1) * PP

    @staticmethod
    def views(flat, T, S, n_sample, PP):
        """(tokens, row_slot, row_pos, row_live, tok_src, slot_rows
        (S, n_sample), bt (S + 1, PP)) over ``flat`` (numpy or torch)."""
        o = 5 * T + S * n_sample
        return (flat[0:T], flat[T:2 * T], flat[2 * T:3 * T],
                flat[3 * T:4 * T], flat[4 * T:5 * T],
                flat[5 * T:o].reshape(S, n_sample),
                flat[o:].reshape(S + 1, PP))

    def reset(self, num_slots):
        T, S, ns, _ = self.layout
        self.flat[:5 * T + S * ns] = 0
        self.row_slot.fill(num_slots)
        self.tok_src.fill(-1)

    def stage(self, dev):
        """Copy this set into the device buffer ``dev`` (asynchronous
        from pinned memory) and record ``copied``."""
        dev.copy_(self.host, non_blocking=True)
        if dev.is_cuda:
            self.copied = torch.cuda.Event()
            self.copied.record()

    def wait_free(self):
        """Wait until no copy out of this set is pending (the wait
        releases the interpreter lock)."""
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None


class _Readback:
    """A dispatched step's sampled tokens: two host buffers (pinned on
    CUDA) that the device's argmax matrix is copied into asynchronously,
    in turns, each with the event recorded after its copy.  Under
    overlap step N+1 is enqueued before step N's tokens are read, so
    N's copy must land in a buffer N+1's does not touch."""

    def __init__(self, num_slots, n_sample, device):
        self.host = torch.zeros(2, num_slots, n_sample, dtype=torch.int64,
                                pin_memory=device.type == "cuda")
        self._i = 0

    def put(self, tok):
        """Start copying ``tok`` to the host; returns a callable that
        waits for the copy and gives the (S, n_sample) numpy array."""
        h = self.host[self._i]
        self._i ^= 1
        h.copy_(tok, non_blocking=True)
        ev = None
        if tok.is_cuda:
            ev = torch.cuda.Event()
            ev.record()

        def wait():
            if ev is not None:
                ev.synchronize()         # releases the interpreter lock
            return h.numpy()

        return wait


class _Plan:
    """One built step: the row batch plus everything the commit needs,
    recorded AT BUILD TIME.  Under overlap the commit runs one step
    after the build, once the planner has advanced ``n_prefilled`` for
    the next plan, so commits read these records, never live scheduler
    positions."""

    __slots__ = ("buf", "samplers", "spec_plan", "decode_pos",
                 "was_decode", "prefill_mid", "copies", "fenced", "empty",
                 "pipelined")

    def __init__(self):
        self.buf = None
        self.samplers = []          # requests sampling a token
        self.spec_plan = {}         # rid -> drafts (serial plans only)
        self.decode_pos = {}        # rid -> its sampling row's pos
        self.was_decode = {}        # rid -> fed a decode row?
        self.prefill_mid = []       # (req, n_prefilled) mid-prefill
        self.copies = []            # (src, dst) copy-on-write pages
        self.fenced = False         # spec fence: nothing built
        self.empty = True           # no live rows
        self.pipelined = False      # built for the overlap path


def _planner_main(engine_ref, ctl, go, ready):
    """Overlap planner thread body.  A module-level function holding a
    WEAK engine reference (a bound-method target would keep the engine
    alive and its finalizer could never run).  The engine thread sets
    ``go`` after each commit; the planner builds the next plan under
    the engine lock, hands it over in ``_plan`` (an exception raised by
    the build is handed over in its place, for the engine thread to
    raise) and sets ``ready``."""
    while True:
        go.wait()
        go.clear()
        if ctl["stop"]:
            return
        eng = engine_ref()
        if eng is None:
            return
        try:
            with eng._mu:
                plan = eng._build_plan(overlap=True)
        except Exception as e:   # re-raised on the engine thread
            plan = e
        eng._plan = plan
        ready.set()
        del eng


def _stop_planner(ctl, go):
    """weakref.finalize target: unpark and retire the planner when the
    engine is collected (holds the control dict and event, never the
    engine)."""
    ctl["stop"] = True
    go.set()


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
    prefix_cache : refcounted shared-prefix page reuse (module docstring).
    spec_K : draft rows per decode slot and step (0: no speculation).
    spec_drafter : ``"ngram"`` (prompt lookup over the row's committed
        tokens) or a callable ``f(tokens (n,), K) -> (K,)``.
    spec_ngram : n-gram length of the ngram drafter.
    overlap : pipelined scheduling with a planner thread; None reads
        ``MXNET_SERVE_OVERLAP`` (on when "1").  ``close()`` joins the
        thread.
    device : where the engine runs; None means the CUDA device (and
        raises without one), ``"cpu"`` runs the plain versions.
    """

    def __init__(self, params, cfg, *, num_slots, page_size=16,
                 num_pages=None, pages_per_slot=None, prefill_chunk=8,
                 kv_int8=False, prefix_cache=False, spec_K=0,
                 spec_drafter="ngram", spec_ngram=2, overlap=None,
                 device=None, tier_bytes=None, tp=1, mesh=None,
                 metrics=None, kernel=None):
        unported = {"tier_bytes": bool(tier_bytes), "tp": tp != 1,
                    "mesh": mesh is not None, "metrics": bool(metrics),
                    "kernel": kernel is not None}
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
        if spec_K < 0:
            raise ValueError("ServingEngine: spec_K must be >= 0")
        if spec_drafter != "ngram" and not callable(spec_drafter):
            raise ValueError("ServingEngine: spec_drafter must be "
                             "'ngram' or a callable")
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
        if overlap is None:
            overlap = os.environ.get("MXNET_SERVE_OVERLAP", "0") == "1"
        with torch.inference_mode():
            self.params = G.prepare_params(params, cfg, self.device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.prefill_chunk = prefill_chunk
        self.kv_int8 = bool(kv_int8)
        self.spec_K = int(spec_K)
        self.spec_drafter = spec_drafter
        self.spec_ngram = int(spec_ngram)
        self.overlap = bool(overlap)
        self.max_seq = pages_per_slot * page_size
        # every decode slot may feed 1 + K rows (pending + drafts); the
        # step's shape stays fixed, unused rows are dead padding
        self.n_rows = num_slots * (1 + self.spec_K) + prefill_chunk
        self.cache = PagedKVCache(cfg, num_pages, page_size,
                                  kv_int8=self.kv_int8, device=self.device)
        self.prefix = PrefixCache(self.cache) if prefix_cache else None
        if self.prefix is not None:
            self.cache.pressure_cb = self.prefix.evict
            # the reference compiles its copy program here; the port's
            # first copy (scratch onto scratch) runs here likewise
            self.cache.copy_page(0, 0)
        self._queue: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._next_rid = 0
        self.requests: Dict[int, Request] = {}
        self.stats = {"steps": 0, "preemptions": 0, "admitted": 0,
                      "decode_rows": 0, "prefill_rows": 0,
                      "dead_rows": 0, "peak_pages": 0,
                      "prefix_hit_tokens": 0, "cow_copies": 0,
                      "spec_drafted": 0, "spec_accepted": 0,
                      "host_hidden_ms": 0.0, "overlap_steps": 0,
                      "overlap_fences": 0}
        # One lock guards everything both the engine thread and the
        # planner thread touch: queue, slots, pages, prefix cache,
        # stats and the request fields they change.  The plan handoff
        # (_plan, _plan_pending, _inflight*) is engine-thread-owned or
        # sequenced by the _plan_go/_plan_ready pair, outside the lock.
        self._mu = threading.Lock()
        n_sample = 1 + self.spec_K
        layout = (self.n_rows, num_slots, n_sample, pages_per_slot)
        pinned = self.device.type == "cuda"
        self._bufs = (_StepBuffers(*layout, pinned),
                      _StepBuffers(*layout, pinned))
        self._buf_idx = 0
        self._dev = torch.zeros(_StepBuffers.size(*layout),
                                dtype=torch.int32, device=self.device)
        self._views = _StepBuffers.views(self._dev, *layout)
        # overlap: the step reads the previous step's argmaxes from, and
        # writes its own into, this one static tensor (zeros before the
        # first step, as the reference's _tok0)
        self._tok_out = torch.zeros(num_slots, n_sample, dtype=torch.int64,
                                    device=self.device) \
            if self.overlap else None
        self._readback = _Readback(num_slots, n_sample, self.device)
        self._graphs = GraphCache(self.device)
        self._eager = False        # True: run _step op by op (comparisons)
        # canonical block table, patched at page alloc/free; row
        # num_slots stays all-scratch for dead rows
        self._bt = np.zeros((num_slots + 1, pages_per_slot), np.int32)
        self._inflight = None        # _Plan currently on the device
        self._inflight_tok = None    # its token read-back
        self._plan = None            # planner -> engine handoff slot
        self._plan_pending = False   # engine-thread-only flag
        self._plan_go = threading.Event()
        self._plan_ready = threading.Event()
        self._planner = None         # spawned at the first overlap step
        self._planner_ctl = None
        self._finalizer = None

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
        with self._mu:
            req = Request(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=int(max_new_tokens), eos_id=eos_id)
            self._next_rid += 1
            self.requests[req.rid] = req
            self._queue.append(req)
            return req.rid

    def cancel(self, rid):
        """Force-retire a request, freeing its slot and pages now; a
        cancel after completion is a no-op."""
        with self._mu:
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
        with self._mu:
            req = self.requests[rid]
            if req.state != "running":
                raise ValueError("preempt(%d): request is %s, not running"
                                 % (rid, req.state))
            self._preempt_victim(req)
            return False

    # ----------------------------------------------------- plumbing --
    # (every helper below changes state the planner thread also reads
    # and writes: callers hold the engine lock)

    def _bt_set(self, slot, pages):
        row = self._bt[slot]
        n = min(len(pages), row.size)
        row[:n] = pages[:n]
        row[n:] = 0

    def _release(self, req):
        if req.slot is not None:
            self._bt[req.slot, :] = 0
        if req.pages:
            # cache-owned pages stay cached (their refs drop below);
            # only private pages return to the pool
            self.cache.free([p for p in req.pages
                             if p not in req.shared_pages])
            req.pages = []
        if req.prefix_entries:
            self.prefix.release(req.prefix_entries)
            req.prefix_entries = []
        req.shared_pages = set()
        req.chain_upto = 0
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

    def _insert_prefix(self, req):
        """Donate req's completed pages, fully covered by its prompt, to
        the prefix cache, so later requests sharing the prefix skip
        their prefill."""
        upto = min(req.prompt.size, req.n_cached) // self.page_size
        if upto <= req.chain_upto:
            return
        new = self.prefix.insert_chain(req.prompt, req.pages, upto,
                                       from_page=req.chain_upto)
        for j, entry in new:
            req.shared_pages.add(req.pages[j])
            req.prefix_entries.append(entry)
        req.chain_upto = upto

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

    def _admit(self, copies):
        """Admit queued requests into free slots while the pool covers
        them; copy-on-write page pairs go to ``copies`` (the plan's),
        run at dispatch."""
        while self._queue:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                return
            req = self._queue[0]
            inp = req.resume_input
            total = -(-min(inp.size + 1, self.max_seq) // self.page_size)
            # shared-prefix match: map cached pages read-only, skip their
            # prefill rows; always re-feed at least the final input
            # token (the step needs one live row at the end of the input
            # to produce this request's logits)
            entries, hit_pages, m_tok = ([], [], 0) \
                if self.prefix is None else self.prefix.match(inp)
            skip = min(m_tok, inp.size - 1)
            cow_idx = skip // self.page_size
            cow = cow_idx < len(hit_pages)
            try:
                got = self.cache.alloc(total - len(hit_pages)
                                       + (1 if cow else 0))
            except BaseException:
                # alloc can raise through the pressure callback: the
                # refs match() just took must not leak, or the chain
                # stays pinned for the engine's lifetime
                if entries:
                    self.prefix.release(entries)
                raise
            if got is None:
                if entries:
                    self.prefix.release(entries)
                return                     # stall admission, not decode
            self._queue.pop(0)
            req.pages = list(hit_pages)
            req.shared_pages = set(hit_pages)
            req.prefix_entries = entries
            if cow:
                # the first position this request writes falls inside the
                # last mapped page (a partial-page match, or a whole-input
                # match re-feeding its final token): copy it into a
                # private page before any row targets it
                if cow_idx != len(hit_pages) - 1:
                    raise RuntimeError("ServingEngine: copy-on-write "
                                       "page is not the last mapped one")
                priv = got.pop()
                copies.append((hit_pages[cow_idx], priv))
                req.pages[cow_idx] = priv
                req.shared_pages.discard(hit_pages[cow_idx])
                self.prefix.release([req.prefix_entries.pop()])
                self.stats["cow_copies"] += 1
            req.chain_upto = len(req.prefix_entries)
            req.pages.extend(got)
            if self.prefix is not None:
                self.stats["prefix_hit_tokens"] += skip
                req.prefix_hit_tokens = skip
            req.slot = free[0]
            req.state = "running"
            req.n_prefilled = skip
            req.n_cached = skip
            req.pending = None
            self._slots[req.slot] = req
            self._bt_set(req.slot, req.pages)
            self.stats["admitted"] += 1

    def _plan_speculation(self):
        """Phase-A speculation planning: for every running decode row
        propose K_eff = min(spec_K, tokens the request may still commit)
        drafts and secure pages through the deepest draft position (so
        no draft lands past the request's admitted budget).  Returns
        {rid: drafts (K_eff,) int32}.  MUST run before any row is built:
        ``_ensure_page`` may preempt."""
        plan = {}
        if self.spec_K < 1:
            return plan
        vmax = self.cfg.vocab_size - 1
        for req in list(self._slots):
            if req is None or req.pending is None:
                continue
            k_eff = min(self.spec_K, req.max_new_tokens - len(req.generated))
            if k_eff < 1:
                continue
            buf = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])
            if callable(self.spec_drafter):
                d = np.asarray(self.spec_drafter(buf, k_eff),
                               np.int32).reshape(-1)
                if d.size != k_eff:
                    raise ValueError(
                        "spec_drafter returned %d proposals, wanted %d"
                        % (d.size, k_eff))
                # clamp into the vocabulary: an out-of-range proposal
                # would be clamped by the lookup and verify as another
                # token
                d = np.clip(d, 0, vmax)
            else:
                d = drafters.ngram_draft(buf, k_eff, self.spec_ngram)
            self._ensure_page(req, req.n_cached + k_eff)
            # _ensure_page never preempts req itself, but may preempt a
            # later slot this loop already planned: the build skips
            # slot-less requests, so a stale entry is never fed
            plan[req.rid] = d
        return plan

    # --------------------------------------------------------- step --
    def step(self):
        """One engine iteration: the ids of requests whose commit landed
        in it (possibly empty), or False when there is nothing to do.
        Under overlap a request's finish is reported one call after the
        step that produced its last token."""
        return self._step_overlap() if self.overlap else self._step_serial()

    def _step_serial(self):
        """One serial iteration: build, dispatch, wait for the tokens,
        commit."""
        if not self._queue and all(r is None for r in self._slots):
            return False
        self._bufs[self._buf_idx].wait_free()
        with self._mu:
            plan = self._build_plan(overlap=False)
        next_tok = self._dispatch(plan)()
        with self._mu:
            return self._commit(plan, next_tok)

    def _step_overlap(self):
        """One pipelined iteration.  Call k: take plan k (planner-built
        while step k-1 ran, or built inline on a cold start), dispatch it
        against the in-flight step's tokens on the device, THEN wait for
        and commit step k-1; the commit of k-1 and the planner's build of
        k+1 both hide behind step k on the device."""
        self._ensure_planner()
        plan = self._take_plan()
        if plan is None:
            return False
        if plan.fenced:
            # speculation fence: drafting reads committed host tokens, so
            # drain the pipeline and run ONE serial step, then resume
            finished = []
            old, old_tok = self._inflight, self._inflight_tok
            self._inflight = None
            self._inflight_tok = None
            if old is not None:
                finished += self._drain(old, old_tok)
            out = self._step_serial()
            if out is not False:
                finished += out
            self._maybe_plan_ahead()
            return finished
        old, old_tok = self._inflight, self._inflight_tok
        if not plan.empty:
            self._inflight = plan
            self._inflight_tok = self._dispatch(plan)
        else:
            # nothing to dispatch (every live request rides the in-flight
            # step): just drain
            self._inflight = None
            self._inflight_tok = None
        finished = self._drain(old, old_tok) if old is not None else []
        self._maybe_plan_ahead()
        return finished

    def _take_plan(self):
        """The next plan: the planner's, if one was signalled, else one
        built inline under the lock (cold start, after a fence).  None
        means the engine is idle."""
        if self._plan_pending:
            self._plan_ready.wait()
            self._plan_ready.clear()
            self._plan_pending = False
            plan = self._plan
            self._plan = None
            if isinstance(plan, Exception):
                raise plan
            return plan
        self._bufs[self._buf_idx].wait_free()
        with self._mu:
            if self._inflight is None and not self._queue \
                    and all(r is None for r in self._slots):
                return None
            return self._build_plan(overlap=True)

    def _drain(self, plan, tok):
        """Wait for a dispatched step's tokens and commit it.  Under
        overlap this runs after the next step was dispatched."""
        next_tok = tok()
        with self._mu:
            return self._commit(plan, next_tok)

    def _maybe_plan_ahead(self):
        """Signal the planner to build the next plan while the step just
        dispatched runs."""
        with self._mu:
            work = bool(self._queue) or self._inflight is not None \
                or any(r is not None for r in self._slots)
        if work:
            self._bufs[self._buf_idx].wait_free()
            self._plan_pending = True
            self._plan_go.set()

    def _ensure_planner(self):
        """Spawn the planner thread (again after ``close()``).  A fresh
        control dict per spawn keeps a stale finalizer from stopping the
        new thread."""
        if self._planner is not None and self._planner.is_alive():
            return
        ctl = {"stop": False}
        self._planner_ctl = ctl
        self._plan_go.clear()
        t = threading.Thread(
            target=_planner_main,
            args=(weakref.ref(self), ctl, self._plan_go, self._plan_ready),
            daemon=True, name="serving-engine-planner")
        self._finalizer = weakref.finalize(self, _stop_planner, ctl,
                                           self._plan_go)
        self._planner = t
        t.start()

    def close(self):
        """Stop and join the planner thread (idempotent; a serial engine
        has none).  A plan the planner finished stays pending for the
        next step; one it never started is dropped."""
        ctl = self._planner_ctl
        t = self._planner
        self._planner = None
        self._planner_ctl = None
        if ctl is not None:
            ctl["stop"] = True
            self._plan_go.set()
        if t is not None and t.is_alive():
            t.join(timeout=30)
            if t.is_alive():
                raise RuntimeError("ServingEngine.close: the planner "
                                   "thread did not stop")
        if self._plan_pending and not self._plan_ready.is_set():
            self._plan_pending = False

    def _build_plan(self, overlap=False):
        """Admission, page allocation, speculation planning and the
        fixed-shape row batch, built into the next host buffer set and
        recorded as a ``_Plan``.  ``overlap=True`` also plans CARRIED
        decode rows for the in-flight step's samplers: their input token
        is that step's argmax on the device (``tok_src``), their position
        its sampling position + 1.  Touches host state only (it runs on
        the planner thread)."""
        t_b0 = time.perf_counter()
        hidden = overlap and self._inflight is not None
        plan = _Plan()
        plan.pipelined = bool(overlap)
        inflight = self._inflight if overlap else None
        if overlap and self.spec_K > 0 and (
                (inflight is not None and inflight.samplers)
                or any(r is not None and r.pending is not None
                       for r in self._slots)):
            # speculation fence: the drafters read req.generated, which
            # for an in-flight sampler is one token behind the device;
            # build nothing, the caller drains and runs a serial step
            plan.fenced = True
            self.stats["overlap_fences"] += 1
            return plan
        self._admit(plan.copies)

        # ---- phase A: secure pages.  _ensure_page may PREEMPT the
        # youngest running request, so all allocation happens before any
        # row is built (a victim preempted here has no rows this step)
        carried = {}                   # rid -> device-carried position
        if inflight is not None:
            for req in inflight.samplers:
                if req.slot is None or req.state != "running":
                    continue           # preempted or cancelled mid-flight
                if len(req.generated) + 1 >= req.max_new_tokens:
                    # the in-flight token finishes this request: its slot
                    # idles one step and retires at the drain
                    continue
                pos = inflight.decode_pos[req.rid] + 1
                self._ensure_page(req, pos)
                carried[req.rid] = pos
        inflight_rids = set() if inflight is None else \
            {req.rid for req in inflight.samplers}
        for req in list(self._slots):
            if req is not None and req.pending is not None \
                    and req.rid not in inflight_rids:
                self._ensure_page(req, req.n_cached)
        # drafting and draft-depth pages are phase A too (pipelined
        # builds reach here only with spec_K == 0 or no sampler)
        spec_plan = self._plan_speculation()
        plan.spec_plan = spec_plan
        budget = self.prefill_chunk
        pre = {}                           # rid -> prefill rows planned
        for req in list(self._slots):
            if req is None or req.pending is not None or budget <= 0:
                continue
            n = min(budget, req.resume_input.size - req.n_prefilled)
            if (req.n_prefilled + n - 1) // self.page_size >= len(req.pages):
                raise RuntimeError("ServingEngine: prefill rows past the "
                                   "admitted pages")
            pre[req.rid] = n
            budget -= n

        # ---- phase B: the row batch, into the next host buffer set (the
        # one the in-flight step was staged from is never touched)
        buf = self._bufs[self._buf_idx]
        self._buf_idx ^= 1
        buf.reset(self.num_slots)
        np.copyto(buf.bt, self._bt)
        plan.buf = buf
        samplers = plan.samplers
        r = 0
        if inflight is not None:       # carried decode rows
            for req in inflight.samplers:
                if req.rid not in carried or req.slot is None \
                        or req.state != "running":
                    continue
                pos = carried[req.rid]
                buf.row_slot[r] = req.slot
                buf.row_pos[r] = pos
                buf.row_live[r] = 1
                buf.tok_src[r] = req.slot
                buf.slot_rows[req.slot, 0] = r
                samplers.append(req)
                plan.decode_pos[req.rid] = pos
                plan.was_decode[req.rid] = True
                self.stats["decode_rows"] += 1
                r += 1
        for req in list(self._slots):      # decode (+ draft) rows
            if req is None or req.pending is None \
                    or req.rid in inflight_rids:
                continue
            buf.tokens[r] = req.pending
            buf.row_slot[r] = req.slot
            buf.row_pos[r] = req.n_cached
            buf.row_live[r] = 1
            buf.slot_rows[req.slot, 0] = r
            samplers.append(req)
            plan.decode_pos[req.rid] = req.n_cached
            plan.was_decode[req.rid] = True
            self.stats["decode_rows"] += 1
            r += 1
            # draft rows at n_cached+1 .. n_cached+K_eff, one verify
            # argmax each; rejected tails are overwritten at the
            # committed position before any mask exposes them
            for i, d in enumerate(spec_plan.get(req.rid, ())):
                buf.tokens[r] = d
                buf.row_slot[r] = req.slot
                buf.row_pos[r] = req.n_cached + 1 + i
                buf.row_live[r] = 1
                buf.slot_rows[req.slot, 1 + i] = r
                r += 1
        for req in list(self._slots):      # chunked prefill rows
            if req is None or req.pending is not None \
                    or req.rid in inflight_rids:
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
                    buf.slot_rows[req.slot, 0] = r
                    samplers.append(req)
                    plan.decode_pos[req.rid] = p
                    plan.was_decode[req.rid] = False
                    sampled = True
                r += 1
            if not sampled:
                # still mid-prefill: the commit advances n_cached to the
                # rows THIS plan wrote (recorded now: by commit time the
                # planner may have pushed n_prefilled on)
                plan.prefill_mid.append((req, req.n_prefilled))

        plan.empty = r == 0
        if r or not overlap:
            # an empty pipelined plan is never dispatched: book no batch
            self.stats["dead_rows"] += self.n_rows - r
            self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                           self.cache.pages_in_use)
        if hidden:
            # built while a dispatched step ran on the device
            self.stats["host_hidden_ms"] += \
                (time.perf_counter() - t_b0) * 1e3
        return plan

    def _step_body(self):
        tokens, row_slot, row_pos, row_live, tok_src, slot_rows, bt = \
            self._views
        args = (self.params, self.cfg, self.cache.pools, tokens, row_slot,
                row_pos, row_live, bt, slot_rows, self.page_size)
        if not self.overlap:
            return _step(*args)
        out = _step(*args, tok_src=tok_src, prev_tok=self._tok_out)
        return self._tok_out.copy_(out)

    def _stage_dead(self):
        """Fill the device buffer with an all-dead row batch (every row
        aimed at the all-scratch block-table row ``num_slots``)."""
        _, row_slot, _, _, tok_src, _, _ = self._views
        self._dev.zero_()
        row_slot.fill_(self.num_slots)
        tok_src.fill_(-1)

    def _program(self):
        """The step as one :class:`Program` over the static buffers,
        made at the first dispatch (the reference's ``_step_cache``
        entry: the shape is fixed per engine).  On CUDA it is warmed up
        on an all-dead row batch, which writes only scratch page 0 (and,
        under overlap, the argmax tensor, put back to what it held), and
        captured in inference mode, the mode it replays in; the pools
        are captured in place (the reference donates them)."""
        prog = self._graphs.get("step")
        if prog is None:
            if self.device.type == "cuda":
                self._stage_dead()
                kept = None if self._tok_out is None \
                    else self._tok_out.clone()
                warm_up(self._step_body)
                if kept is not None:
                    self._tok_out.copy_(kept)
            prog = self._graphs.put("step", Program(
                self._step_body, self.device, self._graphs.pool()))
        return prog

    def _dispatch(self, plan):
        """Run the plan's copy-on-write copies, stage its inputs with one
        host-to-device copy, run the step (replay the captured one, or op
        by op when ``_eager``) and start the token read-back.  Returns
        the read-back's wait (asynchronous on CUDA).  Engine thread
        only."""
        with torch.inference_mode():
            for src, dst in plan.copies:
                self.cache.copy_page(src, dst)
            run = self._step_body if self._eager else self._program()
            plan.buf.stage(self._dev)
            tok = run()
            return self._readback.put(tok)

    def _commit(self, plan, next_tok):
        """Consume a completed step's sampled tokens: speculation
        acceptance, stop conditions, retirement, prefix donation.  Under
        overlap this runs one step after the build (and after the NEXT
        plan was built), so it reads no live planner state."""
        self.stats["steps"] += 1
        if plan.pipelined:
            self.stats["overlap_steps"] += 1
        finished = []
        for req in plan.samplers:
            if req.slot is None or req.state != "running":
                continue                   # preempted or cancelled
            # rows written this step are now cached (the recorded
            # sampling position, not live scheduler state)
            req.n_cached = plan.decode_pos[req.rid] + 1
            if self.prefix is not None:
                # donate completed prompt pages BEFORE a same-step retire
                # releases them
                self._insert_prefix(req)
            row = next_tok[req.slot]       # (1 + spec_K,) argmaxes
            drafts = plan.spec_plan.get(req.rid) \
                if plan.was_decode[req.rid] else None
            if drafts is not None and drafts.size:
                # greedy verify: row[i] is the target's own argmax after
                # pending + drafts[:i]; accept the longest matching draft
                # prefix plus the target token at the first mismatch
                k_eff = drafts.size
                a = 0
                while a < k_eff and int(drafts[a]) == int(row[a]):
                    a += 1
                commit = [int(row[i]) for i in range(a + 1)]
                # accepted drafts are already cached at n_cached ..
                # n_cached+a-1 (their rows wrote this step)
                req.n_cached += a
                self.stats["spec_drafted"] += k_eff
                self.stats["spec_accepted"] += a
            else:
                commit = [int(row[0])]
            done = False
            for tok in commit:
                req.generated.append(tok)
                req.pending = tok
                if (len(req.generated) >= req.max_new_tokens
                        or (req.eos_id is not None and tok == req.eos_id)):
                    done = True
                    break
            if done:
                req.state = "done"
                self._release(req)
                finished.append(req.rid)
        # slots that fed prefill rows without finishing their input just
        # advance n_cached, to the position recorded at build time
        for req, p1 in plan.prefill_mid:
            if req.slot is None or req.state != "running":
                continue
            req.n_cached = max(req.n_cached, p1)
            if self.prefix is not None:
                self._insert_prefix(req)
        return finished

    def run(self):
        """Step until every submitted request is done or cancelled.
        Returns {rid: (P + generated,) int32} for the done ones."""
        while self.step() is not False:
            pass
        return {rid: req.output for rid, req in self.requests.items()
                if req.state == "done"}
