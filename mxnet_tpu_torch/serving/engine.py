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
  planner touches host state only: the page copies, exports and
  installs it plans are queued on the ``PagedKVCache`` and run on the
  engine thread at dispatch.
* ``tier_bytes=N`` (or ``MXNET_SERVE_TIER_BYTES=N``): a host-DRAM KV
  tier of N bytes (``serving/tier_store.py``).  Refcount-0 prefix
  chains evicted under pool pressure spill to it and come back as warm
  hits (``prefix_cache.py``), and a preemption victim's written pages
  swap out to it and are installed again at its resume instead of
  recomputed; a refused or LRU-aged entry falls back to recompute.
  Every transfer is asked for in scheduling order and runs on the
  engine thread, on the stream the step runs on, before the inputs are
  staged (``PagedKVCache.run_transfers``): an export reads a page
  before any later step or install overwrites it, and an install lands
  before the step that reads it.  ``preempt()``, ``prefix.spill()`` and
  ``cancel()`` from outside a step queue on the same stream.
* ``metrics=True`` (or ``MXNET_SERVING_METRICS=1``): the ``obs/``
  layer, :class:`_EngineObs`: counters, gauges and TTFT, TBT,
  admission-wait and step histograms in a ``MetricsRegistry``
  (``metrics()``, ``registry``, ``reset_metrics()``), and, while the
  profiler records, per-request lifecycle spans on its clock.  All
  host-side: no device synchronisation is added; under ``overlap`` the
  times are taken at commit, after the token read-back, as in the
  reference.  Off, no instrument exists and each call site is one
  ``is None`` branch.

Under float32 greedy decode the outputs are token-identical to
``models/gpt.py generate`` (the port's and the reference's), whatever
the options, drafter, batch mix, admission order, page reuse,
preemption, spill or swap.

MoE params (``cfg.n_experts``) take the same step: each row of a step
is its own token group for the experts (the reference's
``x[:, None, :]``), so no row is ever dropped for capacity.

A ``mesh`` whose axes all have size 1 (``serving_mesh(1)``) is the
single-device path on its one device, as in the reference.  Not ported
yet (the constructor raises ``NotImplementedError``): ``tp > 1`` (a
live mesh axis) and ``kernel``.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import profiler
from .._graphs import GraphCache, Program, warm_up
from ..engine import Engine as _HostEngine
from ..kernels.paged_attention import paged_attention
from ..models import gpt as G
from ..models.transformer import _layer_norm, torch_dtype
from ..obs import (MetricsRegistry, RequestTraceEmitter,
                   register_engine_registry)
from ..parallel.mesh import mesh_device
from . import drafters
from .paged_kv import PagedKVCache
from .prefix_cache import PrefixCache
from .tier_store import HostTierStore

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
    # time.perf_counter() seconds, the profiler's trace clock
    submit_t: float = 0.0
    wait_start: float = 0.0               # submit or last preemption
    token_times: List[float] = dataclasses.field(default_factory=list)
    trace_id: Optional[str] = None        # caller's id, put on the trace

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

        x = G._layer(layer, x, attend, cfg)
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
                 "was_decode", "prefill_mid", "n_dec_rows", "n_pre_rows",
                 "n_rows_used", "decode_rids", "prefill_spans", "fenced",
                 "empty", "pipelined")

    def __init__(self):
        self.buf = None
        self.samplers = []          # requests sampling a token
        self.spec_plan = {}         # rid -> drafts (serial plans only)
        self.decode_pos = {}        # rid -> its sampling row's pos
        self.was_decode = {}        # rid -> fed a decode row?
        self.prefill_mid = []       # (req, n_prefilled) mid-prefill
        self.n_dec_rows = 0         # metrics: the step's row mix
        self.n_pre_rows = 0
        self.n_rows_used = 0
        self.decode_rids = []       # trace: rids fed a decode row
        self.prefill_spans = []     # trace: (rid, row_lo, row_hi)
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


_engine_seq = itertools.count()


class _EngineObs:
    """Per-engine observability bundle: a labeled ``MetricsRegistry``
    (instrument handles bound once at construction — the step path
    does attribute increments, never name lookups) plus the
    request-span trace emitter.  Constructed only when metrics are
    enabled; the engine otherwise carries ``_obs = None`` and every
    call site is a single ``is None`` branch."""

    def __init__(self, registry=None):
        if registry is None:
            registry = MetricsRegistry(
                labels={"engine": str(next(_engine_seq))})
            # self-created registries join the process-wide Prometheus
            # scrape; an explicitly passed registry stays caller-scoped
            register_engine_registry(registry)
        self.registry = registry
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.submitted = c("serving_requests_submitted_total",
                           "requests accepted by submit()")
        self.admitted = c("serving_requests_admitted_total",
                          "admissions into a decode slot (resumes "
                          "after preemption count again)")
        self.finished = c("serving_requests_finished_total",
                          "requests retired done")
        self.cancelled = c("serving_requests_cancelled_total",
                           "requests retired by cancel()")
        self.preemptions = c("serving_preemptions_total",
                             "youngest-victim preemptions")
        self.steps = c("serving_steps_total", "engine iterations")
        self.tokens = c("serving_tokens_total",
                        "tokens committed to requests")
        self.decode_rows = c("serving_decode_rows_total",
                             "decode rows fed to the step program")
        self.prefill_rows = c("serving_prefill_rows_total",
                              "chunked-prefill rows fed")
        self.dead_rows = c("serving_dead_rows_total",
                           "padding rows aimed at the scratch page")
        self.alloc_calls = c("serving_page_alloc_calls_total",
                             "page-allocator calls")
        self.pages_allocated = c("serving_pages_allocated_total",
                                 "pages handed out")
        self.pages_freed = c("serving_pages_freed_total",
                             "pages recycled")
        self.alloc_failures = c("serving_page_alloc_failures_total",
                                "allocations refused by a dry pool "
                                "(caller stalls or preempts)")
        # in-engine speculative decode (all zero at spec_K=0)
        self.spec_drafted = c("serving_spec_drafted_tokens_total",
                              "draft tokens fed to the batched "
                              "verify forward")
        self.spec_accepted = c("serving_spec_accepted_tokens_total",
                               "draft tokens committed (matched the "
                               "verify argmax)")
        self.spec_rejected = c("serving_spec_rejected_tokens_total",
                               "draft tokens rolled back by pointer "
                               "(drafted - accepted)")
        self.g_spec_accept_rate = g(
            "serving_spec_accept_rate",
            "cumulative accepted / drafted draft tokens")
        # host-DRAM KV tier (all zero when disabled)
        self.tier_spills = c("serving_tier_spills_total",
                             "KV pages spilled HBM -> host tier "
                             "(pressure-evicted prefix chains + "
                             "preemption swap-outs)")
        self.tier_installs = c("serving_tier_installs_total",
                               "KV pages installed host tier -> HBM "
                               "(warm prefix hits + swap-in resumes)")
        self.tier_bytes = c("serving_tier_bytes_total",
                            "bytes moved through the host tier, both "
                            "directions (spill + install + peer "
                            "fetches served from the tier)")
        self.tier_evicted = c("serving_tier_evicted_pages_total",
                              "pages LRU-dropped from the host tier "
                              "(its byte budget, not pool pressure)")
        self.g_tier_pages = g("serving_tier_pages",
                              "KV pages currently held by the host "
                              "tier")
        self.g_tier_bytes = g("serving_tier_bytes_held",
                              "host-DRAM bytes currently held by the "
                              "tier (vs its byte budget)")
        self.g_tier_budget = g("serving_tier_budget_bytes",
                               "the host tier's configured byte "
                               "budget")
        self.warm_hit_tokens = c(
            "serving_prefix_warm_hit_tokens_total",
            "prefill tokens served by re-installing SPILLED chain "
            "pages (the warm-hit outcome between hot-hit and miss)")
        self.swap_outs = c("serving_swap_outs_total",
                           "preemptions whose victim pages were "
                           "swapped to the host tier instead of "
                           "discarded")
        self.swap_ins = c("serving_swap_ins_total",
                          "preemption resumes served install-exact "
                          "from the host tier instead of recomputed")
        # shared-prefix cache (all zero when disabled)
        self.prefix_hit_tokens = c("serving_prefix_hit_tokens_total",
                                   "prefill tokens skipped via "
                                   "prefix-cache hits")
        self.prefix_lookup_tokens = c(
            "serving_prefix_lookup_tokens_total",
            "prefill tokens eligible for prefix reuse (admissions)")
        self.prefix_pages_hit = c("serving_prefix_pages_hit_total",
                                  "cached pages mapped read-only into "
                                  "block tables")
        self.prefix_pages_inserted = c(
            "serving_prefix_pages_inserted_total",
            "prompt pages donated to the prefix cache")
        self.prefix_pages_evicted = c(
            "serving_prefix_pages_evicted_total",
            "refcount-0 chains evicted under pool pressure")
        self.prefix_cows = c("serving_prefix_cow_total",
                             "copy-on-write page copies at divergence")
        self.g_prefix_cached = g("serving_prefix_cached_pages",
                                 "pages owned by the prefix cache")
        self.g_prefix_hit_ratio = g(
            "serving_prefix_hit_ratio",
            "cumulative hit tokens / lookup tokens")
        self.g_running = g("serving_running", "requests holding a slot")
        self.g_queued = g("serving_queued", "requests waiting for a "
                          "slot (incl. preempted)")
        self.g_page_free = g("serving_page_free",
                             "free-list length (pages)")
        self.g_pages_in_use = g("serving_pages_in_use",
                                "allocated non-scratch pages")
        self.g_hbm_held = g("serving_hbm_held_bytes",
                            "device bytes held by allocated pages")
        self.g_step_decode = g("serving_step_decode_rows",
                               "decode rows in the latest step")
        self.g_step_prefill = g("serving_step_prefill_rows",
                                "prefill rows in the latest step")
        self.g_step_dead = g("serving_step_dead_rows",
                             "dead rows in the latest step")
        self.h_admission = h("serving_admission_wait_ms",
                             help="submit (or preemption) -> slot "
                                  "admission")
        self.h_ttft = h("serving_ttft_ms",
                        help="submit -> first committed token")
        self.h_tbt = h("serving_tbt_ms",
                       help="interval between committed tokens "
                            "(preemption gaps included)")
        self.h_step = h("serving_step_ms", help="engine step duration")
        self.trace = RequestTraceEmitter()
        # last-seen allocator totals, so sync_cache feeds DELTAS: with
        # a caller-shared registry two engines would otherwise assign
        # competing cumulative values and the counters would go
        # backwards (a Prometheus rate() reads that as a reset)
        self._cache_seen = [0, 0, 0, 0]
        self._prefix_seen = [0, 0, 0, 0, 0, 0]
        self._tier_seen = [0, 0, 0, 0]
        self._warm_seen = [0]             # sync_prefix: warm tokens
        self._swap_seen = [0, 0]          # sync_tier: outs, ins

    @staticmethod
    def _fold(ctrs, vals, seen):
        """Increment each counter by its total's growth since ``seen``
        (totals only grow between resets).  v < last seen means a
        ``reset_telemetry()`` re-baselined the total: v IS the activity
        since the reset, so count it rather than dropping everything
        until the total passes the stale baseline."""
        for i, (ctr, v) in enumerate(zip(ctrs, vals)):
            d = v - seen[i]
            if d < 0:
                d = v
            if d > 0:
                ctr.inc(d)
            seen[i] = v

    def sync_cache(self, cache):
        """Fold the allocator's plain-int telemetry into the registry
        by increment."""
        self._fold((self.alloc_calls, self.pages_allocated,
                    self.pages_freed, self.alloc_failures),
                   (cache.alloc_calls, cache.alloc_pages_total,
                    cache.freed_pages_total, cache.alloc_failures),
                   self._cache_seen)
        self.g_page_free.set(cache.free_pages)
        self.g_pages_in_use.set(cache.pages_in_use)
        self.g_hbm_held.set(cache.bytes_held)

    def sync_prefix(self, prefix):
        """Fold the prefix cache's host ints in, delta-wise like
        sync_cache (same shared-registry aggregation argument)."""
        self._fold((self.prefix_hit_tokens, self.prefix_lookup_tokens,
                    self.prefix_pages_hit, self.prefix_pages_inserted,
                    self.prefix_pages_evicted, self.prefix_cows),
                   (prefix.hit_tokens_total, prefix.lookup_tokens_total,
                    prefix.pages_hit_total, prefix.pages_inserted_total,
                    prefix.pages_evicted_total, prefix.cow_total),
                   self._prefix_seen)
        self.g_prefix_cached.set(prefix.cached_pages)
        self.g_prefix_hit_ratio.set(
            prefix.hit_tokens_total
            / max(1, prefix.lookup_tokens_total))
        # warm-hit tokens ride the prefix sync (the counter lives on
        # the prefix cache, tier or not)
        self._fold((self.warm_hit_tokens,),
                   (prefix.warm_hit_tokens_total,), self._warm_seen)

    def sync_tier(self, tier, swap_outs, swap_ins):
        """Fold the host tier's plain-int telemetry in, delta-wise
        like sync_cache (same shared-registry aggregation argument);
        occupancy gauges carry the current tier state."""
        self._fold((self.tier_spills, self.tier_installs,
                    self.tier_bytes, self.tier_evicted),
                   (tier.spilled_pages_total, tier.installed_pages_total,
                    tier.bytes_moved_total, tier.evicted_pages_total),
                   self._tier_seen)
        self.g_tier_pages.set(tier.pages_held)
        self.g_tier_bytes.set(tier.bytes_held)
        self.g_tier_budget.set(tier.budget_bytes)
        self._fold((self.swap_outs, self.swap_ins), (swap_outs, swap_ins),
                   self._swap_seen)


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
    tier_bytes : host-DRAM KV tier budget in bytes; None reads
        ``MXNET_SERVE_TIER_BYTES`` (off unless set), 0 disables.
    metrics : the obs layer on or off; None reads
        ``MXNET_SERVING_METRICS`` (on when "1"), or is on when a
        ``registry`` is given.
    registry : an ``obs.MetricsRegistry`` to feed; by default the
        engine makes its own, labelled ``{engine="<n>"}``, and registers
        it with the process-wide Prometheus scrape.
    device : where the engine runs; None means the CUDA device (and
        raises without one), ``"cpu"`` runs the plain versions.
    tp, mesh : tensor parallelism; ``tp=1`` and a mesh whose ``tp`` axis
        (and every other) has size 1 run here on the mesh's device, with
        ``engine.mesh`` None as in the reference.  ``tp > 1`` raises.
    rid_start : the first request id this engine gives (a
        ``ServingCluster`` gives each replica a block of its own, so
        request ids and their trace lanes are unique in the cluster).
    """

    def __init__(self, params, cfg, *, num_slots, page_size=16,
                 num_pages=None, pages_per_slot=None, prefill_chunk=8,
                 kv_int8=False, prefix_cache=False, spec_K=0,
                 spec_drafter="ngram", spec_ngram=2, overlap=None,
                 device=None, tier_bytes=None, metrics=None,
                 registry=None, rid_start=0, tp=1, mesh=None,
                 kernel=None):
        if kernel is not None:
            raise NotImplementedError(
                "ServingEngine: kernel is not ported to mxnet_tpu_torch "
                "yet (ROADMAP.md)")
        if mesh is not None:
            if "tp" not in mesh.axis_names:
                raise ValueError("ServingEngine: mesh has no 'tp' axis "
                                 "(build one with parallel.serving_mesh)")
            if tp not in (1, int(mesh.shape["tp"])):
                raise ValueError(
                    "ServingEngine: tp=%d disagrees with the mesh's tp "
                    "axis (%d)" % (tp, mesh.shape["tp"]))
            tp = int(mesh.shape["tp"])
        if tp < 1:
            raise ValueError("ServingEngine: tp must be >= 1")
        if tp > 1:
            if cfg.n_heads % tp:
                raise ValueError(
                    "ServingEngine: n_heads=%d not divisible by tp=%d — "
                    "the KV pools shard the heads axis" % (cfg.n_heads, tp))
            if any("moe" in layer for layer in params["layers"]):
                raise ValueError(
                    "ServingEngine: MoE decode params are tp=1-only "
                    "(expert dispatch is not validated under the serving "
                    "mesh; experts would replicate with only the FFN "
                    "hidden dim sharded)")
            raise NotImplementedError(
                "ServingEngine: tp=%d is not ported to mxnet_tpu_torch "
                "yet (ROADMAP.md)" % tp)
        self.tp, self.mesh = 1, None
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
        self.device = mesh_device(mesh, "ServingEngine", device)
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
        if tier_bytes is None:
            env = os.environ.get("MXNET_SERVE_TIER_BYTES", "")
            try:
                tier_bytes = int(env) if env else 0
            except ValueError:
                raise ValueError(
                    "MXNET_SERVE_TIER_BYTES=%r: expected int" % env)
        if metrics is None:
            # a registry given is a request for telemetry; otherwise the
            # environment decides
            metrics = registry is not None or \
                os.environ.get("MXNET_SERVING_METRICS", "0") == "1"
        elif not metrics and registry is not None:
            raise ValueError(
                "ServingEngine: registry= given but metrics=False — "
                "the registry would be silently ignored")
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
        self.tier = HostTierStore(tier_bytes) if tier_bytes else None
        self.prefix = PrefixCache(self.cache, tier=self.tier) \
            if prefix_cache else None
        if self.prefix is not None:
            self.cache.pressure_cb = self.prefix.evict
            # the reference compiles its copy program here; the port's
            # first copy (scratch onto scratch) runs here likewise
            self.cache.copy_page(0, 0)
        # from here on page copies, exports and installs queue and run
        # at dispatch, on the engine thread (the planner asks for them)
        self.cache.deferred = True
        self._queue: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._next_rid = int(rid_start)
        self.requests: Dict[int, Request] = {}
        self.stats = {"steps": 0, "preemptions": 0, "admitted": 0,
                      "decode_rows": 0, "prefill_rows": 0,
                      "dead_rows": 0, "peak_pages": 0,
                      "prefix_hit_tokens": 0, "cow_copies": 0,
                      "spec_drafted": 0, "spec_accepted": 0,
                      "swap_outs": 0, "swap_ins": 0,
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
        self._obs = _EngineObs(registry) if metrics else None
        # retire hook (the disaggregated prefill worker): called with a
        # finishing request while its pages are still assigned, since
        # the step frees them before it returns; freed pages keep their
        # bytes until a later allocation, so an export of the ids taken
        # here right after the step reads the request's content
        self.retire_cb = None

    # ------------------------------------------------------- intake --
    def submit(self, prompt, max_new_tokens, eos_id=None, trace_id=None):
        """Queue a request; returns its id.  prompt: (P,) ints;
        ``trace_id`` tags its lifecycle trace events."""
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
        now = time.perf_counter()
        with self._mu:
            req = Request(rid=self._next_rid, prompt=prompt,
                          max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                          submit_t=now, wait_start=now, trace_id=trace_id)
            self._next_rid += 1
            self.requests[req.rid] = req
            self._queue.append(req)
            if self._obs is not None:
                self._obs.submitted.inc()
                self._obs.g_queued.set(len(self._queue))
            return req.rid

    def admit_prefilled(self, prompt, generated, pages, *,
                        max_new_tokens, eos_id=None, rid=None):
        """Adopt a request prefilled elsewhere (disaggregated serving):
        ``pages`` were allocated from THIS engine's cache and hold the
        k/v of positions ``[0, P + len(generated) - 1)`` (P the prompt
        length), the prefill worker's exact pool bytes, their installs
        queued on the cache.  ``generated`` holds at least the prefill
        side's sampled token; the request resumes where one engine
        would be after committing those tokens (``pending`` the last
        one, ``n_cached = P + len(generated) - 1``), so under f32 greedy
        the continuation is bit-identical to an undisturbed run.  The
        slot's block-table row is set here, so the next step (a replay
        of the captured one on the card, after the queued installs run)
        reads the adopted pages.  Raises when no slot is free: the
        caller checks ``free_slots`` first."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        generated = [int(t) for t in generated]
        if not generated:
            raise ValueError("admit_prefilled: needs >= 1 committed "
                             "token (the prefill side samples the "
                             "first before handoff)")
        if prompt.size < 1:
            raise ValueError("admit_prefilled: empty prompt")
        total = prompt.size + max_new_tokens
        if total > self.max_seq or total > self.cfg.max_len:
            raise ValueError(
                "admit_prefilled: %d tokens > max_seq %d / max_len %d"
                % (total, self.max_seq, self.cfg.max_len))
        with self._mu:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                raise RuntimeError("admit_prefilled: no free slot")
            n_cached = prompt.size + len(generated) - 1
            need = -(-n_cached // self.page_size) if n_cached else 0
            if len(pages) < need:
                raise ValueError(
                    "admit_prefilled: %d pages cannot cover %d cached"
                    " positions" % (len(pages), n_cached))
            now = time.perf_counter()
            if rid is None:
                rid = self._next_rid
                self._next_rid += 1
            req = Request(rid=rid, prompt=prompt,
                          max_new_tokens=int(max_new_tokens),
                          eos_id=eos_id, submit_t=now, wait_start=now)
            req.generated = generated
            req.pending = generated[-1]
            req.n_cached = n_cached
            req.n_prefilled = n_cached
            req.pages = list(pages)
            req.slot = free[0]
            req.state = "running"
            self.requests[rid] = req
            self._slots[req.slot] = req
            self._bt_set(req.slot, req.pages)
            self.stats["admitted"] += 1
            if self._obs is not None:
                self._obs.submitted.inc()
                self._obs.admitted.inc()
                self._obs.g_running.set(
                    sum(r is not None for r in self._slots))
            return rid

    def cancel(self, rid):
        """Force-retire a request, freeing its slot and pages now; a
        cancel after completion is a no-op."""
        with self._mu:
            req = self.requests[rid]
            if req.state in ("done", "cancelled"):
                return
            if req.state == "queued":
                self._queue.remove(req)
                if self.tier is not None:
                    # a swapped-out victim cancelled while queued must
                    # not squat in the host tier until LRU age-out
                    self.tier.drop(("swap", rid))
            elif req.state == "running":
                self._release(req)
            req.state = "cancelled"
            if self._obs is not None:
                self._obs.cancelled.inc()
                self._obs.g_queued.set(len(self._queue))
                self._obs.g_running.set(
                    sum(r is not None for r in self._slots))
                if profiler.is_recording():
                    cargs = {"state": "cancelled"}
                    if req.trace_id:
                        cargs["trace_id"] = req.trace_id
                    self._obs.trace.add_instant(
                        rid, "retire", time.perf_counter(), args=cargs)
                    self._obs.trace.flush()

    def preempt(self, rid):
        """Force-preempt one RUNNING request through the victim path:
        with a host tier its written pages swap out (and its resume
        installs them), else it recomputes at resume.  Returns True if
        the pages were swapped out, False for a recompute resume."""
        with self._mu:
            req = self.requests[rid]
            if req.state != "running":
                raise ValueError("preempt(%d): request is %s, not running"
                                 % (rid, req.state))
            return self._preempt_victim(req)

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
        """Evict ``victim`` from its slot and requeue it at the front.
        With a host tier its written pages (positions ``[0, n_cached)``)
        swap out first, so its resume installs them instead of
        recomputing; the export is asked for before ``_release`` frees
        the pages (the allocation that forced this preemption may take
        them at once).  A refused swap falls back to recompute.
        Returns whether the pages were swapped out."""
        swapped = False
        if self.tier is not None and victim.n_cached > 0:
            n = -(-victim.n_cached // self.page_size)
            # budget check before the export: a victim the tier must
            # refuse would pay a whole transfer for nothing
            if n * self.cache.bytes_per_page <= self.tier.budget_bytes:
                content = self.cache.export_pages(victim.pages[:n])
                swapped = self.tier.put(
                    ("swap", victim.rid), content, n,
                    meta={"n_cached": victim.n_cached,
                          "pending": victim.pending})
            if swapped:
                self.stats["swap_outs"] += 1
        self._release(victim)
        victim.state = "queued"
        victim.n_prefilled = 0
        victim.n_cached = 0
        victim.pending = None
        self._queue.insert(0, victim)
        self.stats["preemptions"] += 1
        if self._obs is not None:
            now = time.perf_counter()
            victim.wait_start = now
            self._obs.preemptions.inc()
            if profiler.is_recording():
                self._obs.trace.add_instant(
                    victim.rid, "preempt", now,
                    args={"committed": len(victim.generated),
                          "swapped": swapped})
        return swapped

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

    def _admit(self):
        """Admit queued requests into free slots while the pool covers
        them (swap-ins first, with a tier); the page copies and installs
        they need queue on the cache and run at dispatch."""
        while self._queue:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                return
            req = self._queue[0]
            inp = req.resume_input
            if self.tier is not None:
                swapped = self._swap_in(req, inp, free[0])
                if swapped == "admitted":
                    continue
                if swapped == "stall":
                    return
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
                self.cache.copy_page(hit_pages[cow_idx], priv)
                req.pages[cow_idx] = priv
                req.shared_pages.discard(hit_pages[cow_idx])
                self.prefix.release([req.prefix_entries.pop()])
                self.prefix.note_cow()
                self.stats["cow_copies"] += 1
            req.chain_upto = len(req.prefix_entries)
            req.pages.extend(got)
            if self.prefix is not None:
                self.prefix.note_admit(skip, inp.size,
                                       len(req.shared_pages))
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
            if self._obs is not None:
                now = time.perf_counter()
                self._obs.admitted.inc()
                self._obs.h_admission.observe(
                    (now - req.wait_start) * 1e3)
                if profiler.is_recording():
                    self._obs.trace.add_span(
                        req.rid, "admission_wait", req.wait_start, now)
                    if req.generated:
                        self._obs.trace.add_instant(req.rid, "resume",
                                                    now)

    def _swap_in(self, req, inp, slot):
        """Install-exact resume: if ``req`` was preempted with its pages
        swapped to the host tier, install them again and resume at the
        saved ``(n_cached, pending)``, no re-prefill.  Returns
        ``"admitted"`` (slot taken), ``"stall"`` (the pool cannot hold
        the swap now: admission stalls, the entry is kept) or ``"none"``
        (no swap entry: the caller admits by match and alloc, so a swap
        the tier LRU-evicted degrades to recompute, never to wrong)."""
        entry = self.tier.peek(("swap", req.rid))
        if entry is None:
            return "none"
        # the admission path's page coverage: a mid-prefill victim's
        # chunked-prefill plan needs every input position's page, and
        # the swapped pages are a prefix of that set
        total = max(entry.n_pages,
                    -(-min(inp.size + 1, self.max_seq) // self.page_size))
        got = self.cache.alloc(total)
        if got is None:
            return "stall"
        entry = self.tier.pop(("swap", req.rid))
        if entry is None:
            # evicted between peek and pop (the alloc's own pressure
            # spills went in ahead of it): give the pages back, recompute
            self.cache.free(got)
            return "none"
        self.cache.install_pages(got[:entry.n_pages], entry.content)
        self._queue.pop(0)
        req.pages = got
        req.shared_pages = set()
        req.prefix_entries = []
        req.chain_upto = 0
        req.slot = slot
        req.state = "running"
        req.n_cached = entry.meta["n_cached"]
        req.pending = entry.meta["pending"]
        # a decode-phase victim resumes fully prefilled; one caught
        # mid-prefill (pending is None) continues its chunked prefill
        # from the first unwritten position
        req.n_prefilled = inp.size if req.pending is not None \
            else req.n_cached
        self._slots[slot] = req
        self._bt_set(slot, req.pages)
        self.stats["admitted"] += 1
        self.stats["swap_ins"] += 1
        if self._obs is not None:
            now = time.perf_counter()
            self._obs.admitted.inc()
            self._obs.h_admission.observe((now - req.wait_start) * 1e3)
            if profiler.is_recording():
                self._obs.trace.add_span(
                    req.rid, "admission_wait", req.wait_start, now)
                self._obs.trace.add_instant(
                    req.rid, "resume", now,
                    args={"swap_in": True, "pages": len(req.pages)})
        return "admitted"

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
        obs = self._obs
        t_step0 = time.perf_counter() if obs is not None else 0.0
        self._bufs[self._buf_idx].wait_free()
        with self._mu:
            plan = self._build_plan(overlap=False)
        if obs is not None:
            # the step is the serving layer's operator: a recording
            # profiler logs it through the engine's op hooks
            _HostEngine.get().notify("start", "serving_step")
        try:
            next_tok = self._dispatch(plan)()
        finally:
            if obs is not None:
                _HostEngine.get().notify("stop", "serving_step")
        now = time.perf_counter()
        with self._mu:
            return self._commit(plan, next_tok, now, t_step0)

    def _step_overlap(self):
        """One pipelined iteration.  Call k: take plan k (planner-built
        while step k-1 ran, or built inline on a cold start), dispatch it
        against the in-flight step's tokens on the device, THEN wait for
        and commit step k-1; the commit of k-1 and the planner's build of
        k+1 both hide behind step k on the device."""
        self._ensure_planner()
        obs = self._obs
        t0 = time.perf_counter() if obs is not None else 0.0
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
                finished += self._drain(old, old_tok, t0)
            out = self._step_serial()
            if out is not False:
                finished += out
            self._maybe_plan_ahead()
            return finished
        old, old_tok = self._inflight, self._inflight_tok
        if not plan.empty:
            if obs is not None:
                _HostEngine.get().notify("start", "serving_step")
            try:
                tok = self._dispatch(plan)
            finally:
                if obs is not None:
                    _HostEngine.get().notify("stop", "serving_step")
            self._inflight = plan
            self._inflight_tok = tok
        else:
            # nothing to dispatch (every live request rides the in-flight
            # step): just drain
            self._inflight = None
            self._inflight_tok = None
        finished = self._drain(old, old_tok, t0) if old is not None else []
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

    def _drain(self, plan, tok, t0):
        """Wait for a dispatched step's tokens and commit it.  Under
        overlap this runs after the next step was dispatched; the
        commit's clock reads after the token read-back."""
        next_tok = tok()
        now = time.perf_counter()
        with self._mu:
            return self._commit(plan, next_tok, now, t0)

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
        self._admit()

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
        tracing = self._obs is not None and profiler.is_recording()
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
                plan.n_dec_rows += 1
                if tracing:
                    plan.decode_rids.append(req.rid)
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
            plan.n_dec_rows += 1
            if tracing:
                plan.decode_rids.append(req.rid)
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
            p0 = req.n_prefilled
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
            if tracing and req.n_prefilled > p0:
                plan.prefill_spans.append((req.rid, p0, req.n_prefilled))

        plan.n_rows_used = r
        plan.n_pre_rows = sum(pre.values())
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
        are captured in place (the reference donates them).  An engine
        run on a stream of its own (a cluster's replica) captures on
        that stream (:class:`Program`), so replicas replaying at once
        share no cuBLAS workspace."""
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
        """Run the page transfers queued so far (the plan's copies on
        write, exports and installs, and any asked for outside a step,
        in the order asked), stage the plan's inputs with one
        host-to-device copy, run the step (replay the captured one, or
        op by op when ``_eager``) and start the token read-back.
        Returns the read-back's wait (asynchronous on CUDA).  Engine
        thread only."""
        with torch.inference_mode():
            self.cache.run_transfers()
            run = self._step_body if self._eager else self._program()
            plan.buf.stage(self._dev)
            tok = run()
            return self._readback.put(tok)

    def _commit(self, plan, next_tok, now, t_step0):
        """Consume a completed step's sampled tokens: speculation
        acceptance, stop conditions, retirement, prefix donation,
        metrics (``now``: after the read-back; ``t_step0``: the step's
        start).  Under overlap this runs one step after the build (and
        after the NEXT plan was built), so it reads no live planner
        state."""
        obs = self._obs
        tracing = obs is not None and profiler.is_recording()
        self.stats["steps"] += 1
        if plan.pipelined:
            self.stats["overlap_steps"] += 1
        finished = []
        spec_spans = []                    # trace: (rid, drafted, accepted)
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
                if obs is not None:
                    obs.spec_drafted.inc(k_eff)
                    obs.spec_accepted.inc(a)
                    obs.spec_rejected.inc(k_eff - a)
                if tracing:
                    spec_spans.append((req.rid, k_eff, a))
            else:
                commit = [int(row[0])]
            if obs is not None:
                if req.token_times:
                    obs.h_tbt.observe((now - req.token_times[-1]) * 1e3)
                elif not req.generated:
                    obs.h_ttft.observe((now - req.submit_t) * 1e3)
                    if tracing:
                        obs.trace.add_instant(
                            req.rid, "first_token", now,
                            args={"trace_id": req.trace_id}
                            if req.trace_id else None)
            done = False
            for tok in commit:
                req.generated.append(tok)
                req.token_times.append(now)
                req.pending = tok
                if obs is not None:
                    obs.tokens.inc()
                if (len(req.generated) >= req.max_new_tokens
                        or (req.eos_id is not None and tok == req.eos_id)):
                    done = True
                    break
            if done:
                req.state = "done"
                if self.retire_cb is not None:
                    self.retire_cb(req)
                self._release(req)
                finished.append(req.rid)
                if obs is not None:
                    obs.finished.inc()
                    if tracing:
                        rargs = {"tokens": len(req.generated)}
                        if req.trace_id:
                            rargs["trace_id"] = req.trace_id
                        obs.trace.add_instant(req.rid, "retire", now,
                                              args=rargs)
        # slots that fed prefill rows without finishing their input just
        # advance n_cached, to the position recorded at build time
        for req, p1 in plan.prefill_mid:
            if req.slot is None or req.state != "running":
                continue
            req.n_cached = max(req.n_cached, p1)
            if self.prefix is not None:
                self._insert_prefix(req)
        if obs is not None:
            self._observe_step(obs, plan, now, t_step0, tracing, spec_spans)
        return finished

    def _observe_step(self, obs, plan, now, t_step0, tracing, spec_spans):
        """The step's counters, gauges and histogram; the allocator's,
        prefix cache's and tier's totals folded in as deltas; the step's
        trace spans handed to the profiler in one batch."""
        dead = self.n_rows - plan.n_rows_used
        obs.steps.inc()
        obs.h_step.observe((now - t_step0) * 1e3)
        # increments by THIS step's amounts (engines sharing a registry
        # aggregate, never clobber)
        obs.decode_rows.inc(plan.n_dec_rows)
        obs.prefill_rows.inc(plan.n_pre_rows)
        obs.dead_rows.inc(dead)
        obs.g_step_decode.set(plan.n_dec_rows)
        obs.g_step_prefill.set(plan.n_pre_rows)
        obs.g_step_dead.set(dead)
        obs.g_running.set(sum(r is not None for r in self._slots))
        obs.g_queued.set(len(self._queue))
        if self.stats["spec_drafted"]:
            obs.g_spec_accept_rate.set(self.stats["spec_accepted"]
                                       / self.stats["spec_drafted"])
        obs.sync_cache(self.cache)
        if self.prefix is not None:
            obs.sync_prefix(self.prefix)
        if self.tier is not None:
            obs.sync_tier(self.tier, self.stats["swap_outs"],
                          self.stats["swap_ins"])
        if tracing:
            for rid in plan.decode_rids:
                obs.trace.add_span(rid, "decode", t_step0, now)
            for rid, k_eff, a in spec_spans:
                obs.trace.add_span(rid, "spec_verify", t_step0, now,
                                   args={"drafted": k_eff, "accepted": a})
            for rid, p0, p1 in plan.prefill_spans:
                obs.trace.add_span(rid, "prefill[%d:%d)" % (p0, p1),
                                   t_step0, now, args={"rows": p1 - p0})
            obs.trace.flush()

    def run(self):
        """Step until every submitted request is done or cancelled.
        Returns {rid: (P + generated,) int32} for the done ones."""
        while self.step() is not False:
            pass
        return {rid: req.output for rid, req in self.requests.items()
                if req.state == "done"}

    # --------------------------------------------------- accounting --
    @property
    def metrics_enabled(self):
        return self._obs is not None

    @property
    def registry(self):
        """The engine's ``obs.MetricsRegistry`` (None when metrics are
        off)."""
        return self._obs.registry if self._obs is not None else None

    def reset_metrics(self):
        """Zero this engine's telemetry in place (warm-up exclusion):
        the registry's values, the allocator's, prefix cache's and
        tier's cumulative ints, and the delta trackers that fold the
        latter into the former."""
        if self._obs is None:
            return
        with self._mu:
            self._obs.registry.reset_values()
            self.cache.reset_telemetry()
            self._obs._cache_seen = [0, 0, 0, 0]
            if self.prefix is not None:
                self.prefix.lookups_total = 0
                self.prefix.lookup_tokens_total = 0
                self.prefix.hit_tokens_total = 0
                self.prefix.pages_hit_total = 0
                self.prefix.pages_inserted_total = 0
                self.prefix.pages_evicted_total = 0
                self.prefix.cow_total = 0
                self.prefix.pages_spilled_total = 0
                self.prefix.pages_restored_total = 0
                self.prefix.warm_hits_total = 0
                self.prefix.warm_hit_tokens_total = 0
                self._obs._prefix_seen = [0, 0, 0, 0, 0, 0]
            if self.tier is not None:
                self.tier.reset_telemetry()
                self.stats["swap_outs"] = 0
                self.stats["swap_ins"] = 0
                self._obs._tier_seen = [0, 0, 0, 0]
                self._obs._swap_seen = [0, 0]
            self._obs._warm_seen = [0]

    def metrics(self):
        """JSON-able telemetry snapshot: this engine's counters, gauges
        and histogram summaries (count/sum/p50/p95/p99 ms);
        ``{"enabled": False}`` when metrics are off."""
        if self._obs is None:
            return {"enabled": False}
        snap = self._obs.registry.snapshot()
        snap["enabled"] = True
        return snap

    @property
    def hbm_held(self):
        return self.cache.bytes_held

    @property
    def hbm_pool(self):
        return self.cache.bytes_pool

    @property
    def hbm_held_per_device(self):
        """``hbm_held`` on each device; the engine runs on one card."""
        return self.cache.bytes_held_per_device

    @property
    def hbm_pool_per_device(self):
        return self.cache.bytes_pool_per_device

    @property
    def free_slots(self):
        """Decode slots no request occupies."""
        return sum(r is None for r in self._slots)
