#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel of the serving path from ``kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card at
   the path's shapes, each check with its stated tolerance;
4. drives the main path with every launch counter set to 0: the
   ``full`` serving preset (GPT vocab 32000, d_model 768, 12 heads, 12
   layers, d_ff 3072, max_len 512, bf16, weight-only int8, random
   weights from a seed) serving the preset's 64-request mix through
   ``ServingEngine`` (16 slots, page 16, prefill chunk 16) once with
   float KV and once with int8 KV, then ``generate`` on 4 prompts;
   asserts every request finished, no page leaked, and each kernel
   launched;
5. holds the paged kernel against its plain version on inputs captured
   from the live engine (its real pools, block table and positions);
6. times each kernel, its plain version and a library call at the
   path's shapes (CUDA events, L2 flushed between launches) beside the
   least time the card could take for the same work, and profiles 20
   engine steps (torch.profiler) for the device's busy and idle time;
7. checks a small float32 engine on the card against ``generate`` on
   the CPU, and prints the full-width float32 engine-vs-``generate``
   token agreement as information;
8. prints the ``kernels`` JSON line and, last, the device line.

Exits non-zero, printing no result, without a CUDA device, when a
kernel does not build or launch, or when any check fails.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12            # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12              # f32 FLOP/s outside the tensor cores

# the `full` preset of benchmark/serve_bench.py
VOCAB, D, HEADS, LAYERS, FF, MAX_LEN = 32000, 768, 12, 12, 3072, 512
SLOTS, PAGE, CHUNK, N_REQ = 16, 16, 16, 64
PROMPT_LENS = (16, 32, 64, 128, 192)
OUT_LENS = (16, 32, 64, 128, 160)

# kernel-vs-plain tolerances (max |kernel - plain| <= atol + rtol*|plain|):
# f32 differs only by summation order; bf16 flash by where p and the
# logits are rounded (the plain flash version keeps bf16 logits)
TOL = {("paged", "float32"): 1e-5, ("flash", "float32"): 1e-5,
       ("flash", "bfloat16"): 2e-2}
LSE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# paged attention over a bf16 or int8 pool: the kernel rounds each
# (v-scaled) weight p_i to bf16 before normalising, the plain version
# after; each rounding is within 2^-8 relative, so the two differ by at
# most 2^-7 * sum_i p_i |v_i| per element.  The limit is that, with 2%
# and 1e-5 to spare for f32 reduction order.
PAGED_ROUND = 8e-3
PAGED_TOL_TEXT = "1e-5 + 8e-3 * (plain version on |v|)"


def log(*a):
    print(*a, flush=True)


class Failed(Exception):
    pass


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise Failed("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def workload(seed=0):
    """The preset's request mix, drawn as serve_bench.py ``_workload``
    draws it (same seed, same sequence of draws): [(prompt, n_new)]."""
    rng = np.random.RandomState(seed)
    rng.randint(1, VOCAB, (max(PROMPT_LENS) // 2 // PAGE) * PAGE)
    out = []
    for _ in range(N_REQ):
        rng.exponential(1.0 / 100.0)
        P = int(rng.choice(PROMPT_LENS))
        N = int(rng.choice(OUT_LENS))
        out.append((rng.randint(1, VOCAB, P).astype(np.int32), N))
    return out


def check(name, got, ref, failures, tol=None, limit=None):
    """Hold ``got`` against ``ref``: |got - ref| <= ``limit`` per
    element, by default ``tol * (1 + |ref|)``.  Logs the largest error,
    the limit and the typical output size, mean |ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if limit is None:
        limit = tol + tol * ref.abs()
        what = "tol %.0e" % tol
    else:
        what = "limit %.2e..%.2e" % (float(limit.min()), float(limit.max()))
    ok = bool((err <= limit).all()) and bool(torch.isfinite(got).all())
    log("check %-44s max_abs_err %.3e  %s  mean|ref| %.3e  %s"
        % (name, float(err.max()), what, float(ref.abs().mean()),
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append(name)
    return float(err.max())


def cuda_ms(fn, iters=30, flush=None):
    """Mean device time of ``fn`` in ms over ``iters`` launches, timed
    with CUDA events one launch at a time; ``flush`` (a large tensor)
    is rewritten before each launch so the L2 starts cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.add_(1)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


# ------------------------------------------------------------------ paged --
def paged_inputs(dev, kind, seed):
    """Synthetic inputs at the engine step's shapes: T=32 rows, H=12,
    dh=64, ps=16, PP=32, NP=513, positions over the whole view, two
    dead rows on the scratch page."""
    g = torch.Generator().manual_seed(seed)
    T, H, dh, ps, PP, NP = SLOTS + CHUNK, HEADS, D // HEADS, PAGE, 32, 513
    cdt = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn(T, H, dh, generator=g).to(dev, cdt)
    if kind == "int8":
        pool = torch.randint(-127, 128, (NP, ps, H, 2 * dh), generator=g,
                             dtype=torch.int8).to(dev)
        s = (torch.rand(NP, 2, ps, H, generator=g) * 0.02 + 1e-4).to(dev)
    else:
        pool = torch.randn(NP, ps, H, 2 * dh, generator=g).to(dev, cdt)
        s = None
    bt = torch.randint(1, NP, (T, PP), generator=g, dtype=torch.int32)
    pos = torch.randint(0, PP * ps, (T,), generator=g, dtype=torch.int32)
    bt[:2] = 0
    pos[:2] = 0
    pos[2] = PP * ps - 1
    return q, pool, s, bt.to(dev), pos.to(dev)


def paged_work(q, pool, s, bt, pos, ps):
    """(bytes, flops) the call needs.  Bytes: q, each distinct page the
    rows walk read once (all heads, with its scale planes), the
    block-table entries walked, the positions, the f32 output.  FLOPs:
    4*dh per (row, head, attended position)."""
    T, H, dh = q.shape
    PP = bt.shape[1]
    last = torch.clamp(pos.long() // ps, max=PP - 1)
    walk = torch.arange(PP, device=bt.device)[None, :] <= last[:, None]
    pages = int(torch.unique(bt[walk]).numel())
    page_bytes = (ps * H * 2 * dh * pool.element_size()
                  + (2 * ps * H * 4 if s is not None else 0))
    nbytes = (q.numel() * q.element_size() + pages * page_bytes
              + int(walk.sum()) * 4 + pos.numel() * 4 + T * H * dh * 4)
    attended = int((torch.clamp(pos.long(), max=PP * ps - 1) + 1).sum())
    return nbytes, 4 * attended * H * dh


def paged_limit(PA, q, pool, s, bt, pos):
    """Per-element limit on |kernel - plain| for a bf16 or int8 pool
    (see PAGED_ROUND): the plain version run with |v| in place of v."""
    dh = q.shape[2]
    absv = torch.cat([pool[..., :dh], pool[..., dh:].abs()], -1)
    return 1e-5 + PAGED_ROUND * PA.paged_attention_reference(
        q, absv, s, bt, pos, page_size=PAGE)


def check_paged(PA, name, got, q, pool, s, bt, pos, failures):
    ref = PA.paged_attention_reference(q, pool, s, bt, pos, page_size=PAGE)
    if q.dtype == torch.float32 and s is None:
        return check(name, got, ref, failures, tol=TOL[("paged",
                                                        "float32")])
    return check(name, got, ref, failures,
                 limit=paged_limit(PA, q, pool, s, bt, pos))


def paged_library(q, pool, bt, pos, ps):
    """Yardstick only (never called by the port): block-table gather +
    torch SDPA over the float pool."""
    T, H, dh = q.shape
    L = bt.shape[1] * ps
    kv = pool[bt.long()].view(T, L, H, 2 * dh).transpose(1, 2)
    keep = (torch.arange(L, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None, :], kv[..., :dh], kv[..., dh:], attn_mask=keep)


# ------------------------------------------------------------------ flash --
def flash_inputs(dev, T, dtype, use_mask, seed):
    g = torch.Generator().manual_seed(seed)
    B, H, dh = 4, HEADS, D // HEADS
    q, k, v = (torch.randn(B, T, H, dh, generator=g).to(dev, dtype)
               for _ in range(3))
    mask = None
    if use_mask:
        mask = torch.rand(B, T, generator=g) > 0.2
        mask[:, :8] = True
        mask = mask.to(dev)
    return q, k, v, mask


def flash_work(q, causal):
    B, T, H, dh = q.shape
    pairs = T * (T + 1) // 2 if causal else T * T
    nbytes = 4 * q.numel() * q.element_size() + B * T + B * H * T * 4
    return nbytes, 4 * B * H * dh * pairs


def bound(nbytes, flops, dtype):
    peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
    t_b, t_f = nbytes / PEAK_BYTES, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def profile_steps(ServingEngine, params, cfg, reqs, dev, warm=60, n=20):
    """Information: one torch.profiler window of ``n`` engine steps
    (bf16/w8, float KV) after ``warm`` steps — host time per step,
    device busy time per step, the device's idle share, and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, device=dev)
    for p, n_new in reqs:
        eng.submit(p, n_new)
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            t, c = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (t + ev.time_range.elapsed_us(), c + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3 / n
    if busy_ms == 0.0:
        log("info: profile: the profiler recorded no device time "
            "(not measured)")
        return
    log("info: profile of %d engine steps: %.3f ms/step wall, %.3f "
        "ms/step device busy, device idle share %.3f, %d kernels/step"
        % (n, wall_ms, busy_ms, 1.0 - busy_ms / wall_ms,
           sum(c for _, c in by_name.values()) // n))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (t, c) in top:
        log("info:   %7.3f ms/step %5.1f%%  %4d/step  %s"
            % (t / 1e3 / n, 100.0 * t / 1e3 / n / busy_ms, c // n,
               name[:90]))


# ------------------------------------------------------------------- main --
def serve(G, ServingEngine, params, cfg, reqs, kv_int8, dev, spy=None):
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, kv_int8=kv_int8, device=dev)
    rids = [eng.submit(p, n) for p, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while True:
        if spy is not None:
            spy["step"] = steps
        if eng.step() is False:
            break
        steps += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    bad = [r for r in rids if eng.requests[r].state != "done"
           or len(eng.requests[r].generated) != eng.requests[r]
           .max_new_tokens]
    toks = sum(len(eng.requests[r].generated) for r in rids)
    outs = {r: eng.requests[r].output for r in rids}
    log("serve kv_int8=%s: %d requests, %d steps, %d tokens in %.3f s "
        "(%.1f tok/s), pages in use after %d, peak pages %d"
        % (kv_int8, len(rids), steps, toks, dt, toks / dt,
           eng.cache.pages_in_use, eng.stats["peak_pages"]))
    if bad:
        raise Failed("requests not finished: %s" % bad[:8])
    if eng.cache.pages_in_use != 0:
        raise Failed("pages leaked: %d" % eng.cache.pages_in_use)
    for r in rids:
        o = outs[r]
        if o.min() < 0 or o.max() >= cfg.vocab_size:
            raise Failed("token out of the vocabulary in request %d" % r)
    return outs, {"steps": steps, "tokens": toks, "seconds": dt}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.kernels import paged_attention as PA
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.serving import engine as E

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card:", card_line())
    dev = torch.device("cuda", 0)
    failures = []

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as ex:   # one nvcc each
        list(ex.map(_build.load, _build.SOURCES))
    log("build: %d kernels in %.1f s" % (len(_build.SOURCES),
                                          time.perf_counter() - t0))

    # ---- 3. each kernel against its plain version at the path's shapes
    errs = {"paged": 0.0, "flash": 0.0}
    for i, kind in enumerate(("float32", "bfloat16", "int8")):
        q, pool, s, bt, pos = paged_inputs(dev, kind, seed=10 + i)
        got = PA.paged_attention(q, pool, s, bt, pos, page_size=PAGE)
        torch.cuda.synchronize()
        check_paged(PA, "paged %s T=32 H=12 dh=64 ps=16 PP=32" % kind, got,
                    q, pool, s, bt, pos, failures)
    for i, (T, causal, use_mask, dtype) in enumerate([
            (192, True, False, torch.float32),
            (512, True, True, torch.float32),
            (192, True, False, torch.bfloat16),
            (512, True, True, torch.bfloat16),
            (512, False, True, torch.bfloat16)]):
        q, k, v, mask = flash_inputs(dev, T, dtype, use_mask, seed=20 + i)
        o, lse = FA.flash_fwd(q, k, v, mask=mask, causal=causal)
        torch.cuda.synchronize()
        o_r, lse_r = FA.flash_fwd_reference(q, k, v, mask=mask,
                                            causal=causal)
        dn = str(dtype).split(".")[-1]
        tag = "flash %s B=4 T=%d causal=%s mask=%s" % (dn, T, causal,
                                                       use_mask)
        e = check(tag + " O", o, o_r, failures, tol=TOL[("flash", dn)])
        check(tag + " lse", lse, lse_r, failures, tol=LSE_TOL[dn])
        if T == 192 and dtype == torch.bfloat16:
            errs["flash"] = e

    # ---- 4. the main path, counters from 0
    cfg = G.gpt_config(vocab_size=VOCAB, max_len=MAX_LEN, d_model=D,
                       n_heads=HEADS, n_layers=LAYERS, d_ff=FF,
                       dtype="bfloat16", dropout=0.0)
    master = G.init_params(0, cfg, device=dev)
    params = G.prepare_params(G.quantize_decode_params(master), cfg, dev)
    reqs = workload(0)
    log("mix: %d requests, prompt tokens %d, new tokens %d"
        % (len(reqs), sum(p.size for p, _ in reqs),
           sum(n for _, n in reqs)))

    # capture the paged kernel's real inputs at one mid-run step
    captured = {}
    spy = {"step": -1}
    orig = E.paged_attention

    def capturing(q, pool_kv, pool_s, bt, pos, *, page_size):
        key = "int8" if pool_s is not None else "bfloat16"
        if spy["step"] == 60 and key not in captured:
            captured[key] = tuple(
                None if x is None else x.clone()
                for x in (q, pool_kv, pool_s, bt, pos))
        return orig(q, pool_kv, pool_s, bt, pos, page_size=page_size)

    E.paged_attention = capturing
    longest = [i for i, (p, _) in enumerate(reqs) if p.size == 192][:4]
    if len(longest) < 4:
        raise Failed("the mix has fewer than 4 prompts of 192 tokens")
    prompts = np.stack([reqs[i][0] for i in longest])
    FA.flash_fwd.launches = 0
    PA.paged_attention.launches = 0
    try:
        outs16, run16 = serve(G, ServingEngine, params, cfg, reqs, False,
                              dev, spy)
        outs8, run8 = serve(G, ServingEngine, params, cfg, reqs, True,
                            dev, spy)
        t0 = time.perf_counter()
        gen = G.generate(params, cfg, prompts, 64, device=dev)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
    finally:
        E.paged_attention = orig
    launches = {"paged_attention": PA.paged_attention.launches,
                "flash_fwd": FA.flash_fwd.launches}
    log("main path launches:", json.dumps(launches))
    steps = run16["steps"] + run8["steps"]
    log("paged_attention launches per engine step: %.2f (%d layers)"
        % (launches["paged_attention"] / steps, LAYERS))
    log("generate: (4, 192) + 64 new tokens in %.3f s" % t_gen)
    if tuple(gen.shape) != (4, 256) or int(gen.min()) < 0 \
            or int(gen.max()) >= VOCAB:
        raise Failed("generate returned %s" % (tuple(gen.shape),))
    for name, n in launches.items():
        if n <= 0:
            raise Failed("%s was never launched on the main path" % name)
    gen_np = gen.cpu().numpy()
    agree = np.mean([np.mean(outs16[i][192:256] ==
                             gen_np[j, 192:192 + outs16[i].size - 192])
                     for j, i in enumerate(longest)])
    log("info: bf16/w8 engine vs generate, new tokens of the 4 longest "
        "prompts (up to 64 each): %.3f agreement" % agree)
    with torch.inference_mode():
        logits, _ = G._prefill_full(params, cfg,
                                    torch.as_tensor(prompts).to(dev).long(),
                                    256)
    if not bool(torch.isfinite(logits).all()) or \
            tuple(logits.shape) != (4, VOCAB):
        raise Failed("prefill logits not finite / wrong shape")

    # ---- 5. the paged kernel on the captured engine inputs
    for key in ("bfloat16", "int8"):
        if key not in captured:
            raise Failed("no paged_attention inputs captured (%s)" % key)
        q, pool, s, bt, pos = captured[key]
        got = PA.paged_attention(q, pool, s, bt, pos, page_size=PAGE)
        torch.cuda.synchronize()
        live = int((bt[:, 0] != 0).sum())
        e = check_paged(PA, "paged %s captured engine step (%d live rows)"
                        % (key, live), got, q, pool, s, bt, pos, failures)
        if key == "bfloat16":
            errs["paged"] = e

    # ---- 6. timings at the path's shapes
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    kernels = []
    q, pool, s, bt, pos = captured["bfloat16"]
    ms = cuda_ms(lambda: PA.paged_attention(q, pool, s, bt, pos,
                                            page_size=PAGE), flush=flush)
    plain = cuda_ms(lambda: PA.paged_attention_reference(
        q, pool, s, bt, pos, page_size=PAGE), flush=flush)
    lib = cuda_ms(lambda: paged_library(q, pool, bt, pos, PAGE),
                  flush=flush)
    b_ms, b_by = bound(*paged_work(q, pool, s, bt, pos, PAGE), q.dtype)
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/kernels/paged_attention.py:209",
        "launches": launches["paged_attention"],
        "max_abs_err": errs["paged"], "tolerance": PAGED_TOL_TEXT,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib,
        "shape": "captured engine step, bf16 pool: T=32 H=12 dh=64 ps=16 "
                 "PP=32 NP=513"})
    q8, pool8, s8, bt8, pos8 = captured["int8"]
    ms8 = cuda_ms(lambda: PA.paged_attention(q8, pool8, s8, bt8, pos8,
                                             page_size=PAGE), flush=flush)
    plain8 = cuda_ms(lambda: PA.paged_attention_reference(
        q8, pool8, s8, bt8, pos8, page_size=PAGE), flush=flush)
    b8 = bound(*paged_work(q8, pool8, s8, bt8, pos8, PAGE), q8.dtype)
    log("info: paged int8 captured step: kernel %.4f ms, plain %.4f ms, "
        "bound %.4f ms (%s)" % (ms8, plain8, b8[0], b8[1]))

    for T in (192, 512):
        q, k, v, _ = flash_inputs(dev, T, torch.bfloat16, False, seed=30)
        ms = cuda_ms(lambda: FA.flash_fwd(q, k, v, causal=True),
                     flush=flush)
        plain = cuda_ms(lambda: FA.flash_fwd_reference(q, k, v,
                                                       causal=True),
                        flush=flush)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True), flush=flush)
        b_ms, b_by = bound(*flash_work(q, True), q.dtype)
        row = {"name": "flash_fwd", "route": "cuda",
               "source": "mxnet_tpu_torch/kernels/csrc/flash_fwd.cu",
               "replaces": "mxnet_tpu/kernels/flash_attention.py:169",
               "launches": launches["flash_fwd"],
               "max_abs_err": errs["flash"],
               "tolerance": TOL[("flash", "bfloat16")],
               "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib,
               "shape": "bf16 causal B=4 T=%d H=12 dh=64" % T}
        if T == 192:                       # the generate prefill's shape
            kernels.append(row)
        else:
            log("info: flash T=512:", json.dumps(row))

    profile_steps(ServingEngine, params, cfg, reqs, dev)

    # ---- 7. small float32 engine on the card vs generate on the CPU
    tiny = G.gpt_tiny(dtype="float32", vocab_size=128, max_len=64,
                      dropout=0.0)
    tp = G.init_params(3, tiny, device="cpu")
    eng = ServingEngine(tp, tiny, num_slots=3, page_size=4,
                        prefill_chunk=6, device=dev)
    rng = np.random.RandomState(0)
    small = [(rng.randint(1, 90, P).astype(np.int32), N)
             for P, N in [(5, 8), (3, 12), (9, 4), (2, 6), (7, 10)]]
    rids = [eng.submit(p, n) for p, n in small]
    outs = eng.run()
    hits = [np.mean(outs[r] == G.generate(tp, tiny, p[None], n,
                                          device="cpu")[0].numpy())
            for r, (p, n) in zip(rids, small)]
    log("check small f32 engine (cuda) vs generate (cpu): agreement "
        "%.3f (need >= 0.9)" % np.mean(hits))
    if np.mean(hits) < 0.9:
        failures.append("small f32 engine vs generate")

    f32cfg = G.gpt_config(**{**cfg.__dict__, "dtype": "float32"})
    few = [(p[:64], 32) for p, _ in reqs[:4]]
    eng = ServingEngine(master, f32cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, device=dev)
    rids = [eng.submit(p, n) for p, n in few]
    outs = eng.run()
    same = [np.mean(outs[r] == G.generate(master, f32cfg, p[None], n,
                                          device=dev)[0].cpu().numpy())
            for r, (p, n) in zip(rids, few)]
    log("info: full-width f32 engine vs generate on the card, 4 requests:"
        " %.3f token agreement" % np.mean(same))

    if failures:
        raise Failed("checks failed: %s" % ", ".join(failures))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
