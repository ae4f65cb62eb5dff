#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel from ``kernels/csrc`` (one ``nvcc`` per source,
   all at once) and prints, for each flash, paged and conv kernel,
   ptxas's registers, spills and shared memory and the tensor-core
   (HMMA) instructions in its SASS (``cuobjdump``, where the toolkit has
   it); the bf16 conv kernel must have some;
3. holds each kernel against its plain PyTorch version on the card at
   the paths' shapes, each check with its stated tolerance: the split
   paged kernels at the engine step's shapes (f32, bf16 and int8 pools,
   16-byte and scalar loads, two calls bit-identical) and the flash
   forward at the serving shapes; the flash
   forward (with dropout), dQ and dK/dV at BERT-base's (B=16, T=512,
   H=12, dh=64) and at head dim 256 (B=2, T=512, H=4), in f32 and bf16,
   causal or not, with a padding mask or without, at dropout 0 and 0.1;
   the bf16 dQ at dh 64, 128 and 256 and T = 1, 17, 100 and 513;
   the two grouped SGD kernels bit for bit on ResNet-50's parameter
   group and on a group of odd sizes, clip on and off, wd 0 and 1e-4;
   the fused 3x3 convolution at batch 16 on the four ResNet-50 shapes;
4. serves the ``full`` serving preset (GPT vocab 32000, d_model 768,
   12 heads, 12 layers, d_ff 3072, max_len 512, bf16, weight-only
   int8, random weights from a seed) the preset's 64-request mix
   through ``ServingEngine`` (16 slots, page 16, prefill chunk 16)
   with float KV and with int8 KV, first with the step run op by op
   (``_eager``; a spy keeps the paged kernel's inputs at step 60), then
   as a user runs it, the step replayed as a CUDA graph, with every
   launch counter set to 0, then ``generate`` on 4 prompts; asserts
   every request finished, no page leaked, each kernel launched (the
   paged kernel once a layer a step under replay), and the captured
   engines' tokens identical to the eager ones;
5. holds the paged kernel against its plain version on the inputs kept
   from the live engine (its real pools, block table and positions);
6. drives the training paths, each with the counters set to 0 just
   before it and read just after: 20 steps of BERT-base masked-LM
   pretraining (bs 16 x 512, dropout 0.1, bf16, AdamW, no remat) on
   one synthetic batch, asserting finite, falling loss and 12 launches
   of each flash kernel per step, then one step with remat against one
   without from the same state; and 12 steps of causal GPT training at
   the ``full`` width (bs 8 x 512); each step replays one CUDA graph;
   for each, 3 steps replayed against 3 run op by op from one seed,
   bit for bit, and the step time of both in turns; a small f32 BERT
   trains 3 steps on the card and on the CPU from the same weights,
   losses compared;
7. drives the Gluon path as an MXNet user writes it (``import
   mxnet_tpu_torch as mx``): ResNet-50 v1 (7x7/s2 stem, 1000 classes,
   f32, NCHW) on ``mx.gpu(0)`` with Xavier init from
   ``np.random.seed(0)``, 20 ``gluon.Trainer`` steps (SGD lr 0.1,
   momentum 0.9) on one synthetic 64 x 3 x 224 x 224 batch, TF32
   convolutions (PyTorch's default, printed); then, on one step's
   gradients and from one state, the Trainer's per-tensor update
   against ``nd.multi_sgd_mom_update`` (and ``nd.sgd_update`` against
   ``nd.multi_sgd_update``) over the whole group, bit for bit, each
   grouped call one kernel launch; a thumbnail ResNet-18 trains 3 steps
   on the card (TF32 off) and on the CPU from the same weights, losses
   compared; then 20 more steps of the same net after
   ``net.hybridize()`` (forward and backward as CUDA graphs, the
   Trainer's update per tensor as before), images/s beside the eager
   loop's;
7b. drives bench.py's workload (the ``bench`` phase; the BERT and GPT
   steps' graphs freed first): ResNet-50 v1 with the space-to-depth
   stem, ``amp=True``, bs 128, through ``DataParallelTrainer.run_steps``
   over ``make_mesh({"dp": -1})`` (a CUDA graph of one whole step,
   replayed each step): 3 steps replayed against 3 run with ``_eager``
   from the same weights, bit for bit under deterministic cuDNN; then,
   with every launch counter from 0 (all stay 0: no hand-written kernel
   is on this path), one warm and two timed ``run_steps(20)``
   dispatches in turns with the 7x7 stem, a profiled window captured
   and op by op, and ``BENCH_AMP=0`` (f32, bs 64) beside the Gluon
   Trainer's hybridized figure; a ResNet-18 with the stem trains 3
   ``DataParallelTrainer`` steps on the card and on the CPU from the
   same weights, f32 (TF32 off) and ``amp=True``, losses compared;
8. times each kernel, its plain version and a library call at the
   paths' shapes (L2 flushed between launches) beside the least time
   the card could take for the same work: the flash, paged and SGD
   kernels and SDPA by their device time (torch.profiler, 20 calls)
   with CUDA events around the call beside it, the others by CUDA
   events; logs the operations SDPA ran; profiles 20 engine steps, 8
   BERT steps, 6 GPT steps and 8 ResNet steps (torch.profiler), each
   op by op and captured, for the device's busy time (kernels, copies
   and fills; annotation spans left out) and idle share;
9. drives the extension surface, each path with its counters from 0:
   the twin of ``benchmark/fused_conv_exp.py`` (the ResNet-50 3x3
   convolutions at batch 128, conv and BN->conv->stats chain, 3 steps
   each) through ``conv3x3_fused``, after holding the kernel against its
   plain version at batch 16 (four flag sets, bf16, and f32) in step 3;
   ``mx.rtc`` checks (axpy at 51.4 M values, a 3-D-grid transpose with
   66 KB of dynamic shared memory, a ``__half`` kernel, a compile error)
   and a ReLU ``CustomOp`` whose forward and backward launch rtc
   kernels, bit for bit against ``nd.Activation`` at 64 x 64 x 112 x 112
   and in a 3-step Gluon Trainer run; then times the conv kernel (kernel,
   plain, cuDNN, bound) at the four shapes and the rtc axpy;
10. checks a small float32 engine on the card against ``generate`` on
   the CPU, and the full-width float32 engine, captured, against the
   same engine op by op and against ``generate`` on the card, token for
   token;
11. prints the compiled steps' numbers (eager and captured), the
   ``kernels`` JSON line and, last, the device line.

Exits non-zero, printing no result, without a CUDA device, when a
kernel does not build or launch, or when any check fails.

``python3 chip_smoke.py --parent DIR``, with DIR another checkout of
this repository (the parent commit unpacked by ``git archive`` into a
directory ``.gitignore`` lists), also times, in turns (parent, change,
change, parent) in one process on one card: DIR's flash forward, dQ
and dK/dV against this tree's; DIR's paged kernel against this tree's
for f32, bf16 and int8 pools; the BERT-base and GPT train steps with
DIR's flash kernels against this tree's; the ``full`` serving mix
with DIR's paged kernel bound into the engine against this tree's; and
DIR's ``conv3x3_fused`` against this tree's at the conv path's four
batch-128 shapes, conv alone and chain.
"""
import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import time
import types
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

# BERT-base masked-LM pretraining, the training workload of
# docs/perf.md:157-166 (bs 16 x 512, dropout 0.1, bf16 compute, f32
# master params, AdamW lr 1e-4 wd 0.01, no remat)
BERT = dict(vocab_size=30522, max_len=512, d_model=768, n_heads=12,
            n_layers=12, d_ff=3072, dropout=0.1, dtype="bfloat16",
            param_dtype="float32", remat=False, use_flash=True)
BERT_B, BERT_T, BERT_STEPS, BERT_WARM, BERT_PROFILE = 16, 512, 20, 5, 8
GPT_B, GPT_STEPS, GPT_WARM, GPT_PROFILE = 8, 12, 2, 6
# training kernels against their plain versions: f32 differs by
# summation order only, 1e-4 on dQ/dK/dV at unit-scale inputs (the JAX
# tests' bar, tests/test_flash_backward.py:47; the forward keeps 1e-5).
# The bf16 forward is held against the plain version run in f32 on the
# same bf16 inputs, so the logits are not rounded on either side; the
# kernel rounds each kept, scaled p~ to bf16 before P~V (2^-8 relative
# at most, so at most 2^-8 x sum_j p_j |v_j| per element: the plain
# version on |v|) and rounds O to bf16 (2^-8 of |O|).  The limit is
# 2^-8 x (that + |O|) with 2% and 1e-5 to spare for f32 summation
# order; its lse, f32 on both sides, keeps the f32 1e-4.
FWD_ROUND = 2.0 ** -8 * 1.02
FWD_TOL_TEXT = "1e-5 + 1.02*2^-8*(|O| + f32 plain version on |v|)"
# bf16 backward: kernel and plain version round P~ (before dV) and dS
# (before dQ and dK) to bf16 at the same places and sum in f32, so they
# differ by one output ulp (at most 2^-7 of |plain|) plus the terms whose rounding
# f32 summation noise flips to the next bf16 value, each at most 2^-7 x
# the largest term |P~ or dS| x |dO, Q or K| of its sum; the limit
# allows 4 such flips per element.  Besides, dS = P*(dP - delta)*scale
# cancels where P sits on one key (dP ~ delta), and there its f32 noise
# (a few ulps of |dP| + |delta|) is all of dS and can flip its sign: the
# limit adds 2^-20 x the sum of P~*|dO| (dV) or P*(|dP| + |delta|)*scale
# (dQ, dK) times the largest |dO, K or Q|, plus 1e-6.
BWD_TOL_F32 = 1e-4
BF16_ULP = 2.0 ** -7
BWD_FLIPS = 4
F32_NOISE = 2.0 ** -20
BWD_TOL_TEXT = ("f32 1e-4*(1+|plain|); bf16 2^-7*|plain| + 4*2^-7*max|P~ "
                "or dS|*max|dO, Q or K| + 2^-20*sum(P*(|dP|+|delta|)*scale "
                "or P~)*max|K, Q or dO| + 1e-6")
# the small f32 model trained on the card and on the CPU: losses agree
# within f32 summation-order noise carried through 3 AdamW steps
SMALL_LOSS_TOL = 1e-4
# remat on vs off: the recompute runs the same kernels on the same
# inputs, so only library algorithm choice or atomics can differ
REMAT_LOSS_TOL, REMAT_GRAD_TOL = 1e-5, 1e-3

# the dh-256 kernel checks and timings: as many (token, width) values
# as BERT-base's attention for the timing (H=3 x dh 256 = 768)
DH256_CHECK = dict(B=2, H=4)
DH256_TIME = dict(B=16, H=3)

# ResNet-50 v1 training, bench.py's non-AMP configuration (bench.py:27,
# :46): batch 64 x 3 x 224 x 224, 1000 classes, f32 NCHW, SGD lr 0.1
# momentum 0.9, the literal 7x7/s2 stem; depth not cut
RESNET_B, RESNET_HW, RESNET_CLASSES = 64, 224, 1000
RESNET_STEPS, RESNET_WARM, RESNET_PROFILE = 20, 5, 8
RESNET_WINDOW = 5               # steps 6-20 timed in three windows
RESNET_LR, RESNET_MOM = 0.1, 0.9
# the thumbnail ResNet-18 trained 3 steps on the card and on the CPU
# (f32, TF32 off, lr 0.01): a ReLU network's gradient jumps where a
# pre-activation crosses zero, and f32 summation order moves some across
# (tests/test_torch_gluon.py measures a 2^-20 change of the input moving
# first-step gradients by 0.9%), so the losses agree within 3%
# card vs CPU mean-loss limits of the thumbnail ResNet-18, times (1 + |loss|):
# the first step (same weights, a forward) and the later ones, about 3x
# the largest gaps of sound H100 runs (1e-6, then 6e-5 at losses < 0.1)
SMALL_RESNET_LOSS_TOL = (1e-5, 2e-4)

# bench.py's workload (bench.py:27-52): ResNet-50 v1 with the
# space-to-depth stem, Xavier from np.random.seed(0), DataParallelTrainer
# SGD lr 0.1 momentum 0.9 over make_mesh({"dp": -1}) with amp=True, bs 128
# x 3 x 224 x 224, labels randint(0, 1000); BENCH_AMP=0 is f32 at bs 64;
# depth not cut.  One run_steps dispatch is BENCH_STEPS steps (bench.py
# takes 150; 20 keep the phase near a minute)
BENCH_B, BENCH_F32_B = 128, 64
BENCH_STEPS, BENCH_CHECK, BENCH_PROFILE = 20, 3, 5
# the small DataParallelTrainer runs on the card and on the CPU from the
# same weights: ResNet-18 v1 with the stem at 64 x 64, batch 8 (the last
# stage's BatchNorm then normalises 32 values a channel; with fewer, or a
# step large enough to take the loss from 3.9 to 0.17, rounding
# differences of 1e-6 at step 1 grow to 1e-4 by step 3).  f32 with TF32
# off at lr 1e-3, held to SMALL_RESNET_LOSS_TOL; amp=True at lr 1e-4 (the
# loss stays away from 0 over the 3 steps), held to the bf16 limits of
# tests/test_torch_data_parallel.py: step 1 within 1e-2 and the later
# steps within 2e-2 of the CPU's loss
BENCH_SMALL = {"f32": (8, 1e-3), "amp": (8, 1e-4)}
AMP_LOSS_TOL = (1e-2, 2e-2)


def log(*a):
    print(*a, flush=True)


class Failed(Exception):
    pass


_PHASE = {"start": None, "last": None}


def phase(name):
    """Log the seconds the phase that ends here took, and since start."""
    now = time.perf_counter()
    if _PHASE["start"] is None:
        _PHASE["start"] = _PHASE["last"] = now
    log("phase %s: %.1f s (%.1f s since start)"
        % (name, now - _PHASE["last"], now - _PHASE["start"]))
    _PHASE["last"] = now


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
    the limit, the largest error / limit and the typical output size,
    mean |ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if limit is None:
        limit = tol + tol * ref.abs()
        what = "tol %.0e" % tol
    else:
        what = "limit %.2e..%.2e" % (float(limit.min()), float(limit.max()))
    ok = bool((err <= limit).all()) and bool(torch.isfinite(got).all())
    log("check %-44s max_abs_err %.3e  %s  err/limit %.3f  mean|ref| %.3e"
        "  %s" % (name, float(err.max()), what, float((err / limit).max()),
                  float(ref.abs().mean()), "ok" if ok else "FAIL"))
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


def offset_pool(pool):
    """The same pool one element into a larger buffer: not 16-byte
    aligned, so the kernels take their scalar load loop."""
    flat = torch.empty(pool.numel() + 1, dtype=pool.dtype,
                       device=pool.device)
    flat[1:] = pool.reshape(-1)
    return flat[1:].view(pool.shape)


def check_paged_kernels(PA, dev, failures):
    """The split paged kernels against their plain version at the engine
    step's shapes, f32, bf16 and int8 pools, on both load paths (16-byte
    pieces, and the scalar loop on an offset pool), and bit for bit from
    one call to the next.  Returns {kind: largest error}."""
    errs = {}
    for i, kind in enumerate(("float32", "bfloat16", "int8")):
        q, pool, s, bt, pos = paged_inputs(dev, kind, seed=10 + i)
        for path, pl in (("16-byte loads", pool),
                         ("scalar loads", offset_pool(pool))):
            if PA.vector_loads(pl, q.shape[2]) != (path == "16-byte loads"):
                raise Failed("paged %s: the %s pool took the other load "
                             "path" % (kind, path))
            got = PA.paged_attention(q, pl, s, bt, pos, page_size=PAGE)
            again = PA.paged_attention(q, pl, s, bt, pos, page_size=PAGE)
            torch.cuda.synchronize()
            tag = "paged %s T=32 H=12 dh=64 ps=16 PP=32 %s" % (kind, path)
            e = check_paged(PA, tag, got, q, pool, s, bt, pos, failures)
            same = torch.equal(got, again)
            log("check %-44s two calls bit-identical  %s"
                % (tag, "ok" if same else "FAIL"))
            if not same:
                failures.append(tag + " bit identity")
            errs[kind] = max(errs.get(kind, 0.0), e)
    return errs


PAGED_MS_FROM = ("profiler: device time of the split and combine kernels "
                 "a call, mean of 20 calls, L2 flushed before each; "
                 "event_ms: CUDA events around the wrapper, mean of 30")


def time_paged(PA, q, pool, s, bt, pos, flush):
    """Device and event ms of one call of the paged kernels (both
    launches), the plain version's, the bound and the gather + SDPA
    yardstick (device time of every operation it runs)."""
    def kern():
        return PA.paged_attention(q, pool, s, bt, pos, page_size=PAGE)

    b_ms, b_by = bound(*paged_work(q, pool, s, bt, pos, PAGE), q.dtype)
    row = {"ms": device_time(kern, flush, "paged_")[0],
           "ms_from": PAGED_MS_FROM, "event_ms": cuda_ms(kern, flush=flush),
           "plain_ms": cuda_ms(lambda: PA.paged_attention_reference(
               q, pool, s, bt, pos, page_size=PAGE), flush=flush),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if s is None:
        row["library_ms"] = device_time(
            lambda: paged_library(q, pool, bt, pos, PAGE), flush)[0]
        row["library_event_ms"] = cuda_ms(
            lambda: paged_library(q, pool, bt, pos, PAGE), flush=flush)
    return row


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


def attn_pairs(q, mask, causal):
    """(query, key) pairs the attention needs on these inputs: keys the
    mask keeps, at or below the diagonal when causal, every head."""
    B, T, H, _ = q.shape
    keep = (torch.ones(B, T, device=q.device) if mask is None
            else mask.float())
    per_key = (T - torch.arange(T, device=q.device).float() if causal
               else torch.full((T,), float(T), device=q.device))
    return H * int((keep * per_key).sum())


def flash_work(q, mask, causal, kind="fwd"):
    """(bytes, flops) of a flash kernel: each input read once, each
    output written once, K and V only at the keys the mask keeps (a
    masked key reaches no output); q, dO, the per-query f32 rows (lse,
    delta), the mask and every output in full.  4*dh FLOPs per needed
    pair for the forward, 6*dh for dQ (S, dP, dS K), 8*dh for dK/dV
    (S, dP, dV, dK)."""
    B, T, H, dh = q.shape
    big = q.numel() * q.element_size()
    kept = 1.0 if mask is None else float(mask.float().mean())
    stats = B * H * T * 4                      # one (B, H, T) f32 row
    n_full, n_stats, per_pair = {"fwd": (2, 1, 4), "dq": (3, 2, 6),
                                 "dkv": (4, 2, 8)}[kind]
    nbytes = (n_full + 2 * kept) * big + n_stats * stats + B * T
    return nbytes, per_pair * dh * attn_pairs(q, mask, causal)


def bound(nbytes, flops, dtype):
    peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
    t_b, t_f = nbytes / PEAK_BYTES, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


# device-side profiler events that are device work: kernels, copies and
# fills.  Where this torch gives the profiler's own event kind
# (FunctionEvent.activity_type: "kernel", "gpu_memcpy", "gpu_memset",
# "gpu_user_annotation", ...), that decides; where it gives only
# is_user_annotation, that does; else a device event is dropped when the
# CPU side records an event of the same name (a record_function span,
# such as the optimizer step's, that the profiler mirrors on the device).
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def device_work(prof):
    """(the profiler's device events that are device work, the device
    events left out, which rule told them apart)."""
    from torch.autograd import DeviceType
    evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    if evs and all(getattr(ev, "activity_type", None) for ev in evs):
        keep = [ev.activity_type in DEVICE_WORK for ev in evs]
        how = "activity_type"
    elif evs and all(getattr(ev, "is_user_annotation", None) is not None
                     for ev in evs):
        keep = [not ev.is_user_annotation for ev in evs]
        how = "is_user_annotation"
    else:
        cpu = {ev.name for ev in prof.events()
               if ev.device_type == DeviceType.CPU}
        keep = [ev.name not in cpu for ev in evs]
        how = "names also recorded on the CPU side"
    return ([ev for ev, k in zip(evs, keep) if k],
            [ev for ev, k in zip(evs, keep) if not k], how)


def profile_window(step, n, what, top=8, kernels=()):
    """Information: one torch.profiler window of ``n`` calls of
    ``step`` — host time per step, device busy time per step (kernels,
    copies and fills only: ``device_work``), the device's idle share,
    and the ``top`` kernels that take the most device time.  Returns
    {"wall_ms", "busy_ms", "idle", "kernels_per_step"} (None when the
    profiler records no device time).

    A check too, with ``kernels`` = [(label, counter, symbols)]: the
    device kernels of the window whose name holds one of ``symbols``
    must number the change of ``counter()`` over the window — under
    replay the counters add the capture's change, so this holds them
    to what ran on the device.  The profiler there now and then loses
    events or a whole window, so a window that disagrees is logged and
    taken again, and the run fails after three that disagree (a replay
    that ran other kernels disagrees every time)."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, 4 if kernels else 2):
        torch.cuda.synchronize()
        before = [counter() for _, counter, _ in kernels]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        work, other, how = device_work(prof)
        by_name = {}
        for ev in work:
            t, c = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (t + ev.time_range.elapsed_us(), c + 1)
        seen = [(label, counter() - b0,
                 sum(c for name, (_, c) in by_name.items()
                     if any(sym in name for sym in symbols)))
                for (label, counter, symbols), b0 in zip(kernels, before)]
        bad = [x for x in seen if x[1] != x[2]]
        for label, counted, ran in seen:
            log("check profile of %d %s, attempt %d: %s counted %d "
                "launches, the device ran %d such kernels  %s"
                % (n, what, attempt, label, counted, ran,
                   "ok" if counted == ran else "MISMATCH"))
        if not bad:
            break
    if bad:
        raise Failed("profile of %s: the launch counters disagree with "
                     "the device kernels in three windows: %s"
                     % (what, json.dumps(bad)))
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3 / n
    if busy_ms == 0.0:
        log("info: profile: the profiler recorded no device time "
            "(not measured)")
        return None
    left = {}
    for ev in other:
        left[ev.name] = left.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    log("info: profile of %d %s: %.3f ms/step wall, %.3f "
        "ms/step device busy, device idle share %.3f, %d kernels/step "
        "(device work told apart by %s; left out %.3f ms/step of other "
        "device events: %s)"
        % (n, what, wall_ms, busy_ms, 1.0 - busy_ms / wall_ms,
           sum(c for _, c in by_name.values()) // n, how,
           sum(left.values()) / 1e3 / n, json.dumps(
               {k[:60]: round(t / 1e3 / n, 3) for k, t in sorted(
                   left.items(), key=lambda kv: -kv[1])[:4]})))
    for name, (t, c) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:top]:
        log("info:   %7.3f ms/step %5.1f%%  %4d/step  %s"
            % (t / 1e3 / n, 100.0 * t / 1e3 / n / busy_ms, c // n,
               name[:90]))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": sum(c for _, c in by_name.values()) / n}


def profile_steps(ServingEngine, params, cfg, reqs, dev, eager, kernels,
                  warm=60, n=20):
    """Profile ``n`` engine steps (bf16/w8, float KV) after ``warm``, the
    step captured or (``eager``) op by op, its paged kernels held to
    the launch counter (``kernels``, as profile_window takes them);
    returns profile_window's numbers."""
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, device=dev)
    eng._eager = eager
    for p, n_new in reqs:
        eng.submit(p, n_new)
    for _ in range(warm):
        eng.step()
    return profile_window(eng.step, n, "engine steps, %s"
                          % ("eager" if eager else "captured"),
                          kernels=kernels)


# --------------------------------------------------------------- training --
def train_inputs(dev, dtype, use_mask, seed, B=BERT_B, H=HEADS, dh=D // HEADS):
    """q, k, v, dO (B, 512, H, dh), BERT-base's head shape by default,
    and, with ``use_mask``, a padding mask whose rows keep a prefix of
    T/2..T keys."""
    g = torch.Generator().manual_seed(seed)
    T = BERT_T
    q, k, v, do = (torch.randn(B, T, H, dh, generator=g).to(dev, dtype)
                   for _ in range(4))
    mask = None
    if use_mask:
        lens = torch.randint(T // 2, T + 1, (B,), generator=g)
        lens[0] = T
        mask = (torch.arange(T)[None, :] < lens[:, None]).to(dev)
    return q, k, v, do, mask


def fwd_limit(FA, q, k, v, kw):
    """The bf16 forward's yardstick (see FWD_ROUND): (O, lse) of the
    plain version run in f32 on the same bf16 inputs, and the
    per-element limit on |kernel O - that O|."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    o, lse = FA.flash_fwd_reference(qf, kf, vf, **kw)
    on_abs_v = FA.flash_fwd_reference(qf, kf, vf.abs(), **kw)[0]
    return o, lse, FWD_ROUND * (on_abs_v + o.abs()) + 1e-5


def bwd_limits(FA, q, k, v, do, lse, delta, refs, kw):
    """Per-element bf16 limits on |kernel - plain| for dQ, dK and dV
    (see BF16_ULP); ``refs`` are the plain versions' (dQ, dK, dV)."""
    p, p_drop, dp, ds = FA._bwd_dense(q, k, v, do, lse, delta, kw["mask"],
                                      kw["causal"], kw["dropout"],
                                      kw["seed"])
    scale = q.shape[-1] ** -0.5
    ads, apd = ds.abs(), p_drop.abs()
    mag = p * (dp.abs() + delta.abs()[..., None]) * scale
    ak, aq, ado = (x.float().abs().amax(1)[:, None] for x in (k, q, do))

    def per_row(x):                          # (B, H, T) -> (B, T, H, 1)
        return x.transpose(1, 2)[..., None]

    terms = ((ads.amax(-1), mag.sum(-1), ak),      # dQ: sums over keys
             (ads.amax(-2), mag.sum(-2), aq),      # dK: sums over queries
             (apd.amax(-2), apd.sum(-2), ado))     # dV: sums over queries
    return [(BWD_FLIPS * BF16_ULP * per_row(big)
             + F32_NOISE * per_row(tot)) * a + 1e-6
            + BF16_ULP * r.float().abs()
            for (big, tot, a), r in zip(terms, refs)]


def check_training_kernels(FA, dev, failures):
    """The forward (with dropout), dQ and dK/dV kernels against their
    plain versions over dtype x causal x mask x dropout, at BERT-base's
    shapes (dh 64) and at head dim 256.  Returns the largest errors of
    the training path's own case (bf16, dh 64, not causal, padding mask,
    dropout 0.1) by kernel."""
    errs = {}
    cases = itertools.product((64, 256), (torch.float32, torch.bfloat16),
                              (False, True), (True, False), (0.0, 0.1))
    for i, (dh, dtype, causal, use_mask, dropout) in enumerate(cases):
        dn = str(dtype).split(".")[-1]
        shape = {} if dh == 64 else dict(DH256_CHECK, dh=dh)
        q, k, v, do, mask = train_inputs(dev, dtype, use_mask, seed=41 + i,
                                         **shape)
        seed = torch.tensor([1001 + i], dtype=torch.int32, device=dev)
        kw = dict(mask=mask, causal=causal, dropout=dropout, seed=seed)
        o, lse = FA.flash_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        refs = (FA.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
                *FA.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))
        tag = ("train %s B=%d T=512 H=%d dh=%d causal=%d mask=%d drop=%.1f"
               % (dn, q.shape[0], q.shape[2], dh, causal, use_mask, dropout))
        if dtype == torch.float32:
            o_r, lse_r = FA.flash_fwd_reference(q, k, v, **kw)
            e = {"flash_fwd": check(tag + " O", o, o_r, failures,
                                    tol=TOL[("flash", dn)])}
            lims = [None] * 3
        else:
            o_r, lse_r, o_lim = fwd_limit(FA, q, k, v, kw)
            e = {"flash_fwd": check(tag + " O (vs f32 plain)", o, o_r,
                                    failures, limit=o_lim)}
            lims = bwd_limits(FA, q, k, v, do, lse, delta, refs, kw)
        check(tag + " lse", lse, lse_r, failures, tol=LSE_TOL["float32"])
        got = [check(tag + " " + name, x, r, failures,
                     tol=BWD_TOL_F32 if lim is None else None, limit=lim)
               for name, x, r, lim in zip(("dQ", "dK", "dV"), (dq, dk, dv),
                                          refs, lims)]
        e["flash_bwd_dq"] = got[0]
        e["flash_bwd_dkv"] = max(got[1:])
        if dh == 64 and dn == "bfloat16" and not causal and use_mask \
                and dropout > 0:
            errs = e
        del q, k, v, do, o, dq, dk, dv, refs
    return errs


# dQ at lengths no tile divides: (causal, padding mask, dropout)
DQ_CASES = ((False, True, 0.1), (True, False, 0.1), (True, True, 0.0),
            (False, False, 0.0))


def check_dq_ragged(FA, dev, failures):
    """The bf16 dQ kernel (``flash_bwd_dq_tc``) against its plain version
    within ``bwd_limits`` at dh 64, 128 and 256, T = 1, 17, 100 and 513
    (partial query and key tiles), B=2, H=3, over DQ_CASES; lse and delta
    from the forward kernel.  With a mask and not causal the last batch
    row has every key masked; causal rows keep key 0 (ROADMAP.md C: a
    query whose keys up to the diagonal are all masked has no common
    answer).  Returns the largest error over limit."""
    worst = 0.0
    for i, (dh, T, (causal, use_mask, dropout)) in enumerate(
            itertools.product((64, 128, 256), (1, 17, 100, 513), DQ_CASES)):
        g = torch.Generator().manual_seed(300 + i)
        q, k, v, do = (torch.randn(2, T, 3, dh, generator=g)
                       .to(dev, torch.bfloat16) for _ in range(4))
        mask = None
        if use_mask:
            m = torch.rand(2, T, generator=g) > 0.3
            m[:, 0] = True
            if not causal:
                m[-1] = False
            mask = m.to(dev)
        kw = dict(mask=mask, causal=causal, dropout=dropout,
                  seed=torch.tensor([500 + i], dtype=torch.int32,
                                    device=dev))
        o, lse = FA.flash_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        refs = (FA.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
                *FA.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))
        lim = bwd_limits(FA, q, k, v, do, lse, delta, refs, kw)[0]
        err = (dq.float() - refs[0].float()).abs()
        ok = bool(torch.isfinite(dq.float()).all()) and bool(
            (err <= lim).all())
        worst = max(worst, float((err / lim).max()))
        if not ok:
            log("check dQ bf16 dh=%d T=%d causal=%d mask=%d drop=%.1f "
                "err/limit %.3f  FAIL" % (dh, T, causal, use_mask, dropout,
                                          float((err / lim).max())))
            failures.append("dQ dh=%d T=%d causal=%d mask=%d drop=%.1f"
                            % (dh, T, causal, use_mask, dropout))
    log("check dQ bf16 ragged: dh 64/128/256 x T 1/17/100/513 x %d cases, "
        "largest err/limit %.3f  %s" % (len(DQ_CASES), worst,
                                        "ok" if worst <= 1.0 else "FAIL"))
    return worst


def counters(FA):
    return {"flash_fwd": FA.flash_fwd.launches,
            "flash_bwd_dq": FA.flash_bwd_dq.launches,
            "flash_bwd_dkv": FA.flash_bwd_dkv.launches}


def zero_counters(FA, PA, FO):
    FA.flash_fwd.launches = 0
    FA.flash_bwd_dq.launches = 0
    FA.flash_bwd_dkv.launches = 0
    PA.paged_attention.launches = 0
    FO.fused_multi_sgd.sgd_launches = 0
    FO.fused_multi_sgd.sgd_mom_launches = 0


def bert_batch(seed=0):
    """One synthetic MLM batch at bs 16 x 512: tokens from a seeded
    numpy draw, 15% of the kept positions labelled (their token
    replaced by [MASK] = 103), a padded tail on every fourth row, and
    type ids in two segments."""
    rng = np.random.RandomState(seed)
    B, T = BERT_B, BERT_T
    tokens = rng.randint(1000, BERT["vocab_size"], (B, T))
    lens = np.full(B, T)
    lens[::4] = rng.randint(T // 2, T, len(lens[::4]))
    mask = np.arange(T)[None, :] < lens[:, None]
    pick = (rng.rand(B, T) < 0.15) & mask
    labels = np.where(pick, tokens, -100)
    tokens = np.where(mask, np.where(pick, 103, tokens), 0)
    split = rng.randint(T // 4, 3 * T // 4, B)
    type_ids = (np.arange(T)[None, :] >= split[:, None]) & mask
    return {"tokens": tokens, "labels": labels, "mask": mask,
            "type_ids": type_ids.astype(np.int64)}


def train_path(name, init_state, step, batch, dev, steps, warm, FA, PA, FO,
               per_step, seed):
    """Drive ``steps`` training steps with every counter set to 0 just
    before and read just after; assert finite, falling loss and
    ``per_step`` launches of each flash kernel per step.  Returns
    (state, losses, launches, seconds per step after ``warm``)."""
    state = init_state(seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    zero_counters(FA, PA, FO)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / (steps - warm)
    launches = counters(FA)
    losses = [float(x) for x in losses]
    log("%s: %d steps, losses %s" % (name, steps, " ".join(
        "%.4f" % x for x in losses)))
    log("%s launches: %s (%d layers x %d steps = %d each expected)"
        % (name, json.dumps(launches), per_step, steps, per_step * steps))
    if not all(np.isfinite(losses)):
        raise Failed("%s: loss not finite" % name)
    if not losses[-1] < losses[0]:
        raise Failed("%s: loss did not fall (%.4f -> %.4f)"
                     % (name, losses[0], losses[-1]))
    for kname, n in launches.items():
        if n != per_step * steps:
            raise Failed("%s: %s launched %d times, expected %d"
                         % (name, kname, n, per_step * steps))
    return state, losses, launches, per


def check_remat(T_, cfg, params, batch, dev, failures):
    """One step with remat and one without from the same params and the
    same generator seed: the same loss and gradients."""
    from mxnet_tpu_torch.convert import tree_leaves
    out = []
    for remat in (False, True):
        init_state, step = T_.make_train_step(
            dataclasses.replace(cfg, remat=remat), device=dev)
        state = init_state(params=params)
        gen = torch.Generator(device=dev).manual_seed(11)
        state, loss = step(state, batch, gen)
        out.append((float(loss), [p.grad for p in tree_leaves(state[0])]))
        del state
    (l0, g0), (l1, g1) = out
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g1, g0))
    ok = abs(l1 - l0) <= REMAT_LOSS_TOL * abs(l0) and worst <= REMAT_GRAD_TOL
    log("check remat vs no remat (BERT-base, one step): loss %.6f vs %.6f, "
        "largest grad diff / leaf max %.3e (tol %.0e)  %s"
        % (l1, l0, worst, REMAT_GRAD_TOL, "ok" if ok else "FAIL"))
    if not ok:
        failures.append("remat vs no remat")


def check_small_f32(T_, dev, failures):
    """A small f32 BERT (dh 64, dropout 0) trains 3 steps on the card
    and on the CPU from the same weights; the losses must agree."""
    cfg = T_.bert_tiny(d_model=128, n_heads=2, d_ff=256, max_len=128,
                       dtype="float32", dropout=0.0, remat=False)
    params = T_.init_params(5, cfg, device="cpu")
    rng = np.random.RandomState(5)
    tokens = rng.randint(1, cfg.vocab_size, (4, 128))
    mask = np.ones((4, 128), bool)
    mask[1, 90:] = False
    labels = np.where((rng.rand(4, 128) < 0.15) & mask, tokens, -100)
    batch = {"tokens": tokens, "labels": labels, "mask": mask}
    runs = []
    for where in (dev, "cpu"):
        init_state, step = T_.make_train_step(cfg, device=where)
        state = init_state(params=params)
        runs.append([float(step(state, batch, None)[1]) for _ in range(3)])
    ok = all(abs(a - b) <= SMALL_LOSS_TOL * (1 + abs(b))
             for a, b in zip(*runs))
    log("check small f32 BERT 3 steps, card vs CPU: %s vs %s (tol %.0e)  %s"
        % (" ".join("%.6f" % x for x in runs[0]),
           " ".join("%.6f" % x for x in runs[1]), SMALL_LOSS_TOL,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("small f32 BERT card vs CPU")


# the L2 flush, ``flush.add_(1)`` on a uint8 tensor: its one kernel's
# name holds this, and no timed call adds uint8 tensors
FLUSH_OP = "add<unsigned char>"


def device_time(fn, flush, match=None, calls=20):
    """(ms, {operation: ms}) per call of ``fn`` on the device, from the
    profiler over ``calls`` calls, the L2 flushed before each (the
    flush's own kernel left out), for the operations whose name contains
    ``match`` (every operation with ``match`` None, and then the flush
    must be told apart: about one a call).  A window that records none
    is taken again; after three, CUDA events around ``fn`` stand in, and
    the log says so.  Only device work counts (``device_work``)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window can come back with no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.add_(1)
                fn()
            torch.cuda.synchronize()
        seen = {}
        for ev in device_work(prof)[0]:
            if FLUSH_OP in ev.name or match is None or match in ev.name:
                t, c = seen.get(ev.name, (0.0, 0))
                seen[ev.name] = (t + ev.time_range.elapsed_us() / 1e3, c + 1)
        # the profiler can miss a few device events of a window, so each
        # operation's time a call is its mean over the launches it
        # recorded times its launches a call (rounded from the count)
        by = {name: t / c * max(1, round(c / calls))
              for name, (t, c) in seen.items() if FLUSH_OP not in name}
        flushes = sum(c for name, (_, c) in seen.items() if FLUSH_OP in name)
        if by and (match is not None or round(flushes / calls) == 1):
            return sum(by.values()), by
    ms = cuda_ms(fn, flush=flush)
    log("info: the profiler recorded no device time%s in 3 windows (%d "
        "flushes in the last); CUDA-event time %.5f ms stands in"
        % ("" if match is None else " for " + match, flushes, ms))
    return ms, {"CUDA events (the profiler recorded nothing)": ms}


def short_names(by):
    return {name[:100]: round(ms, 5) for name, ms in
            sorted(by.items(), key=lambda kv: -kv[1])}


def sdpa_times(q, k, v, do, mask, causal, dropout, flush, tag):
    """Yardstick only (never called by the port): torch SDPA's forward
    and its backward through autograd (fwd+bwd minus fwd), each as
    device time (profiler, every operation of the call) and CUDA-event
    time; logs the operations SDPA ran, which name the backend it
    chose."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = do.transpose(1, 2)
    am = None if mask is None else mask[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                              dropout_p=dropout,
                                              is_causal=causal)

    def fwd_bwd():
        qt.grad = kt.grad = vt.grad = None
        fwd().backward(gt)

    f, f_ops = device_time(fwd, flush)
    fb, fb_ops = device_time(fwd_bwd, flush)
    f_ev, fb_ev = cuda_ms(fwd, flush=flush), cuda_ms(fwd_bwd, flush=flush)
    log("info: SDPA %s forward operations (device ms/call): %s"
        % (tag, json.dumps(short_names(f_ops))))
    log("info: SDPA %s fwd+bwd operations (device ms/call): %s"
        % (tag, json.dumps(short_names(fb_ops))))
    return {"fwd": f, "bwd": fb - f, "fwd_event": f_ev,
            "bwd_event": fb_ev - f_ev}


FLASH_MS_FROM = ("profiler: the kernel's own device time, mean of 20 "
                 "calls, L2 flushed before each (CUDA events where the "
                 "profiler recorded nothing, as the log says); event_ms: "
                 "CUDA events around the wrapper, mean of 30")


def flash_calls(FA, q, k, v, do, kw):
    """{kernel name: (kernel call, plain call, work kind)} at these
    inputs, lse and delta from one forward launch."""
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return {
        "flash_fwd": (lambda: FA.flash_fwd(q, k, v, **kw),
                      lambda: FA.flash_fwd_reference(q, k, v, **kw), "fwd"),
        "flash_bwd_dq": (
            lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
            lambda: FA.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
            "dq"),
        "flash_bwd_dkv": (
            lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
            lambda: FA.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               **kw), "dkv")}


def time_flash_case(FA, q, k, v, do, mask, causal, seed, flush, shape):
    """Rows of the three flash kernels on one input set (bf16, dropout
    0.1): device and event time, the plain version, the bound and torch
    SDPA (for dQ and dK/dV its whole backward)."""
    kw = dict(mask=mask, causal=causal, dropout=0.1, seed=seed)
    lib = sdpa_times(q, k, v, do, mask, causal, 0.1, flush, shape)
    rows = {}
    for name, (kern, plain, kind) in flash_calls(FA, q, k, v, do,
                                                 kw).items():
        b_ms, b_by = bound(*flash_work(q, mask, causal, kind), q.dtype)
        fwd = kind == "fwd"
        rows[name] = {"ms": device_time(kern, flush, name)[0],
                      "ms_from": FLASH_MS_FROM,
                      "event_ms": cuda_ms(kern, flush=flush),
                      "plain_ms": cuda_ms(plain, iters=5, flush=flush),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib["fwd" if fwd else "bwd"],
                      "library_event_ms": lib["fwd_event" if fwd
                                              else "bwd_event"],
                      "shape": shape}
    return rows


def time_training_kernels(FA, dev, flush):
    """Times of the three flash kernels at BERT-base's shapes (bf16,
    dropout 0.1): the path's own case (padding mask, not causal) as
    rows, the causal case as information.  Returns {name: row}."""
    rows = {}
    for causal, use_mask in ((False, True), (True, False)):
        q, k, v, do, mask = train_inputs(dev, torch.bfloat16, use_mask, 60)
        seed = torch.tensor([77], dtype=torch.int32, device=dev)
        shape = "bf16 B=16 T=512 H=12 dh=64 dropout 0.1 %s" % (
            "causal" if causal else "padding mask")
        case = time_flash_case(FA, q, k, v, do, mask, causal, seed, flush,
                               shape)
        for name, row in case.items():
            if causal:
                log("info: %s causal: %s" % (name, json.dumps(row)))
            else:
                rows[name] = row
    q, k, v, do, mask = train_inputs(dev, torch.bfloat16, True, 60)
    calls = flash_calls(FA, q, k, v, do, dict(mask=mask, causal=False,
                                              dropout=0.0, seed=None))
    log("info: without dropout (padding mask, device ms, the hash's "
        "share of the dropout case): %s" % json.dumps({
            name: device_time(calls[name][0], flush, name)[0]
            for name in ("flash_fwd", "flash_bwd_dkv")}))
    log("info: library_ms of the backward kernels is torch SDPA's "
        "backward (fwd+bwd minus fwd), which computes dQ, dK and dV "
        "together")
    return rows


def time_dh256(FA, dev, flush):
    """Times of the three flash kernels at head dim 256 (bf16, B=16,
    T=512, H=3: BERT-base's token count and width; padding mask,
    dropout 0.1, not causal), their plain versions, bounds and torch
    SDPA.  Returns {kernel name: row}."""
    q, k, v, do, mask = train_inputs(dev, torch.bfloat16, True, 62,
                                     dh=256, **DH256_TIME)
    seed = torch.tensor([78], dtype=torch.int32, device=dev)
    rows = time_flash_case(FA, q, k, v, do, mask, False, seed, flush,
                           "bf16 B=16 T=512 H=3 dh=256 dropout 0.1 "
                           "padding mask")
    for name, row in rows.items():
        log("info: %s dh256: %s" % (name, json.dumps(row)))
    return rows


def time_prefill(FA, dev, flush, err):
    """The flash forward at the ``generate`` prefill's shapes (bf16,
    causal, B=4, H=12, dh=64, T=192 and 512), beside its plain version,
    bound and SDPA, as information."""
    for T in (192, 512):
        q, k, v, _ = flash_inputs(dev, T, torch.bfloat16, False, seed=30)

        def kern():
            return FA.flash_fwd(q, k, v, causal=True)

        def lib():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True)

        b_ms, b_by = bound(*flash_work(q, None, True), q.dtype)
        log("info: flash_fwd serving prefill:", json.dumps({
            "ms": device_time(kern, flush, "flash_fwd")[0],
            "event_ms": cuda_ms(kern, flush=flush),
            "plain_ms": cuda_ms(lambda: FA.flash_fwd_reference(
                q, k, v, causal=True), flush=flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_time(lib, flush)[0],
            "library_event_ms": cuda_ms(lib, flush=flush),
            "max_abs_err": err if T == 192 else None,
            "shape": "bf16 causal B=4 T=%d H=12 dh=64" % T}))


# ---------------------------------------------------- builds and the parent --
def build_report(_build):
    """Per kernel of the flash, paged and conv libraries: ptxas's registers,
    spills and static shared memory (the report kept beside each
    library) and, where the toolkit has ``cuobjdump``, the count of
    tensor-core (HMMA or HGMMA) instructions in its SASS.  Logged;
    returns {short name: figures}."""
    import shutil
    tool = shutil.which("cuobjdump") or next(
        (p for p in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                                  "cuobjdump"),
                     "/usr/local/cuda/bin/cuobjdump") if os.path.exists(p)),
        None)
    out = {}
    for name in ("flash_fwd", "flash_bwd", "paged_attention", "fused_conv"):
        so = _build.library_path(name)
        with open(so[:-3] + ".ptxas") as f:
            rep = _build.ptxas_report(f.read())
        mma = {}
        if tool is not None:
            sass = subprocess.run([tool, "-sass", so], capture_output=True,
                                  text=True, timeout=300).stdout
            cur = None
            for line in sass.splitlines():
                if "Function :" in line:
                    cur = line.split("Function :", 1)[1].strip()
                    mma[cur] = 0
                elif cur is not None and ("HMMA" in line
                                          or "HGMMA" in line):
                    mma[cur] += 1
        for mangled, fig in rep.items():
            fig = dict(fig, tensor_core_instructions=mma.get(mangled)
                       if tool else "no cuobjdump")
            short = demangle(mangled)
            out[short] = fig
            log("info: build %s %s: %s" % (name, short, json.dumps(fig)))
    return out


def demangle(mangled):
    """A kernel's template name, ``flash_fwd_tc<64, true>``, from its
    mangled name (via c++filt where there is one)."""
    try:
        text = subprocess.run(["c++filt", mangled], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except OSError:
        return mangled
    text = text.replace("(anonymous namespace)::", "")
    if text.startswith("void "):
        text = text[5:]
    return text.split("(", 1)[0]


def load_parent(parent, module):
    """Kernel module ``module`` (``flash_attention``, ``paged_attention``,
    ``fused_conv``) of another checkout of this repository (the parent
    commit, unpacked under ``parent``).  The parent's ``mxnet_tpu_torch``
    is a package of its own here, ``parent_mxnet_tpu_torch``, whose
    modules load from the parent's files as they are imported (its
    ``__init__`` does not run), so a module's relative imports (``from
    ..base import MXNetError``) resolve in the parent; its kernels build
    from its own sources into its own ``_build``."""
    import importlib
    name = "parent_mxnet_tpu_torch"
    if name not in sys.modules:
        pkg = types.ModuleType(name)
        pkg.__path__ = [os.path.join(os.path.abspath(parent),
                                     "mxnet_tpu_torch")]
        pkg.__package__ = name
        sys.modules[name] = pkg
    return importlib.import_module("%s.kernels.%s" % (name, module))


def use_flash(FA, impl):
    """Route the port's attention autograd Function (which calls
    ``FA.flash_fwd``, ``FA.flash_bwd_dq`` and ``FA.flash_bwd_dkv``) to
    the wrappers of module ``impl``."""
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        setattr(FA, name, getattr(impl, name))


def step_ms(init_state, step, batch, dev, n, warm, seed):
    """Mean ms of ``n`` synchronised train steps after ``warm``."""
    state = init_state(seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(warm):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, loss = step(state, batch, gen)
    torch.cuda.synchronize()
    del state
    return (time.perf_counter() - t0) * 1e3 / n


def captured_vs_eager(name, init_state, step, batch, dev, seed, failures,
                      n=3):
    """``n`` train steps op by op and ``n`` replayed from one seed: the
    losses, parameters, AdamW state and the generator's state after
    them bit for bit (so the warm-up before the capture left no trace
    and replay k drew eager step k's dropout)."""
    from mxnet_tpu_torch.convert import tree_leaves
    runs = []
    for eager in (True, False):
        step._eager = eager
        try:
            state = init_state(seed=seed)
            gen = torch.Generator(device=dev).manual_seed(seed)
            losses = torch.stack([step(state, batch, gen)[1]
                                  for _ in range(n)])
            params, opt = state
            leaves = tree_leaves(params)
            runs.append((losses, leaves, [v for p in leaves for v in
                                          opt.state[p].values()],
                         gen.get_state()))
        finally:
            step._eager = False
    (l0, p0, s0, g0), (l1, p1, s1, g1) = runs
    same = (torch.equal(l0, l1) and torch.equal(g0, g1)
            and len(p0) == len(p1) and len(s0) == len(s1)
            and all(torch.equal(a, b) for a, b in zip(p0 + s0, p1 + s1)))
    log("check %s, %d steps captured vs eager: losses %s vs %s, %d "
        "parameters and %d AdamW tensors bit for bit: %s  %s"
        % (name, n, " ".join("%.6f" % x for x in l1.tolist()),
           " ".join("%.6f" % x for x in l0.tolist()), len(p0), len(s0),
           same, "ok" if same else "FAIL"))
    if not same:
        failures.append("%s captured vs eager" % name)


def step_times(init_state, step, batch, dev, n, warm, seed):
    """ms/step of ``n`` synchronised train steps after ``warm``, op by op
    and replayed, in turns (eager, captured, captured, eager).  Each side
    keeps one state and one generator, so the captured side captures
    once, in its first warm-up steps."""
    sides = {side: (init_state(seed=seed),
                    torch.Generator(device=dev).manual_seed(seed))
             for side in ("eager", "captured")}
    got = {"eager": [], "captured": []}
    for side in ("eager", "captured", "captured", "eager"):
        state, gen = sides[side]
        step._eager = side == "eager"
        try:
            for _ in range(warm):
                step(state, batch, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step(state, batch, gen)
            torch.cuda.synchronize()
            got[side].append((time.perf_counter() - t0) * 1e3 / n)
        finally:
            step._eager = False
    del sides
    out = {side: float(np.median(v_)) for side, v_ in got.items()}
    out["runs"] = got
    return out


def own_flash(FA):
    """This tree's three flash wrappers, as a module-like object."""
    return types.SimpleNamespace(**{n: getattr(FA, n) for n in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})


def compare_parent_steps(PFA, FA, dev, steps):
    """The BERT-base and GPT train steps with the parent checkout's
    flash kernels (module ``PFA``) against this tree's, in turns
    (parent, change, change, parent, twice) in this process, by host
    clock; then one profiled window a side for the device's busy time
    a step (a profiler session slows the host-bound steps after it, so
    it comes last).  ``steps``: {name: (init_state, step, batch, n,
    warm, seed)}.  Logs and returns {name: {"parent": median ms/step,
    "change": ..., "runs": ..., "profiled_parent": ...,
    "profiled_change": ...}}."""
    mine = own_flash(FA)
    out = {}
    for name, (init_state, step, batch, n, warm, seed) in steps.items():
        got = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent") * 2:
            use_flash(FA, PFA if side == "parent" else mine)
            try:
                got[side].append(step_ms(init_state, step, batch, dev, n,
                                         warm, seed))
            finally:
                use_flash(FA, mine)
        out[name] = {side: float(np.median(v_)) for side, v_ in got.items()}
        out[name]["runs"] = got
    for name, (init_state, step, batch, n, warm, seed) in steps.items():
        for side in ("parent", "change"):    # profiled last: see above
            use_flash(FA, PFA if side == "parent" else mine)
            try:
                state = init_state(seed=seed)
                gen = torch.Generator(device=dev).manual_seed(seed)
                for _ in range(warm):
                    step(state, batch, gen)
                out[name]["profiled_" + side] = profile_window(
                    lambda: step(state, batch, gen), n,
                    "%s, %s flash kernels" % (name, side), top=0)
                del state
            finally:
                use_flash(FA, mine)
        log("info: parent vs change %s ms/step (median of 4 runs a "
            "side): %s" % (name, json.dumps(out[name])))
    return out


def compare_parent_kernels(PFA, FA, dev, flush):
    """The flash forward, dQ and dK/dV of the parent checkout (module
    ``PFA``) against this tree's at BERT-base's case, causal and dh 256,
    and the forward at the serving prefill, in turns (parent, change,
    change, parent): device and event ms of each.  Logs and returns
    {case: row}."""
    mine = own_flash(FA)
    cases = []
    for tag, (causal, use_mask, extra) in (
            ("BERT padding mask", (False, True, {})),
            ("BERT causal", (True, False, {})),
            ("dh 256", (False, True, dict(dh=256, **DH256_TIME)))):
        q, k, v, do, mask = train_inputs(dev, torch.bfloat16, use_mask, 60,
                                         **extra)
        seed = torch.tensor([77], dtype=torch.int32, device=dev)
        cases.append((tag, q, k, v, do, dict(mask=mask, causal=causal,
                                              dropout=0.1, seed=seed),
                      ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")))
    q, k, v, _ = flash_inputs(dev, 192, torch.bfloat16, False, seed=30)
    cases.append(("serving prefill B=4 T=192 causal", q, k, v, q,
                  dict(causal=True), ("flash_fwd",)))
    out = {}
    for tag, q, k, v, do, kw, names in cases:
        calls = {side: flash_calls(impl, q, k, v, do, kw)
                 for side, impl in (("parent", PFA), ("change", mine))}
        for name in names:
            got = {"parent": [], "change": []}
            for side in ("parent", "change", "change", "parent"):
                kern = calls[side][name][0]
                got[side].append((device_time(kern, flush, name)[0],
                                  cuda_ms(kern, flush=flush)))
            row = {side: {"ms": float(np.mean([d for d, _ in v_])),
                          "event_ms": float(np.mean([e for _, e in v_]))}
                   for side, v_ in got.items()}
            row["speedup_device"] = row["parent"]["ms"] / row["change"]["ms"]
            row["speedup_event"] = (row["parent"]["event_ms"]
                                    / row["change"]["event_ms"])
            out["%s %s" % (name, tag)] = row
            log("info: parent vs change %s %s: %s" % (name, tag,
                                                      json.dumps(row)))
    return out


def compare_parent_paged(PPA, PA, dev, flush):
    """The paged kernels of the parent checkout (module ``PPA``) against
    this tree's at the engine step's shapes (``paged_inputs``), f32,
    bf16 and int8 pools, in turns (parent, change, change, parent):
    device ms (every paged kernel of a call) and event ms.  Logs and
    returns {kind: row}."""
    out = {}
    for i, kind in enumerate(("float32", "bfloat16", "int8")):
        q, pool, s, bt, pos = paged_inputs(dev, kind, seed=70 + i)
        got = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent"):
            impl = PPA if side == "parent" else PA

            def kern():
                return impl.paged_attention(q, pool, s, bt, pos,
                                            page_size=PAGE)

            got[side].append((device_time(kern, flush, "paged_")[0],
                              cuda_ms(kern, flush=flush)))
        row = {side: {"ms": float(np.mean([d for d, _ in v_])),
                      "event_ms": float(np.mean([e for _, e in v_]))}
               for side, v_ in got.items()}
        row["speedup_device"] = row["parent"]["ms"] / row["change"]["ms"]
        row["speedup_event"] = (row["parent"]["event_ms"]
                                / row["change"]["event_ms"])
        out[kind] = row
        log("info: parent vs change paged_attention %s pool T=32 H=12 "
            "dh=64 ps=16 PP=32: %s" % (kind, json.dumps(row)))
    return out


def compare_parent_serving(PPA, E, G, ServingEngine, params, cfg, reqs, dev):
    """Serving throughput of the ``full`` preset (bf16/w8, float KV)
    with the parent checkout's paged kernel (module ``PPA``) bound into
    the engine against this tree's, in turns (parent, change, change,
    parent), by host clock over the whole mix.  Logs and returns
    {"parent": median tokens/s, "change": ..., "runs": ...}."""
    mine = E.paged_attention
    got = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        E.paged_attention = (PPA.paged_attention if side == "parent"
                             else mine)
        try:
            _, run = serve(G, ServingEngine, params, cfg, reqs, False, dev)
        finally:
            E.paged_attention = mine
        got[side].append(run["tokens"] / run["seconds"])
    out = {side: float(np.median(v_)) for side, v_ in got.items()}
    out["runs"] = got
    log("info: parent vs change serving tokens/s (full preset, float KV, "
        "median of 2 runs a side): %s" % json.dumps(out))
    return out


# ------------------------------------------------------------ grouped SGD --
def resnet50_shapes(mx):
    """The shapes of resnet50_v1's trainable parameters, in the
    Trainer's order (a CPU net, deferred shapes resolved by one 32 x 32
    forward)."""
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES)
    net.initialize(mx.init.Zero(), ctx=mx.cpu())
    net(mx.nd.zeros((1, 3, 32, 32), ctx=mx.cpu()))
    return [p.shape for p in net.collect_params().values()
            if p.grad_req != "null"]


def check_sgd_kernels(FO, dev, resnet_shapes, failures):
    """Both grouped SGD kernels (with and without momentum) against their
    plain version on the card, bit for bit (after adding +0.0, which
    maps -0 to +0): on ResNet-50's parameter group and on a group of odd
    sizes (float4 bodies, scalar tails, chunk edges), clip off and on,
    wd 0 and 1e-4, rescale_grad 1/64, per-tensor lrs.  Returns each
    kernel's largest |kernel - plain| over the ResNet-50 group's cases
    (weights and momenta, after +0.0)."""
    worst = {"fused_sgd_mom": 0.0, "fused_sgd": 0.0}
    odd = [(1,), (3,), (1023,), (4097,), (5,), (64,), (3 * 4096 + 1,),
           (7, 3, 3)]
    for i, (group, shapes) in enumerate((("ResNet-50 group", resnet_shapes),
                                         ("odd sizes", odd))):
        for j, (mom, clip, wd) in enumerate(itertools.product(
                (True, False), (-1.0, 1.0), (0.0, 1e-4))):
            g = torch.Generator().manual_seed(100 * i + j)
            ws = [torch.randn(s, generator=g).to(dev) for s in shapes]
            gs = [10 * torch.randn(s, generator=g).to(dev) for s in shapes]
            ms = [torch.randn(s, generator=g).to(dev) for s in shapes] \
                if mom else None
            ms2 = [m.clone() for m in ms] if mom else None
            kw = dict(lrs=[RESNET_LR * (1 + k % 3) for k in range(len(ws))],
                      wds=[wd] * len(ws), momentum=RESNET_MOM,
                      rescale_grad=1.0 / RESNET_B, clip_gradient=clip)
            o1, m1 = FO.fused_multi_sgd(ws, gs, ms, **kw)
            o2, m2 = FO.fused_multi_sgd_reference(ws, gs, ms2, **kw)
            torch.cuda.synchronize()
            pairs = list(zip(o1, o2)) + (list(zip(m1, m2)) if mom else [])
            bad = sum(int((a + 0.0).ne(b + 0.0).sum()) for a, b in pairs)
            err = max(float(((a + 0.0) - (b + 0.0)).abs().max())
                      for a, b in pairs if a.numel())
            if i == 0:
                key = "fused_sgd_mom" if mom else "fused_sgd"
                worst[key] = max(worst[key], err)
            name = ("sgd%s %s (%d tensors) clip=%g wd=%g" % (
                "_mom" if mom else "", group, len(ws), clip, wd))
            log("check %-52s elements differing %d, max_abs_err %.3e "
                "(bit for bit)  %s" % (name, bad, err,
                                       "ok" if bad == 0 else "FAIL"))
            if bad:
                failures.append(name)
            del ws, gs, ms, ms2, o1, o2, m1, m2, pairs
    return worst


def device_kernels(fn, name="", calls=1):
    """(device operations, device ms) per call of ``fn``, counting the
    operations whose name contains ``name``, over ``calls`` calls under
    torch.profiler (no L2 flush); (None, None) when it records no device
    time.  Only device work counts (``device_work``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in device_work(prof)[0] if name in ev.name]
    if not evs:
        return None, None
    # the profiler can miss a few events of a window: the mean of those
    # it recorded, times the launches a call
    per_call = max(1, round(len(evs) / calls))
    return (len(evs) // calls, sum(ev.time_range.elapsed_us() for ev in evs)
            / 1e3 / len(evs) * per_call)


def compare_update_routes(mx, FO, trainer, params, failures):
    """On the current gradients and from one state (the weights and the
    Trainer's momenta now): the Trainer's per-tensor update against
    ``nd.multi_sgd_mom_update`` over the whole group with the Trainer's
    own lrs, wds and rescale_grad, and ``nd.sgd_update`` (a momentum-0
    Trainer) against ``nd.multi_sgd_update``; wd 0 and 1e-4, clip off
    and on.  Weights and momenta must be bit-identical, and each grouped
    call must launch its kernel once.  Returns the routes' host times
    and device kernel counts."""
    idx = {id(p): i for i, p in enumerate(trainer._params)}
    w0 = [p.data()._data.detach().clone() for p in params]
    m0 = [trainer._updater.states[idx[id(p)]]._data.clone() for p in params]
    NDArray = mx.nd.NDArray

    def restore():
        for p, w in zip(params, w0):
            p.set_data(NDArray(w))

    def trainer_route(momentum, wd, clip):
        opt = {"learning_rate": RESNET_LR, "momentum": momentum, "wd": wd}
        if clip is not None:
            opt["clip_gradient"] = clip
        tr = mx.gluon.Trainer(params, "sgd", opt)
        tr._updater = mx.optimizer.get_updater(tr.optimizer)
        if momentum:
            tr._updater.states = {i: NDArray(m.clone())
                                  for i, m in enumerate(m0)}
        return tr

    def grouped_call(tr, momentum, clip):
        o = tr.optimizer
        kw = dict(lrs=[o._get_lr(i) for i in range(len(params))],
                  wds=[o._get_wd(i) for i in range(len(params))],
                  rescale_grad=1.0 / RESNET_B, num_weights=len(params))
        if clip is not None:
            kw["clip_gradient"] = clip
        ws = [NDArray(w.clone()) for w in w0]
        moms = [NDArray(m.clone()) for m in m0] if momentum else []
        data = []
        for i, p in enumerate(params):
            data += [ws[i], p.grad()] + ([moms[i]] if momentum else [])
        if momentum:
            return (lambda: mx.nd.multi_sgd_mom_update(
                *data, out=ws, momentum=momentum, **kw)), ws, moms
        return (lambda: mx.nd.multi_sgd_update(*data, out=ws, **kw)), ws, moms

    out = {}
    for momentum in (RESNET_MOM, 0.0):
        for wd, clip in ((0.0, None), (1e-4, 1.0)):
            restore()
            tr = trainer_route(momentum, wd, clip)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step(RESNET_B)
            torch.cuda.synchronize()
            t_loop = time.perf_counter() - t0
            want = [p.data()._data.clone() for p in params]
            if momentum:
                want += [tr._updater.states[i]._data.clone()
                         for i in range(len(params))]
            restore()
            call, ws, moms = grouped_call(tr, momentum, clip)
            counter = "sgd_mom_launches" if momentum else "sgd_launches"
            n0 = getattr(FO.fused_multi_sgd, counter)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            t_group = time.perf_counter() - t0
            launched = getattr(FO.fused_multi_sgd, counter) - n0
            got = [w._data for w in ws] + [m._data for m in moms]
            bad = sum(int((a + 0.0).ne(b + 0.0).sum())
                      for a, b in zip(want, got))
            name = ("ResNet-50 update routes momentum=%g wd=%g clip=%s"
                    % (momentum, wd, clip))
            ok = bad == 0 and launched == 1
            log("check %s: Trainer per-tensor vs nd.multi_sgd%s_update, "
                "elements differing %d (bit for bit), grouped kernel "
                "launches %d (1 expected); host ms %.3f vs %.3f  %s"
                % (name, "_mom" if momentum else "", bad, launched,
                   t_loop * 1e3, t_group * 1e3, "ok" if ok else "FAIL"))
            if not ok:
                failures.append(name)
            if wd == 0.0:
                restore()
                n_loop, dev_loop = device_kernels(
                    lambda: trainer_route(momentum, wd, clip).step(RESNET_B))
                restore()
                n_grp, dev_grp = device_kernels(
                    grouped_call(tr, momentum, clip)[0])
                out["momentum" if momentum else "plain"] = {
                    "trainer_host_ms": t_loop * 1e3,
                    "grouped_host_ms": t_group * 1e3,
                    "trainer_device_kernels": n_loop,
                    "trainer_device_ms": dev_loop,
                    "grouped_device_kernels": n_grp,
                    "grouped_device_ms": dev_grp}
                log("info: update routes (momentum %g): %s"
                    % (momentum, json.dumps(out["momentum" if momentum
                                                else "plain"])))
    restore()
    return out


def time_sgd_kernels(FO, params, flush):
    """Times of both grouped SGD kernels on ResNet-50's group (copies of
    its real weights, its gradients), updating in place as
    ``nd.multi_sgd(_mom)_update(..., out=weights)`` does: ``ms`` is the
    kernel's own device time (the profiler's mean over 20 calls; the run
    fails if the profiler records none), ``wrapper_ms`` CUDA events
    around the wrapper, whose host work the device waits for; the plain
    version and, as a
    yardstick of equal bytes, ``torch.optim.SGD(fused=True).step``
    (PyTorch's convention, ``b = mu*b + g; w -= lr*b``, not MXNet's;
    never called by the port).  Returns {kernel name: row}."""
    ws = [p.data()._data.detach().clone() for p in params]
    gs = [p.grad()._data for p in params]
    n = sum(w.numel() for w in ws)
    rows = {}
    for name, mom in (("fused_sgd_mom", True), ("fused_sgd", False)):
        ms = [torch.zeros_like(w) for w in ws] if mom else None
        kw = dict(lrs=[RESNET_LR] * len(ws), wds=[0.0] * len(ws),
                  momentum=RESNET_MOM if mom else 0.0,
                  rescale_grad=1.0 / RESNET_B, out=ws)

        def kern():
            return FO.fused_multi_sgd(ws, gs, ms, **kw)

        wrapper_ms = cuda_ms(kern, flush=flush)
        ms_ = device_kernels(kern, "fused_sgd_kernel", calls=20)[1]
        if ms_ is None:
            raise Failed("%s: the profiler recorded no fused_sgd_kernel "
                         "time" % name)
        plain = cuda_ms(lambda: FO.fused_multi_sgd_reference(ws, gs, ms,
                                                             **kw),
                        iters=5, flush=flush)
        lib_p = [w.clone().requires_grad_() for w in ws]
        for p, g in zip(lib_p, gs):
            p.grad = g.clone()
        opt = torch.optim.SGD(lib_p, lr=RESNET_LR,
                              momentum=RESNET_MOM if mom else 0.0,
                              fused=True)
        lib = cuda_ms(opt.step, flush=flush)
        del opt, lib_p
        nbytes = n * (20 if mom else 12)
        b_ms, b_by = bound(nbytes, 0, torch.float32)
        rows[name] = {"ms": ms_, "ms_from": "profiler, kernel only",
                      "wrapper_ms": wrapper_ms, "plain_ms": plain,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                      "library": "torch.optim.SGD(fused=True).step "
                                 "(PyTorch's momentum convention; equal "
                                 "bytes)",
                      "shape": "ResNet-50 v1 group, in place: %d f32 "
                               "tensors, %d values, %d bytes moved"
                               % (len(ws), n, nbytes)}
        log("info: %s: %s" % (name, json.dumps(rows[name])))
    return rows


# ----------------------------------------------------------------- gluon --
def resnet_path(mx, FA, PA, FO, dev, failures, flush):
    """The Gluon path: ResNet-50 v1 trained by ``gluon.Trainer`` on the
    card as a reference-era user writes it, counters from 0 just before
    and read just after (the 20 steps and the update-route comparison,
    whose grouped ops launch the SGD kernels).  Then the SGD kernels'
    times on the group and a 20-step profile.  Returns (launches,
    numbers, SGD kernel rows)."""
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    tf32 = ("cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s"
            % (torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32))
    ctx = mx.gpu(0)
    np.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW)
                    .astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, RESNET_CLASSES, RESNET_B)
                    .astype(np.float32), ctx=ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": RESNET_LR,
                                "momentum": RESNET_MOM})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with mx.autograd.record():
            L = loss_fn(net(x), y)
        L.backward()
        trainer.step(RESNET_B)
        return L

    def run():
        """RESNET_STEPS steps: mean losses, s/step after RESNET_WARM and
        ms/step by window."""
        losses, marks = [], []
        for i in range(RESNET_STEPS + 1):
            if i >= RESNET_WARM and (i - RESNET_WARM) % RESNET_WINDOW == 0:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            if i < RESNET_STEPS:
                losses.append(step())
        per = (marks[-1] - marks[0]) / (RESNET_STEPS - RESNET_WARM)
        return ([float(L.asnumpy().mean()) for L in losses], per,
                [(b - a) / RESNET_WINDOW * 1e3
                 for a, b in zip(marks, marks[1:])])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(FA, PA, FO)
    losses, per, windows = run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    net.hybridize()             # the forward and backward as CUDA graphs
    h_losses, h_per, h_windows = run()
    net.hybridize(False)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    n_vals = sum(int(np.prod(p.shape)) for p in params)
    log("ResNet-50 v1 train (bs %d x 3 x %d x %d, f32, %s): %d trainable "
        "tensors, %d values" % (RESNET_B, RESNET_HW, RESNET_HW, tf32,
                                 len(params), n_vals))
    log("ResNet-50 train: %d steps, losses %s" % (RESNET_STEPS, " ".join(
        "%.4f" % v for v in losses)))
    log("ResNet-50 train step: %.3f ms, %.1f images/s (host clock over "
        "steps %d-%d, synchronised), peak memory %.2f GiB, %s"
        % (per * 1e3, RESNET_B / per, RESNET_WARM + 1, RESNET_STEPS, peak,
           tf32))
    log("ResNet-50 train step by %d-step window: %s ms" % (
        RESNET_WINDOW, " ".join("%.3f" % w for w in windows)))
    log("ResNet-50 hybridized train: %d steps, losses %s" % (
        RESNET_STEPS, " ".join("%.4f" % v for v in h_losses)))
    log("ResNet-50 hybridized train step: %.3f ms, %.1f images/s (host "
        "clock over steps %d-%d, synchronised; the first step captures), "
        "by %d-step window %s ms" % (
            h_per * 1e3, RESNET_B / h_per, RESNET_WARM + 1, RESNET_STEPS,
            RESNET_WINDOW, " ".join("%.3f" % w for w in h_windows)))
    for tag, ls in (("", losses), (" hybridized", h_losses)):
        if not all(np.isfinite(ls)):
            raise Failed("ResNet-50%s: loss not finite" % tag)
        if not ls[-1] < ls[0]:
            raise Failed("ResNet-50%s: loss did not fall (%.4f -> %.4f)"
                         % (tag, ls[0], ls[-1]))
    with mx.autograd.record():                   # one step's gradients
        L = loss_fn(net(x), y)
    L.backward()
    routes = compare_update_routes(mx, FO, trainer, params, failures)
    launches = {"fused_sgd": FO.fused_multi_sgd.sgd_launches,
                "fused_sgd_mom": FO.fused_multi_sgd.sgd_mom_launches}
    log("ResNet-50 path launches: %s (the Trainer updates per tensor; the "
        "grouped ops launch the kernels)" % json.dumps(launches))
    for name, n in launches.items():
        if n <= 0:
            raise Failed("%s was never launched on the ResNet-50 path"
                         % name)
    rows = time_sgd_kernels(FO, params, flush)
    prof = {"eager": profile_window(step, RESNET_PROFILE,
                                    "ResNet-50 train steps, eager")}
    net.hybridize()
    step()                          # captures, outside the window
    prof["captured"] = profile_window(step, RESNET_PROFILE,
                                      "ResNet-50 train steps, hybridized")
    net.hybridize(False)
    torch.backends.cudnn.allow_tf32 = False
    nums = {"ms_per_step": per * 1e3, "images_per_s": RESNET_B / per,
            "window_ms_per_step": windows,
            "hybridized_ms_per_step": h_per * 1e3,
            "hybridized_images_per_s": RESNET_B / h_per,
            "hybridized_window_ms_per_step": h_windows, "profile": prof,
            "peak_gib": peak, "losses": losses, "tensors": len(params),
            "values": n_vals, "tf32": tf32, "routes": routes}
    return launches, nums, rows


def check_small_resnet(mx, dev, failures):
    """A thumbnail ResNet-18 (10 classes) trains 3 Trainer steps at
    32 x 32, batch 4, f32 with TF32 off, on the card and on the CPU from
    the same weights; the mean losses must agree within
    SMALL_RESNET_LOSS_TOL."""
    from mxnet_tpu_torch.convert import set_block_params
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)
    np.random.seed(5)
    cpu_net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                    thumbnail=True)
    cpu_net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    cpu_net(mx.nd.array(x, ctx=mx.cpu()))
    arrays = {k: v.data().asnumpy()
              for k, v in cpu_net._collect_params_with_prefix().items()}
    card_net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                     thumbnail=True)
    set_block_params(card_net, arrays, ctx=mx.gpu(0))
    runs = []
    for net, ctx in ((card_net, mx.gpu(0)), (cpu_net, mx.cpu())):
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.01, "momentum": 0.9})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        X, Y = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
        out = []
        for _ in range(3):
            with mx.autograd.record():
                L = loss_fn(net(X), Y)
            L.backward()
            tr.step(4)
            out.append(float(L.asnumpy().mean()))
        runs.append(out)
    first, later = SMALL_RESNET_LOSS_TOL
    gaps = [abs(a - b) for a, b in zip(*runs)]
    ok = all(gap <= (first if i == 0 else later) * (1 + abs(b))
             for i, (gap, b) in enumerate(zip(gaps, runs[1])))
    log("check small ResNet-18 3 steps, card vs CPU (f32, TF32 off): %s vs "
        "%s, gaps %s (tol %.0e then %.0e, times 1+|loss|)  %s"
        % (" ".join("%.6f" % v for v in runs[0]),
           " ".join("%.6f" % v for v in runs[1]),
           " ".join("%.2e" % g for g in gaps), first, later,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("small ResNet-18 card vs CPU")


# ----------------------------------------------------------------- bench --
def bench_trainer(mx, s2d, amp):
    """bench.py's trainer on the card: ResNet-50 v1 (``stem_s2d``),
    Xavier from np.random.seed(0), SGD lr 0.1 momentum 0.9 over
    make_mesh({"dp": -1})."""
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    np.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet50_v1(stem_s2d=s2d)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    return DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": RESNET_LR, "momentum": RESNET_MOM},
        mesh=make_mesh({"dp": -1}), amp=amp)


def bench_batch(mx, B):
    """bench.py's batch: randn images and randint labels after
    np.random.seed(0), on the card."""
    np.random.seed(0)
    x = np.random.randn(B, 3, RESNET_HW, RESNET_HW).astype("float32")
    y = np.random.randint(0, RESNET_CLASSES, (B,))
    return mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(y, ctx=mx.gpu(0))


def bench_check(mx, x, y, failures):
    """``run_steps`` of BENCH_CHECK steps replayed as a CUDA graph
    against the same steps with ``_eager = True``, each trainer from the
    same weights, cuDNN in deterministic mode: the losses, every
    parameter, the momentum traces and the running statistics bit for
    bit."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for eager in (True, False):
            tr = bench_trainer(mx, True, True)
            tr._eager = eager
            losses = tr.run_steps(x, y, steps=BENCH_CHECK)._data
            runs.append((losses, [t.clone() for t in tr._state_tensors()]))
            del tr
            gc.collect()
    finally:
        torch.backends.cudnn.deterministic = flag
    (l0, s0), (l1, s1) = runs
    same = torch.equal(l0, l1) and len(s0) == len(s1) and all(
        torch.equal(a, b) for a, b in zip(s0, s1))
    log("check bench.py ResNet-50 (stem_s2d, amp), %d run_steps steps "
        "captured vs eager (deterministic cuDNN): losses %s vs %s, %d "
        "state tensors (parameters, running statistics, momentum traces) "
        "bit for bit: %s  %s"
        % (BENCH_CHECK, " ".join("%.6f" % v for v in l1.tolist()),
           " ".join("%.6f" % v for v in l0.tolist()), len(s0), same,
           "ok" if same else "FAIL"))
    if not same:
        failures.append("bench.py ResNet-50 captured vs eager")


def bench_dispatch(tr, x, y):
    """One run_steps dispatch of BENCH_STEPS steps, synchronised:
    (losses, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = tr.run_steps(x, y, steps=BENCH_STEPS)
    tr.sync()
    return losses.asnumpy().tolist(), time.perf_counter() - t0


def bench_path(mx, failures, gluon):
    """bench.py's workload through ``DataParallelTrainer.run_steps`` on
    the card (a CUDA graph of whole steps replayed BENCH_STEPS times a
    dispatch): the captured-vs-eager check, then the main path with
    every launch counter from 0 (one warm dispatch and two timed ones,
    in turns with the 7x7 stem: 7x7, s2d, s2d, 7x7), a profiled window,
    and BENCH_AMP=0 (f32, bs 64) beside the Gluon Trainer's hybridized
    figure ``gluon``.  Returns the numbers."""
    from mxnet_tpu_torch._graphs import kept_launches
    card = card_line()
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    x, y = bench_batch(mx, BENCH_B)
    bench_check(mx, x, y, failures)
    torch.cuda.reset_peak_memory_stats()
    trainers = {"s2d": bench_trainer(mx, True, True),
                "7x7": bench_trainer(mx, False, True)}
    losses = {k: [] for k in trainers}
    times = {k: [] for k in trainers}
    with kept_launches() as (counters, _):
        for h, a in counters:
            setattr(h, a, 0)
        for name in ("s2d", "7x7", "7x7", "s2d", "s2d", "7x7"):
            got, sec = bench_dispatch(trainers[name], x, y)
            losses[name] += got
            times[name].append(sec)
        launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__),
                               a): getattr(h, a) for h, a in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("bench.py path launches of the port's kernels over %d steps: %s "
        "(no hand-written kernel is on this path)"
        % (sum(len(v) for v in losses.values()), json.dumps(launches)))
    nums = {"card": card, "batch": BENCH_B, "steps_per_dispatch":
            BENCH_STEPS, "peak_gib": peak, "launches": launches}
    for name, tag in (("s2d", "stem_s2d=True"), ("7x7", "stem_s2d=False")):
        ls = losses[name]
        if not all(np.isfinite(ls)):
            raise Failed("bench.py %s: loss not finite" % tag)
        if not ls[-1] < ls[0]:
            raise Failed("bench.py %s: loss did not fall (%.4f -> %.4f)"
                         % (tag, ls[0], ls[-1]))
        timed = times[name][1:]     # the first dispatch warms and captures
        per = [t / BENCH_STEPS for t in timed]
        nums[name] = {"ms_per_step": [p * 1e3 for p in per],
                      "images_per_s": [BENCH_B / p for p in per],
                      "warm_dispatch_s": times[name][0],
                      "losses": ls[::BENCH_STEPS] + ls[-1:]}
        log("bench.py ResNet-50 v1 %s amp bs %d: run_steps(%d) %s ms/step, "
            "%s images/s (host clock over a synchronised dispatch; after "
            "one warm dispatch each, which captures, two each in turns "
            "7x7, s2d, s2d, 7x7), losses %s; %s"
            % (tag, BENCH_B, BENCH_STEPS,
               " ".join("%.3f" % v for v in nums[name]["ms_per_step"]),
               " ".join("%.1f" % v for v in nums[name]["images_per_s"]),
               " ".join("%.4f" % v for v in nums[name]["losses"]), card))
    log("bench.py ResNet-50 peak memory %.2f GiB (both trainers and their "
        "graphs)" % peak)
    tr = trainers["s2d"]
    nums["profile"] = profile_window(
        lambda: tr.run_steps(x, y, steps=1), BENCH_PROFILE,
        "bench.py ResNet-50 (stem_s2d, amp) run_steps steps, captured")
    tr._eager = True                # the same steps op by op, for the gap
    tr.run_steps(x, y, steps=2)
    sec = bench_dispatch(tr, x, y)[1]
    nums["eager_ms_per_step"] = sec * 1e3 / BENCH_STEPS
    log("bench.py ResNet-50 v1 stem_s2d=True amp bs %d, op by op "
        "(_eager): run_steps(%d) %.3f ms/step, %.1f images/s; %s"
        % (BENCH_B, BENCH_STEPS, nums["eager_ms_per_step"],
           BENCH_B * BENCH_STEPS / sec, card))
    nums["profile_eager"] = profile_window(
        lambda: tr.run_steps(x, y, steps=1), BENCH_PROFILE,
        "bench.py ResNet-50 (stem_s2d, amp) run_steps steps, eager")
    del trainers, tr
    gc.collect()
    torch.cuda.empty_cache()
    x, y = bench_batch(mx, BENCH_F32_B)
    tr = bench_trainer(mx, True, False)
    got, _ = bench_dispatch(tr, x, y)
    per = [bench_dispatch(tr, x, y)[1] / BENCH_STEPS for _ in range(2)]
    nums["f32"] = {"batch": BENCH_F32_B,
                   "ms_per_step": [p * 1e3 for p in per],
                   "images_per_s": [BENCH_F32_B / p for p in per],
                   "gluon_hybridized_images_per_s":
                       gluon["hybridized_images_per_s"]}
    log("bench.py BENCH_AMP=0 ResNet-50 v1 stem_s2d f32 bs %d "
        "(cudnn.allow_tf32=%s): run_steps(%d) %s ms/step, %s images/s; the "
        "Gluon Trainer hybridized (7x7 stem, bs %d, f32) %.1f images/s "
        "in this call; %s"
        % (BENCH_F32_B, torch.backends.cudnn.allow_tf32, BENCH_STEPS,
           " ".join("%.3f" % v for v in nums["f32"]["ms_per_step"]),
           " ".join("%.1f" % v for v in nums["f32"]["images_per_s"]),
           RESNET_B, gluon["hybridized_images_per_s"], card))
    if not (np.isfinite(got).all() and got[-1] < got[0]):
        raise Failed("bench.py BENCH_AMP=0: losses %s" % got)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    return nums


def check_small_bench(mx, failures):
    """ResNet-18 v1 with the space-to-depth stem trains 3
    DataParallelTrainer steps on the card (a captured run_steps, TF32
    off) and on the CPU from the same weights: f32 losses within
    SMALL_RESNET_LOSS_TOL, ``amp=True`` losses within AMP_LOSS_TOL."""
    from mxnet_tpu_torch.convert import set_block_params
    from mxnet_tpu_torch.parallel import DataParallelTrainer, make_mesh
    for kind, (B, lr) in BENCH_SMALL.items():
        rng = np.random.RandomState(5)
        x = rng.randn(B, 3, 64, 64).astype(np.float32)
        y = rng.randint(0, 10, B).astype(np.float32)
        np.random.seed(5)
        src = mx.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                    stem_s2d=True)
        src.initialize(mx.init.Xavier(), ctx=mx.cpu())
        src(mx.nd.array(x, ctx=mx.cpu()))
        arrays = {k: v.data().asnumpy()
                  for k, v in src._collect_params_with_prefix().items()}
        runs = []
        for ctx, devices in ((mx.gpu(0), None),
                             (mx.cpu(), [torch.device("cpu")])):
            net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                        stem_s2d=True)
            set_block_params(net, arrays, ctx=ctx)
            tr = DataParallelTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": lr, "momentum": 0.9},
                mesh=make_mesh({"dp": -1}, devices=devices),
                amp=kind == "amp")
            runs.append(tr.run_steps(x, y, steps=3).asnumpy().tolist())
        gaps = [abs(a - b) for a, b in zip(*runs)]
        if kind == "f32":
            first, later = SMALL_RESNET_LOSS_TOL
            lims = [(first if i == 0 else later) * (1 + abs(b))
                    for i, b in enumerate(runs[1])]
            what = "tol %.0e then %.0e, times 1+|loss|" % (first, later)
        else:
            first, later = AMP_LOSS_TOL
            lims = [(first if i == 0 else later) * abs(b)
                    for i, b in enumerate(runs[1])]
            what = "tol %.0e then %.0e, times |loss|" % (first, later)
        ok = all(g <= lim for g, lim in zip(gaps, lims))
        log("check small ResNet-18 (stem_s2d) DataParallelTrainer 3 steps, "
            "%s, card vs CPU: %s vs %s, gaps %s (%s)  %s"
            % (kind, " ".join("%.6f" % v for v in runs[0]),
               " ".join("%.6f" % v for v in runs[1]),
               " ".join("%.2e" % g for g in gaps), what,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("small ResNet-18 DataParallelTrainer %s card "
                            "vs CPU" % kind)


# ------------------------------------------------------------ fused conv --
# The ResNet-50 3x3 convolutions of benchmark/fused_conv_exp.py:21-26
# (B, H, W, C == K, th, bk): batch 128 for the timing, 16 for the check
CONV_SHAPES = [(128, 56, 56, 64, 28, 64), (128, 28, 28, 128, 28, 128),
               (128, 14, 14, 256, 14, 128), (128, 7, 7, 512, 7, 128)]
CONV_CHECK_B = 16
CONV_PATH_STEPS = 3
# conv3x3_fused against its plain version.  Each sums the 9*C products of
# an output in f32 in its own order: recursive summation errs by at most
# (n - 1) 2^-24 sum|terms| on each side, and an f32 product rounds once
# more (bf16 x bf16 products are exact), so the two accumulators differ by
# at most 2 * 9C * 2^-24 * (|x| conv |w|) ("slack").  A bf16 y rounds each
# accumulator once: one bf16 step, 2^-7 of |y|, beside the slack, with 2%
# to spare.  The stats are held against an f64 reduction of the kernel's
# own f32 accumulator (the same call with out_dtype float32, which is
# checked within the slack): the kernel adds each term at most d times,
# so a sum errs by at most d 2^-24 sum|acc| and a sum of squares by
# (d + 1) 2^-24 sum acc^2 (the squares may round too).  The bf16 kernel
# (conv3x3_tc) writes one partial row per block of 256 (K <= 64) or 128
# consecutive pixels of the flattened B*H*W: d = 47 + ceil(rows / 32),
# 8 additions in a thread (its 8 rows of a column), 3 over the 8 lanes
# of a column (__shfl_xor), at most 4 over the pixel warps, then
# ceil(rows / 32) on each of a reducing column's 32 rows and 32 over
# those rows.  The f32 kernel writes one per 64 pixels of one image:
# d = 52 + ceil(rows / 32) (4 a thread, its 16 pixel groups, then the
# same second pass).  At batch 128 and 56x56 the bf16 kernel's d = 96
# against the N = 401408 terms of a summation in arbitrary order.  The
# planted fault drops one partial row: its pixels are the kernel's own
# blocking (mxt_conv3x3_tile), so every row's drop must fail the check.
CONV_TOL_TEXT = ("y: 1.02*(2^-7*|y| [bf16] + 2*9C*2^-24*(|x| conv |w|)); "
                 "f32 accumulator: 1.02*2*9C*2^-24*(|x| conv |w|); sums vs "
                 "f64 sums of the kernel's accumulator: 1.02*d*2^-24*sum|acc|"
                 ", squares 1.02*(d+1)*2^-24*sum acc^2, d = 47 + "
                 "ceil(rows/32) for bf16 x (rows: 256-pixel tiles of B*H*W "
                 "at K <= 64, else 128), 52 + ceil(rows/32) for f32 x "
                 "(64-pixel tiles of an image)")


def conv_inputs(dev, B, H, W, C, dtype, rng, K=None):
    """x, w, scale, shift as benchmark/fused_conv_exp.py draws them: x
    N(0, 0.1), w N(0, 0.05) (K = C unless given), scale U(0.5, 1.5),
    shift N(0, 0.1)."""
    K = C if K is None else K
    x = torch.from_numpy(rng.randn(B, H, W, C) * 0.1).to(dev, dtype)
    w = torch.from_numpy(rng.randn(3, 3, C, K) * 0.05).to(dev, dtype)
    sc = torch.from_numpy(rng.rand(C) + 0.5).to(dev, torch.float32)
    sh = torch.from_numpy(rng.randn(C) * 0.1).to(dev, torch.float32)
    return x, w, sc, sh


def conv_limits(x, w, kw):
    """Per-element limits on |kernel - plain| of conv3x3_fused's y and of
    its f32 accumulator, and the plain accumulator; see CONV_TOL_TEXT."""
    from mxnet_tpu_torch.kernels import fused_conv as FC
    xin = FC._prologue(x, kw.get("scale"), kw.get("shift"), kw.get("relu"))
    mag = FC.conv3x3_fused_reference(xin.float().abs(), w.float().abs())
    slack = 2 * 9 * x.shape[3] * 2.0 ** -24 * mag
    acc = FC.conv3x3_fused_reference(x, w, **dict(
        kw, stats=False, out_dtype=torch.float32))
    out = kw.get("out_dtype") or x.dtype
    step = 2.0 ** -7 if out == torch.bfloat16 else 2.0 ** -23
    return (1.02 * (step * acc.abs() + slack) + 1e-30,
            1.02 * slack + 1e-30, acc)


def conv_stats_limits(acc, tile, per_image):
    """f64 sums and sums of squares over B, H and W of the kernel's f32
    accumulator ``acc`` (B, H, W, K), the limits on the kernel's f32 sums
    against them (see CONV_TOL_TEXT), and each partial row's f64 partials
    (rows, K), for the planted fault.  A partial row covers ``tile``
    pixels: of one image (``per_image``, the f32 kernel) or of the
    flattened B*H*W (the bf16 kernel)."""
    B, H, W, K = acc.shape
    a = acc.double()
    if per_image:
        tiles = -(-(H * W) // tile)
        rows, d = B * tiles, 52 + -(-(B * tiles) // 32)
        blk = F.pad(a.reshape(B, H * W, K), (0, 0, 0, tiles * tile - H * W))
    else:
        rows = -(-(B * H * W) // tile)
        d = 47 + -(-rows // 32)
        blk = F.pad(a.reshape(B * H * W, K),
                    (0, 0, 0, rows * tile - B * H * W))
    blk = blk.reshape(rows, tile, K)
    u = 2.0 ** -24
    lims = (1.02 * d * u * a.abs().sum((0, 1, 2)),
            1.02 * (d + 1) * u * (a * a).sum((0, 1, 2)))
    return ((a.sum((0, 1, 2)), (a * a).sum((0, 1, 2))), lims,
            (blk.sum(1), (blk * blk).sum(1)))


def conv_blocking(FC, dtype, K):
    """(pixels of one stats partial row, whether a row stays within one
    image) of conv3x3_fused's kernel for x of ``dtype`` and K output
    channels."""
    import ctypes
    bf16 = dtype == torch.bfloat16
    return (FC._fn("mxt_conv3x3_tile", [ctypes.c_int] * 2)(K, int(bf16)),
            not bf16)


def conv_stats_verdict(sums, acc, tile, per_image):
    """The kernel's (sum, sumsq) against conv_stats_limits of its own
    accumulator ``acc``: (largest err/limit, smallest err/limit over the
    planted faults that drop one partial row each, the number of
    rows)."""
    want, lims, parts = conv_stats_limits(acc, tile, per_image)
    ratio, planted = 0.0, None
    for g, r, lim, p in zip(sums, want, lims, parts):
        g = g.double().to(r.device)
        ratio = max(ratio, float(((g - r).abs() / lim).max()))
        caught = ((g - p - r).abs() / lim).amax(1)        # per dropped row
        planted = caught if planted is None else torch.maximum(planted,
                                                               caught)
    return ratio, float(planted.min()), parts[0].shape[0]


def conv_case(FC, x, w, kw, tag, failures):
    """One conv3x3_fused call against its plain version (TF32 off): y
    within conv_limits.  With ``stats``: the kernel's own f32 accumulator
    (the same call with out_dtype float32) within the slack of the plain
    one; the sums within conv_stats_limits of an f64 reduction of that
    accumulator; the sums of two calls bit-identical; and a planted fault,
    the sums less one partial row (one block's pixels), must fail that
    check for every row.  Returns (max |y - plain|, the sums' largest
    err/limit, the planted fault's smallest err/limit over rows), the
    last two None without stats."""
    got = FC.conv3x3_fused(x, w, **kw)
    torch.cuda.synchronize()
    ref = FC.conv3x3_fused_reference(x, w, **kw)
    y, y_ref = (got[0], ref[0]) if kw["stats"] else (got, ref)
    y_lim, acc_lim, acc_ref = conv_limits(x, w, kw)
    e = check(tag + " y", y, y_ref, failures, limit=y_lim)
    if not kw["stats"]:
        return e, None, None
    again = FC.conv3x3_fused(x, w, **kw)
    acc = FC.conv3x3_fused(x, w, **dict(kw, out_dtype=torch.float32))[0]
    torch.cuda.synchronize()
    check(tag + " f32 accumulator", acc, acc_ref, failures, limit=acc_lim)
    ratio, planted, rows = conv_stats_verdict(
        got[1:], acc, *conv_blocking(FC, x.dtype, w.shape[3]))
    same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
    ok = ratio <= 1 and planted > 1 and same and all(
        bool(torch.isfinite(g).all()) for g in got[1:])
    log("check %s stats vs f64 sums of the kernel's accumulator: err/limit "
        "%.3f; one row of partials dropped (planted, each of %d rows): "
        "smallest err/limit %.2f; two calls bit-identical %s  %s"
        % (tag, ratio, rows, planted, same,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append(tag + " stats")
    return e, ratio, planted


CONV_FLAGS = [("none", dict()),
              ("scale+shift+relu+stats", dict(scale=1, relu=True, stats=True)),
              ("scale+shift+stats", dict(scale=1, stats=True)),
              ("relu", dict(relu=True))]


def conv_kw(flags, sc, sh, th, bk, out_dtype=None):
    """conv3x3_fused's keyword arguments for one of CONV_FLAGS."""
    return dict(scale=sc if flags.get("scale") else None,
                shift=sh if flags.get("scale") else None,
                relu=flags.get("relu", False),
                stats=flags.get("stats", False), th=th, bk=bk,
                out_dtype=out_dtype)


def check_conv_kernel(FC, dev, failures):
    """conv3x3_fused against its plain version (TF32 off) at the
    experiment's check size: batch 16 at the four shapes, bf16, the
    experiment's th and bk, with the four flag sets, and two float32
    cases (x, w and y f32; bf16 in, f32 out); see conv_case.  Returns
    the largest |kernel - plain| of a bf16 y, the stats' largest
    err/limit and the planted fault's smallest."""
    rng = np.random.RandomState(0)
    worst, ratios, planted = 0.0, [0.0], []
    cases = [(shape, torch.bfloat16, None, flags)
             for shape in CONV_SHAPES for flags in CONV_FLAGS]
    cases += [(CONV_SHAPES[2], torch.float32, None, CONV_FLAGS[1]),
              (CONV_SHAPES[2], torch.bfloat16, torch.float32, CONV_FLAGS[1])]
    inputs = {}
    for (B, H, W, C, th, bk), dtype, out_dtype, (fname, flags) in cases:
        key = (H, dtype)
        if key not in inputs:
            inputs[key] = conv_inputs(dev, CONV_CHECK_B, H, W, C, dtype, rng)
        x, w, sc, sh = inputs[key]
        tag = "conv3x3 %s->%s B=%d %dx%d C=K=%d %s" % (
            str(dtype)[6:], str(out_dtype or dtype)[6:], CONV_CHECK_B, H, W,
            C, fname)
        e, r, p = conv_case(FC, x, w, conv_kw(flags, sc, sh, th, bk,
                                              out_dtype), tag, failures)
        if dtype == torch.bfloat16 and out_dtype is None:
            worst = max(worst, e)
        if r is not None:
            ratios.append(r)
            planted.append(p)
    return worst, max(ratios), min(planted)


def conv_work(B, H, W, C, K, chain):
    """(bytes, flops) of one 3x3 conv: x, w and y read or written once
    (bf16), plus scale, shift and the two f32 sums for the chain."""
    nbytes = 2 * (B * H * W * C + 9 * C * K + B * H * W * K)
    if chain:
        nbytes += 4 * (2 * C + 2 * K)
    return nbytes, 2 * B * H * W * C * K * 9


def conv_path(FC, dev, failures):
    """The port's twin of benchmark/fused_conv_exp.py ``main()``, the
    conv kernel's only path: at batch 128, the four shapes, the
    experiment's ``pallas_conv`` (x + 1e-3 y) and ``pallas_chain`` (BN
    apply + ReLU -> conv -> stats -> the next BN's scale folded back in)
    carried over CONV_PATH_STEPS steps each, as its scan carries them,
    with the counter from 0 just before and read just after.  Returns the
    launches and each shape's inputs."""
    rng = np.random.RandomState(0)
    shapes = []
    FC.conv3x3_fused.launches = 0
    for B, H, W, C, th, bk in CONV_SHAPES:
        x0, w, scale, shift = conv_inputs(dev, B, H, W, C, torch.bfloat16,
                                          rng)
        gamma = torch.ones(C, device=dev)
        beta = torch.zeros(C, device=dev)

        def pallas_conv(x):
            return x + FC.conv3x3_fused(x, w, th=th, bk=bk) * 1e-3

        def pallas_chain(x):
            y, s, ss = FC.conv3x3_fused(x, w, scale=scale, shift=shift,
                                        relu=True, stats=True, th=th, bk=bk)
            n = x.shape[0] * H * W
            mu = s / n
            var = ss / n - mu * mu
            norm = gamma * torch.rsqrt(var + 1e-5)
            return x + (y * 1e-3 + (norm + beta + mu).to(torch.bfloat16)
                        * 1e-6)

        for fn in (pallas_conv, pallas_chain):
            x = x0
            for _ in range(CONV_PATH_STEPS):
                x = fn(x)
            torch.cuda.synchronize()
            if tuple(x.shape) != (B, H, W, C) or x.dtype != torch.bfloat16 \
                    or not bool(torch.isfinite(x).all()):
                raise Failed("conv path %s %dx%d: %s %s, finite %s" % (
                    fn.__name__, H, W, tuple(x.shape), x.dtype,
                    bool(torch.isfinite(x).all())))
        shapes.append((B, H, W, C, th, bk, x0, w, scale, shift))
    launches = FC.conv3x3_fused.launches
    want = 2 * CONV_PATH_STEPS * len(CONV_SHAPES)
    log("conv path (fused_conv_exp twin, batch 128, 4 shapes x conv and "
        "chain x %d steps): conv3x3_fused launches %d (%d expected)"
        % (CONV_PATH_STEPS, launches, want))
    if launches != want:
        raise Failed("conv3x3_fused launched %d times on its path, expected "
                     "%d" % (launches, want))
    return launches, shapes


def check_conv_path(FC, shapes, failures):
    """conv3x3_fused against its plain version at the size its path runs
    and times (batch 128, each shape's own inputs), with the path's two
    flag sets: the conv alone and the chain's BN apply + ReLU + stats;
    see conv_case.  Returns {(H, kind): max |y - plain|}, the stats'
    largest err/limit and the planted fault's smallest err/limit."""
    errs, ratios, planted = {}, [], []
    for B, H, W, C, th, bk, x, w, sc, sh in shapes:
        for kind, (fname, flags) in (("conv", CONV_FLAGS[0]),
                                     ("chain", CONV_FLAGS[1])):
            tag = "conv3x3 path bf16 B=%d %dx%d C=K=%d %s" % (B, H, W, C,
                                                             fname)
            e, r, p = conv_case(FC, x, w, conv_kw(flags, sc, sh, th, bk),
                                tag, failures)
            errs[H, kind] = e
            if r is not None:
                ratios.append(r)
                planted.append(p)
    return errs, max(ratios), min(planted)


def library_conv(x, w, scale=None, shift=None):
    """Yardstick only (never called by the port): cuDNN through
    ``F.conv2d`` on channels-last bf16, alone or as the experiment's
    chain (BN apply + ReLU -> conv -> channel sums)."""
    xn = x.permute(0, 3, 1, 2)                       # NCHW, channels-last
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if scale is not None:
        xn = torch.relu(xn.float() * scale[:, None, None]
                        + shift[:, None, None]).to(x.dtype)
    y = F.conv2d(xn, wn, padding=1)
    if scale is None:
        return y
    yf = y.float()
    return y, yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))


def time_conv(FC, shapes, errs, flush):
    """Kernel, plain version and cuDNN at batch 128 for each shape, conv
    alone and as the chain, beside the bound and the max |kernel - plain|
    of y from check_conv_path (``errs``).  Returns the rows."""
    rows = []
    for B, H, W, C, th, bk, x, w, sc, sh in shapes:
        chain = dict(scale=sc, shift=sh, relu=True, stats=True, th=th, bk=bk)
        row = {"shape": "bf16 B=%d %dx%d C=K=%d th=%d bk=%d" % (B, H, W, C,
                                                                th, bk)}
        for kind, kw in (("conv", dict(th=th, bk=bk)), ("chain", chain)):
            lib = (lambda: library_conv(x, w)) if kind == "conv" else \
                (lambda: library_conv(x, w, sc, sh))
            b_ms, b_by = bound(*conv_work(B, H, W, C, C, kind == "chain"),
                               torch.bfloat16)
            row[kind] = {
                "ms": cuda_ms(lambda: FC.conv3x3_fused(x, w, **kw),
                              flush=flush),
                "device_ms": device_time(lambda: FC.conv3x3_fused(x, w,
                                                                  **kw),
                                         flush)[0],
                "plain_ms": cuda_ms(lambda: FC.conv3x3_fused_reference(
                    x, w, **kw), iters=5, flush=flush),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(lib, flush=flush),
                "max_abs_err": errs[H, kind]}
        log("info: conv3x3_fused %s" % json.dumps(row))
        rows.append(row)
    return rows


def compare_parent_conv(PFC, FC, shapes, flush):
    """conv3x3_fused of the parent checkout (module ``PFC``) against this
    tree's at the conv path's four batch-128 shapes (``shapes``, from
    conv_path), the conv alone and the chain (BN apply + ReLU + stats),
    in turns (parent, change, change, parent): device ms (profiler, every
    kernel of a call) and event ms, beside the bound.  Logs and returns
    {case: row}."""
    out = {}
    for B, H, W, C, th, bk, x, w, sc, sh in shapes:
        chain = dict(scale=sc, shift=sh, relu=True, stats=True, th=th, bk=bk)
        for kind, kw in (("conv", dict(th=th, bk=bk)), ("chain", chain)):
            got = {"parent": [], "change": []}
            for side in ("parent", "change", "change", "parent"):
                impl = PFC if side == "parent" else FC

                def kern():
                    return impl.conv3x3_fused(x, w, **kw)

                got[side].append((device_time(kern, flush)[0],
                                  cuda_ms(kern, flush=flush)))
            row = {side: {"ms": float(np.mean([d for d, _ in v_])),
                          "event_ms": float(np.mean([e for _, e in v_]))}
                   for side, v_ in got.items()}
            row["speedup_device"] = row["parent"]["ms"] / row["change"]["ms"]
            row["speedup_event"] = (row["parent"]["event_ms"]
                                    / row["change"]["event_ms"])
            row["bound_ms"] = bound(*conv_work(B, H, W, C, C,
                                               kind == "chain"),
                                    torch.bfloat16)[0]
            tag = "%s bf16 B=%d %dx%d C=K=%d" % (kind, B, H, W, C)
            out[tag] = row
            log("info: parent vs change conv3x3_fused %s: %s"
                % (tag, json.dumps(row)))
    return out


# ------------------------------------------------------------------- rtc --
AXPY_SRC = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
"""
# out[z][c][r] = (float)((double)in[z][r][c] * scale): a 3-D grid, one
# 128 x 128 tile a block through 66,048 bytes of dynamic shared memory.
# The sources spell a signature's int64_t as long long (8 bytes, the same
# argument): NVRTC compiles without the C library's headers.
TRANSPOSE_SRC = r"""
#define TILE 128
extern "C" __global__ void transpose_scale(const float *in, float *out,
                                           int rows, long long cols,
                                           double scale) {
    extern __shared__ float tile[];
    const long long z = blockIdx.z;
    const int r0 = blockIdx.y * TILE;
    const long long c0 = (long long)blockIdx.x * TILE;
    const float *src = in + z * rows * cols;
    float *dst = out + z * rows * cols;
    for (int r = threadIdx.y; r < TILE; r += blockDim.y)
        for (int c = threadIdx.x; c < TILE; c += blockDim.x)
            if (r0 + r < rows && c0 + c < cols)
                tile[r * (TILE + 1) + c] =
                    (float)((double)src[(r0 + r) * cols + c0 + c] * scale);
    __syncthreads();
    for (int c = threadIdx.y; c < TILE; c += blockDim.y)
        for (int r = threadIdx.x; r < TILE; r += blockDim.x)
            if (r0 + r < rows && c0 + c < cols)
                dst[(c0 + c) * rows + r0 + r] = tile[r * (TILE + 1) + c];
}
"""
HALF_SRC = r"""
#include <cuda_fp16.h>
extern "C" __global__ void half_scale(const __half *x, float *y,
                                      __half alpha, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = __half2float(__hmul(x[i], alpha));
}
"""
RELU_SRC = r"""
extern "C" __global__ void relu_fwd(const float *x, float *y, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = fmaxf(x[i], 0.f);
}
extern "C" __global__ void relu_bwd(const float *x, const float *dy,
                                    float *dx, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) dx[i] = x[i] > 0.f ? dy[i] : 0.f;
}
"""
RTC_BIG = 64 * 64 * 112 * 112       # ResNet-50's largest activation, f32
RTC_MLP = dict(batch=64, features=2048, hidden=4096, classes=1000, steps=3)


def bits(t):
    """The tensor's raw bits, for bit-for-bit comparisons."""
    return t.contiguous().view(torch.int32)


def abs_err(got, ref):
    """max |got - ref| in f64."""
    return float((got.double() - ref.double()).abs().max())


def rtc_relu_op(mx):
    """A CustomOp whose forward and backward each launch an rtc kernel
    (ReLU: y = max(x, 0); dx = dy * (x > 0)), registered as
    ``rtc_relu``; returns its two kernels."""
    module = mx.rtc.CudaModule(RELU_SRC)
    fwd = module.get_kernel("relu_fwd", "const float *x, float *y, int64_t n")
    bwd = module.get_kernel("relu_bwd",
                            "const float *x, const float *dy, float *dx, "
                            "int64_t n")

    def grid(n):
        return ((n + 255) // 256, 1, 1), (256, 1, 1)

    class RtcRelu(mx.operator.CustomOp):
        def __init__(self, ctx):
            self.ctx = ctx

        # Custom asks for "write" into fresh outputs: the kernels write
        # out_data / in_grad directly
        def forward(self, is_train, req, in_data, out_data, aux):
            n = in_data[0].size
            fwd.launch([in_data[0], out_data[0], n], self.ctx, *grid(n))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            n = in_data[0].size
            bwd.launch([in_data[0], out_grad[0], in_grad[0], n], self.ctx,
                       *grid(n))

    @mx.operator.register("rtc_relu")
    class RtcReluProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            return RtcRelu(ctx)

    return fwd, bwd


def rtc_checks(mx, dev, failures):
    """The rtc kernels against their plain versions, bit for bit: axpy at
    ResNet-50's largest activation against ``y.add_(x, alpha=3)``; the
    transpose (3-D grid, 66 KB of dynamic shared memory, int, int64_t and
    double arguments); a ``const __half *`` kernel; a compile error,
    which must raise MXNetError carrying the NVRTC log; the ReLU CustomOp
    at (64, 64, 112, 112) under ``autograd.record()`` against
    ``nd.Activation(act_type="relu")``, output and gradient.  Returns
    the axpy kernel and its inputs, for the timing, and the largest
    |kernel - plain| over these checks."""
    ctx = mx.gpu(0)
    g = torch.Generator(device=dev).manual_seed(7)

    def verdict(name, ok, what=""):
        log("check rtc %-60s %s  %s" % (name, what, "ok" if ok else "FAIL"))
        if not ok:
            failures.append("rtc " + name)

    axpy = mx.rtc.CudaModule(AXPY_SRC).get_kernel(
        "axpy", "const float *x, float *y, float alpha")
    x = torch.randn(RTC_BIG, generator=g, device=dev)
    y = torch.randn(RTC_BIG, generator=g, device=dev)
    want = y.clone().add_(x, alpha=3.0)
    X, Y = mx.nd.NDArray(x), mx.nd.NDArray(y)
    axpy.launch([X, Y, 3.0], ctx, (RTC_BIG // 256, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    verdict("axpy %d f32 values vs y.add_(x, alpha=3)" % RTC_BIG,
            torch.equal(bits(y), bits(want)), "bit for bit")
    errs = [abs_err(y, want)]

    tr = mx.rtc.CudaModule(TRANSPOSE_SRC).get_kernel(
        "transpose_scale",
        "const float *in, float *out, int rows, int64_t cols, double scale")
    Z, R, C = 3, 1000, 777
    a = torch.randn(Z, R, C, generator=g, device=dev)
    out = torch.empty(Z, C, R, device=dev)
    smem = 128 * 129 * 4
    tr.launch([mx.nd.NDArray(a), mx.nd.NDArray(out), R, C, 0.3], ctx,
              (-(-C // 128), -(-R // 128), Z), (32, 32, 1), shared_mem=smem)
    torch.cuda.synchronize()
    ref = (a.double() * 0.3).float().transpose(1, 2)
    verdict("transpose_scale grid (7, 8, 3), %d B dynamic smem, int/int64_t/"
            "double" % smem, torch.equal(bits(out), bits(ref)), "bit for bit")
    errs.append(abs_err(out, ref))

    hs = mx.rtc.CudaModule(HALF_SRC).get_kernel(
        "half_scale", "const __half *x, float *y, __half alpha, int n")
    n = 1 << 20
    h = torch.randn(n, generator=g, device=dev).half()
    hy = torch.zeros(n, device=dev)
    hs.launch([mx.nd.NDArray(h), mx.nd.NDArray(hy), 1.5, n], ctx,
              (n // 256, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    verdict("half_scale (const __half *, __half scalar) vs (x * 1.5).float()",
            torch.equal(bits(hy), bits((h * 1.5).float())), "bit for bit")
    errs.append(abs_err(hy, (h * 1.5).float()))

    try:
        mx.rtc.CudaModule('extern "C" __global__ void bad(float *x) '
                          '{ x[0] = undefined_name; }')
        verdict("compile error raises MXNetError", False, "no error raised")
    except mx.MXNetError as e:
        verdict("compile error raises MXNetError with the NVRTC log",
                "undefined_name" in str(e), repr(str(e).splitlines()[-1][:80]))

    for k, want_n in ((axpy, 1), (tr, 1), (hs, 1)):
        if k.launches != want_n:
            verdict("%s launch count" % k.name, False,
                    "%d, %d expected" % (k.launches, want_n))

    # the ReLU CustomOp against nd.Activation, recorded, at 64x64x112x112
    xs = torch.randn(64, 64, 112, 112, generator=g, device=dev)
    head = torch.randn(xs.shape, generator=g, device=dev)
    res = []
    for custom in (True, False):
        v = mx.nd.NDArray(xs.clone())
        v.attach_grad()
        with mx.autograd.record():
            o = mx.nd.Custom(v, op_type="rtc_relu") if custom else \
                mx.nd.Activation(v, act_type="relu")
        o.backward(mx.nd.NDArray(head))
        torch.cuda.synchronize()
        res.append((o._data.detach(), v.grad._data))
    (o1, g1), (o2, g2) = res
    verdict("CustomOp(rtc relu) vs Activation(relu), 64x64x112x112, output",
            torch.equal(bits(o1), bits(o2)), "bit for bit")
    verdict("CustomOp(rtc relu) vs Activation(relu), 64x64x112x112, gradient",
            torch.equal(bits(g1), bits(g2)), "bit for bit")
    errs += [abs_err(o1, o2), abs_err(g1, g2)]
    log("rtc checks: max |kernel - plain| %.3e" % max(errs))
    del xs, head, res, o1, g1, o2, g2, a, out, ref, want
    return axpy, X, Y, max(errs)


def rtc_path(mx, fwd, bwd, failures):
    """The rtc path as an MXNet user drives it, counters from 0 just
    before and read just after: upstream's axpy example (y == 3), then a
    Gluon HybridBlock (Dense 4096 -> the rtc ReLU CustomOp -> Dense 1000,
    batch 64) trained RTC_MLP["steps"] steps by ``gluon.Trainer`` SGD; its
    losses and parameters must equal, bit for bit, those of the same net
    with ``nn.Activation("relu")`` trained from the same weights.
    Returns the launches by kernel and the largest |custom - built-in|
    over the example's y (against 3), the losses and the parameters."""
    from mxnet_tpu_torch.convert import set_block_params
    nn = mx.gluon.nn
    ctx = mx.gpu(0)
    cfg = RTC_MLP

    class Net(mx.gluon.HybridBlock):
        def __init__(self, custom):
            super().__init__()
            self._custom = custom
            with self.name_scope():
                self.fc1 = nn.Dense(cfg["hidden"], in_units=cfg["features"])
                if not custom:
                    self.act = nn.Activation("relu")
                self.fc2 = nn.Dense(cfg["classes"], in_units=cfg["hidden"])

        def hybrid_forward(self, F, x):
            h = self.fc1(x)
            h = F.Custom(h, op_type="rtc_relu") if self._custom \
                else self.act(h)
            return self.fc2(h)

    rng = np.random.RandomState(3)
    xb = mx.nd.array(rng.randn(cfg["batch"], cfg["features"])
                     .astype(np.float32), ctx=ctx)
    yb = mx.nd.array(rng.randint(0, cfg["classes"], cfg["batch"])
                     .astype(np.float32), ctx=ctx)
    np.random.seed(3)
    ref_net = Net(False)
    ref_net.initialize(mx.init.Xavier(), ctx=ctx)
    ref_net.hybridize()
    arrays = {k: v.data().asnumpy()
              for k, v in ref_net._collect_params_with_prefix().items()}
    net = Net(True)
    set_block_params(net, arrays, ctx=ctx)
    net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    fwd.launches = bwd.launches = 0
    axpy = mx.rtc.CudaModule(AXPY_SRC).get_kernel(
        "axpy", "const float *x, float *y, float alpha")
    axpy.launches = 0
    torch.cuda.synchronize()
    x = mx.nd.ones((10,), ctx=ctx)
    y = mx.nd.zeros((10,), ctx=ctx)
    axpy.launch([x, y, 3.0], ctx, (1, 1, 1), (10, 1, 1))
    ok = bool((y.asnumpy() == 3.0).all())
    err = float(np.abs(y.asnumpy() - 3.0).max())
    log("check rtc upstream axpy example (ones, zeros, alpha 3, grid (1,1,1)"
        " block (10,1,1)): y = %s  %s" % (y.asnumpy().tolist(),
                                          "ok" if ok else "FAIL"))
    if not ok:
        failures.append("rtc upstream axpy example")
    runs = []
    for model in (net, ref_net):
        tr = mx.gluon.Trainer(model.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        losses = []
        for _ in range(cfg["steps"]):
            with mx.autograd.record():
                L = loss_fn(model(xb), yb)
            L.backward()
            tr.step(cfg["batch"])
            losses.append(L._data.detach().clone())
        torch.cuda.synchronize()
        runs.append((losses, [p.data()._data.detach().clone() for p in
                              model._collect_params_with_prefix().values()]))
    launches = {"axpy": axpy.launches, "relu_fwd": fwd.launches,
                "relu_bwd": bwd.launches}
    (l1, p1), (l2, p2) = runs
    same_l = all(torch.equal(bits(a), bits(b)) for a, b in zip(l1, l2))
    same_p = all(torch.equal(bits(a), bits(b)) for a, b in zip(p1, p2))
    err = max([err] + [abs_err(a, b) for a, b in zip(l1 + p1, l2 + p2)])
    log("check rtc CustomOp MLP (Dense %d -> rtc relu -> Dense %d, bs %d) "
        "%d Trainer steps vs nn.Activation('relu'): mean losses %s, losses "
        "bit for bit %s, parameters bit for bit %s  %s"
        % (cfg["hidden"], cfg["classes"], cfg["batch"], cfg["steps"],
           " ".join("%.6f" % float(v.mean()) for v in l1), same_l, same_p,
           "ok" if same_l and same_p else "FAIL"))
    if not (same_l and same_p):
        failures.append("rtc CustomOp MLP vs Activation")
    losses = [float(v.mean()) for v in l1]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        failures.append("rtc CustomOp MLP loss did not fall")
    log("rtc path launches: %s" % json.dumps(launches))
    want = {"axpy": 1, "relu_fwd": cfg["steps"], "relu_bwd": cfg["steps"]}
    if launches != want:
        raise Failed("rtc path launches %s, expected %s" % (launches, want))
    return launches, err


def time_rtc(axpy, X, Y, mx, flush):
    """axpy at ResNet-50's largest activation: the rtc kernel, its plain
    version (y + alpha * x, two torch ops) and ``y.add_(x, alpha=)``,
    beside the bound (12 bytes a value)."""
    x, y = X._data, Y._data
    grid = (RTC_BIG // 256, 1, 1)
    b_ms, b_by = bound(12 * RTC_BIG, 2 * RTC_BIG, torch.float32)
    row = {"ms": cuda_ms(lambda: axpy.launch([X, Y, 3.0], mx.gpu(0), grid,
                                             (256, 1, 1)), flush=flush),
           "plain_ms": cuda_ms(lambda: y.copy_(y + 3.0 * x), flush=flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms(lambda: y.add_(x, alpha=3.0), flush=flush),
           "shape": "axpy over 64x64x112x112 = %d f32 values" % RTC_BIG}
    log("info: rtc axpy %s" % json.dumps(row))
    return row


# ------------------------------------------------------------------- main --
def serve(G, ServingEngine, params, cfg, reqs, kv_int8, dev, spy=None,
          eager=False):
    """The mix through one engine, its step captured (``eager``: run op
    by op); asserts every request finished and no page leaked."""
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, kv_int8=kv_int8, device=dev)
    eng._eager = eager
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
    log("serve kv_int8=%s %s: %d requests, %d steps, %d tokens in %.3f s "
        "(%.1f tok/s, %.3f ms/step), pages in use after %d, peak pages %d"
        % (kv_int8, "eager" if eager else "captured", len(rids), steps,
           toks, dt, toks / dt, dt * 1e3 / steps, eng.cache.pages_in_use,
           eng.stats["peak_pages"]))
    if bad:
        raise Failed("requests not finished: %s" % bad[:8])
    if eng.cache.pages_in_use != 0:
        raise Failed("pages leaked: %d" % eng.cache.pages_in_use)
    for r in rids:
        o = outs[r]
        if o.min() < 0 or o.max() >= cfg.vocab_size:
            raise Failed("token out of the vocabulary in request %d" % r)
    return outs, {"steps": steps, "tokens": toks, "seconds": dt}


def same_tokens(name, got, want, failures):
    """Every request's tokens identical; logs and records a failure."""
    bad = [r for r in want if not np.array_equal(got[r], want[r])]
    log("check %s: %d of %d requests token-identical  %s"
        % (name, len(want) - len(bad), len(want), "FAIL" if bad else "ok"))
    if bad:
        failures.append(name)


def main(argv):
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = argv[1]
    elif argv:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as FA
    from mxnet_tpu_torch.kernels import fused_conv as FC
    from mxnet_tpu_torch.kernels import fused_optimizer as FO
    from mxnet_tpu_torch.kernels import paged_attention as PA
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.models import transformer as T_
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.serving import engine as E

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card:", card_line())
    dev = torch.device("cuda", 0)
    failures = []

    t_start = t0 = time.perf_counter()
    phase("start")
    with ThreadPoolExecutor(len(_build.SOURCES)) as ex:   # one nvcc each
        list(ex.map(_build.load, _build.SOURCES))
    log("build: %d kernels in %.1f s" % (len(_build.SOURCES),
                                          time.perf_counter() - t0))
    build = build_report(_build)
    conv_build = {k: v for k, v in build.items()
                  if "conv3x3" in k or "reduce_stats" in k}
    if not any("conv3x3_tc" in k for k in conv_build) or any(
            v["tensor_core_instructions"] == 0 for k, v in conv_build.items()
            if "conv3x3_tc" in k):
        failures.append("conv3x3_tc: no tensor-core instructions in its "
                        "build")

    phase("build")
    # ---- 3. each kernel against its plain version at the path's shapes
    errs = {"paged": 0.0, "flash": 0.0}
    errs_paged = check_paged_kernels(PA, dev, failures)
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
    errs_train = check_training_kernels(FA, dev, failures)
    dq_ragged = check_dq_ragged(FA, dev, failures)
    errs_sgd = check_sgd_kernels(FO, dev, resnet50_shapes(mx), failures)
    err_conv_b16, stats_b16, planted_b16 = check_conv_kernel(FC, dev,
                                                            failures)

    phase("kernel checks")
    # ---- 4. the serving path, counters from 0
    cfg = G.gpt_config(vocab_size=VOCAB, max_len=MAX_LEN, d_model=D,
                       n_heads=HEADS, n_layers=LAYERS, d_ff=FF,
                       dtype="bfloat16", dropout=0.0)
    master = G.init_params(0, cfg, device=dev)
    params = G.prepare_params(G.quantize_decode_params(master), cfg, dev)
    reqs = workload(0)
    log("mix: %d requests, prompt tokens %d, new tokens %d"
        % (len(reqs), sum(p.size for p, _ in reqs),
           sum(n for _, n in reqs)))

    # keep the paged kernel's real inputs at one mid-run step (of the
    # engines that run op by op)
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
    try:                    # op by op: the spy sees every step's inputs
        outs16e, run16e = serve(G, ServingEngine, params, cfg, reqs, False,
                                dev, spy, eager=True)
        outs8e, run8e = serve(G, ServingEngine, params, cfg, reqs, True,
                              dev, spy, eager=True)
    finally:
        E.paged_attention = orig
    # the main path: the engine's captured step, then generate
    zero_counters(FA, PA, FO)
    outs16, run16 = serve(G, ServingEngine, params, cfg, reqs, False, dev)
    outs8, run8 = serve(G, ServingEngine, params, cfg, reqs, True, dev)
    t0 = time.perf_counter()
    gen = G.generate(params, cfg, prompts, 64, device=dev)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = {"paged_attention": PA.paged_attention.launches,
                "flash_fwd": FA.flash_fwd.launches}
    log("serving path launches:", json.dumps(launches))
    steps = run16["steps"] + run8["steps"]
    log("paged_attention launches per engine step: %.2f (%d layers)"
        % (launches["paged_attention"] / steps, LAYERS))
    log("generate: (4, 192) + 64 new tokens in %.3f s" % t_gen)
    if tuple(gen.shape) != (4, 256) or int(gen.min()) < 0 \
            or int(gen.max()) >= VOCAB:
        raise Failed("generate returned %s" % (tuple(gen.shape),))
    for name, n in launches.items():
        if n <= 0:
            raise Failed("%s was never launched on the serving path"
                         % name)
    if launches["paged_attention"] != steps * LAYERS:
        raise Failed("paged_attention counted %d launches under replay, "
                     "expected %d" % (launches["paged_attention"],
                                      steps * LAYERS))
    same_tokens("bf16/w8 engine, float KV, captured vs eager", outs16,
                outs16e, failures)
    same_tokens("bf16/w8 engine, int8 KV, captured vs eager", outs8,
                outs8e, failures)
    report = {"serving": {
        "eager_tokens_per_s": [run16e["tokens"] / run16e["seconds"],
                               run8e["tokens"] / run8e["seconds"]],
        "captured_tokens_per_s": [run16["tokens"] / run16["seconds"],
                                  run8["tokens"] / run8["seconds"]],
        "eager_ms_per_step": [run16e["seconds"] * 1e3 / run16e["steps"],
                              run8e["seconds"] * 1e3 / run8e["steps"]],
        "captured_ms_per_step": [run16["seconds"] * 1e3 / run16["steps"],
                                 run8["seconds"] * 1e3 / run8["steps"]],
        "note": "[float KV, int8 KV], the 64-request mix"}}
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

    phase("serving")
    # ---- 6. the training paths, each with its own counters from 0
    bert_cfg = T_.bert_base(**BERT)
    init_state, step = T_.make_train_step(bert_cfg, learning_rate=1e-4,
                                          weight_decay=0.01, device=dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in bert_batch().items()}
    log("BERT batch: %d x %d tokens, %d labelled, %d padded"
        % (BERT_B, BERT_T, int((batch["labels"] >= 0).sum()),
           int((~batch["mask"]).sum())))
    state, bert_losses, bert_launches, bert_s = train_path(
        "BERT-base train", init_state, step, batch, dev, BERT_STEPS,
        BERT_WARM, FA, PA, FO, LAYERS, seed=0)
    log("BERT-base train step: %.3f ms, %.1f tokens/s (host clock over "
        "steps %d-%d, synchronised), peak memory %.2f GiB"
        % (bert_s * 1e3, BERT_B * BERT_T / bert_s, BERT_WARM + 1,
           BERT_STEPS, torch.cuda.max_memory_allocated() / 2**30))
    check_remat(T_, bert_cfg, state[0], batch, dev, failures)
    captured_vs_eager("BERT-base train", init_state, step, batch, dev, 0,
                      failures)
    report["bert"] = step_times(init_state, step, batch, dev, 10, 3, 0)
    log("info: BERT-base train step ms, eager vs captured: %s"
        % json.dumps(report["bert"]))

    gpt_train_cfg = G.gpt_config(vocab_size=VOCAB, max_len=MAX_LEN,
                                 d_model=D, n_heads=HEADS, n_layers=LAYERS,
                                 d_ff=FF, dtype="bfloat16", dropout=0.1,
                                 remat=False)
    g_init, g_step = G.make_train_step(gpt_train_cfg, device=dev)
    rng = np.random.RandomState(1)
    gmask = np.ones((GPT_B, MAX_LEN), bool)
    gmask[:2, 400:] = False
    gbatch = {"tokens": rng.randint(1, VOCAB, (GPT_B, MAX_LEN)) * gmask,
              "mask": gmask}
    _, _, gpt_launches, gpt_s = train_path(
        "GPT causal train", g_init, g_step, gbatch, dev, GPT_STEPS,
        GPT_WARM, FA, PA, FO, LAYERS, seed=1)
    log("GPT causal train step (bs %d x %d): %.3f ms (host clock over "
        "steps %d-%d, synchronised)" % (GPT_B, MAX_LEN, gpt_s * 1e3,
                                        GPT_WARM + 1, GPT_STEPS))
    gbatch = {k: torch.as_tensor(v).to(dev) for k, v in gbatch.items()}
    captured_vs_eager("GPT causal train", g_init, g_step, gbatch, dev, 1,
                      failures)
    report["gpt"] = step_times(g_init, g_step, gbatch, dev, 8, 2, 1)
    log("info: GPT causal train step ms, eager vs captured: %s"
        % json.dumps(report["gpt"]))
    if parent is not None:        # before any profiler session
        PFA = load_parent(parent, "flash_attention")
        compare_parent_steps(PFA, FA, dev, {
            "BERT-base train step": (init_state, step, batch, 10, 3, 0),
            "GPT causal train step": (g_init, g_step, gbatch, 8, 2, 1)})
        PPA = load_parent(parent, "paged_attention")
        compare_parent_serving(PPA, E, G, ServingEngine, params, cfg, reqs,
                               dev)
    check_small_f32(T_, dev, failures)

    phase("training")
    # ---- 7. the Gluon path: ResNet-50 v1 through Trainer, then the
    # grouped update routes on one step's gradients (counters from 0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    resnet_launches, resnet, sgd_rows = resnet_path(mx, FA, PA, FO, dev,
                                                    failures, flush)
    check_small_resnet(mx, dev, failures)

    phase("gluon")
    # ---- 7c. bench.py's workload through DataParallelTrainer; the BERT and
    # GPT steps' graphs and pools are freed first (captured again for the
    # profiles below)
    for stp in (step, g_step):
        stp._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    report["bench"] = bench_path(mx, failures, resnet)
    check_small_bench(mx, failures)

    phase("bench")
    # ---- 7b. the extension surface, each path with its counters from 0:
    # the fused conv experiment's twin, then rtc kernels through CustomOp
    t_ext = time.perf_counter()
    conv_launches, conv_shapes = conv_path(FC, dev, failures)
    conv_errs, stats_b128, planted_b128 = check_conv_path(FC, conv_shapes,
                                                          failures)
    relu_fwd, relu_bwd = rtc_relu_op(mx)
    axpy, ax_x, ax_y, err_rtc = rtc_checks(mx, dev, failures)
    rtc_launches, err_rtc_path = rtc_path(mx, relu_fwd, relu_bwd, failures)
    t_ext = time.perf_counter() - t_ext

    phase("extension")
    # ---- 8. timings at the paths' shapes
    kernels = []
    q, pool, s, bt, pos = captured["bfloat16"]
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/kernels/paged_attention.py:209",
        "device_symbols": ["paged_split", "paged_combine"],
        "launches": launches["paged_attention"],
        "launches_note": "calls, two kernel launches each",
        "max_abs_err": errs["paged"], "tolerance": PAGED_TOL_TEXT,
        **time_paged(PA, q, pool, s, bt, pos, flush),
        "shape": "captured engine step, bf16 pool: T=32 H=12 dh=64 ps=16 "
                 "PP=32 NP=513",
        "synthetic_max_abs_err": errs_paged,
        "build": {k: v for k, v in build.items() if k.startswith("paged")}})
    q8, pool8, s8, bt8, pos8 = captured["int8"]
    log("info: paged int8 captured step: %s" % json.dumps(
        time_paged(PA, q8, pool8, s8, bt8, pos8, flush)))
    for i, kind in enumerate(("float32", "bfloat16", "int8")):
        log("info: paged %s synthetic engine shape: %s" % (kind, json.dumps(
            time_paged(PA, *paged_inputs(dev, kind, seed=70 + i), flush))))

    time_prefill(FA, dev, flush, errs["flash"])

    by_path = {"serving": launches,
               "bert": bert_launches, "gpt": gpt_launches}
    sources = {"flash_fwd": ("flash_fwd.cu", 169),
               "flash_bwd_dq": ("flash_bwd.cu", 333),
               "flash_bwd_dkv": ("flash_bwd.cu", 354)}
    symbols = {"flash_fwd": ["flash_fwd_tc", "flash_fwd_f32"],
               "flash_bwd_dq": ["flash_bwd_dq_tc", "flash_bwd_dq_f32"],
               "flash_bwd_dkv": ["flash_bwd_dkv_tc", "flash_bwd_dkv_f32"]}
    dh256 = time_dh256(FA, dev, flush)
    for name, row in time_training_kernels(FA, dev, flush).items():
        src, line = sources[name]
        counts = {p: c[name] for p, c in by_path.items() if name in c}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/kernels/csrc/" + src,
            "replaces": "mxnet_tpu/kernels/flash_attention.py:%d" % line,
            "device_symbols": symbols[name],
            "launches": sum(counts.values()), "launches_by_path": counts,
            "max_abs_err": errs_train[name],
            "tolerance": (FWD_TOL_TEXT if name == "flash_fwd"
                          else BWD_TOL_TEXT),
            **row, "dh256": dh256[name],
            **({"ragged_err_over_limit": dq_ragged}
               if name == "flash_bwd_dq" else {}),
            "build": {k: v for k, v in build.items() if k.startswith(name)}})
    if parent is not None:
        compare_parent_kernels(PFA, FA, dev, flush)
        compare_parent_paged(PPA, PA, dev, flush)
    for name, line in (("fused_sgd_mom", 144), ("fused_sgd", 134)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/kernels/csrc/fused_sgd.cu",
            "replaces": "mxnet_tpu/kernels/fused_optimizer.py:%d" % line,
            "launches": resnet_launches[name],
            "launches_by_path": {"resnet50": resnet_launches[name]},
            "max_abs_err": errs_sgd[name], "tolerance": "bit for bit",
            **sgd_rows[name]})

    t_time = time.perf_counter()
    conv_rows = time_conv(FC, conv_shapes, conv_errs, flush)
    if parent is not None:
        compare_parent_conv(load_parent(parent, "fused_conv"), FC,
                            conv_shapes, flush)
    kernels.append({
        "name": "conv3x3_fused", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/fused_conv.cu",
        "replaces": "mxnet_tpu/kernels/fused_conv.py:143",
        "launches": conv_launches,
        "launches_by_path": {"fused_conv_exp": conv_launches},
        **conv_rows[0]["conv"], "shape": conv_rows[0]["shape"] + " conv",
        "max_abs_err": max(conv_errs.values()), "tolerance": CONV_TOL_TEXT,
        "stats_err_over_limit": stats_b128,
        "planted_dropped_block_err_over_limit": planted_b128,
        "check_b16": {"max_abs_err": err_conv_b16,
                      "stats_err_over_limit": stats_b16,
                      "planted_dropped_block_err_over_limit": planted_b16},
        "by_shape": conv_rows, "build": conv_build,
        "library": "F.conv2d (cuDNN), channels-last bf16; the chain adds "
                   "BN apply + ReLU before and channel sums after"})
    rtc_row = time_rtc(axpy, ax_x, ax_y, mx, flush)
    del ax_x, ax_y
    log("extension phases (conv and rtc paths, checks and timings): %.1f s"
        % (t_ext + time.perf_counter() - t_time))
    kernels.append({
        "name": "rtc", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc.py",
        "replaces": "mxnet_tpu/rtc.py:74",
        "launches": sum(rtc_launches.values()),
        "launches_by_path": {"rtc": rtc_launches},
        "max_abs_err": max(err_rtc, err_rtc_path),
        "tolerance": "bit for bit", **rtc_row,
        "library": "y.add_(x, alpha=3.0)",
        "note": "NVRTC-compiled user kernels; the timed one is upstream's "
                "axpy"})

    phase("kernel timings")
    # each window's kernels of the port, held to their launch counters
    paged_kernels = [(sym, lambda: PA.paged_attention.launches, [sym])
                     for sym in ("paged_split", "paged_combine")]
    flash_kernels = [(k, lambda k=k: getattr(FA, k).launches, symbols[k])
                     for k in symbols]
    for eager in (True, False):
        mode = "eager" if eager else "captured"
        report["serving"]["profile_" + mode] = profile_steps(
            ServingEngine, params, cfg, reqs, dev, eager, paged_kernels)
    g_state = g_init(seed=1)
    for name, st, stp, b, n in (("bert", state, step, batch, BERT_PROFILE),
                                ("gpt", g_state, g_step, gbatch,
                                 GPT_PROFILE)):
        gen_p = torch.Generator(device=dev).manual_seed(3)
        for eager in (True, False):
            mode = "eager" if eager else "captured"
            stp._eager = eager
            try:
                for _ in range(2):      # a captured step captures here
                    stp(st, b, gen_p)
                report[name]["profile_" + mode] = profile_window(
                    lambda: stp(st, b, gen_p), n, "%s train steps, %s"
                    % ("BERT-base" if name == "bert" else "GPT causal",
                       mode), kernels=flash_kernels)
            finally:
                stp._eager = False
    del state, g_state
    report["resnet50"] = {k: resnet[k] for k in (
        "ms_per_step", "images_per_s", "hybridized_ms_per_step",
        "hybridized_images_per_s", "profile")}

    phase("step profiles")
    # ---- 9. small float32 engine on the card vs generate on the CPU
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

    # the full-width f32 engine, captured and op by op, against generate
    # on the card: token-identical
    f32cfg = G.gpt_config(**{**cfg.__dict__, "dtype": "float32"})
    few = [(p[:64], 32) for p, _ in reqs[:4]]
    runs = []
    for eager in (True, False):
        eng = ServingEngine(master, f32cfg, num_slots=SLOTS, page_size=PAGE,
                            prefill_chunk=CHUNK, device=dev)
        eng._eager = eager
        rids = [eng.submit(p, n) for p, n in few]
        outs = eng.run()
        runs.append({i: outs[r] for i, r in enumerate(rids)})
    want = {i: G.generate(master, f32cfg, p[None], n, device=dev)[0]
            .cpu().numpy() for i, (p, n) in enumerate(few)}
    same_tokens("full-width f32 engine, captured vs eager", runs[1],
                runs[0], failures)
    same_tokens("full-width f32 engine (captured) vs generate", runs[1],
                want, failures)
    phase("small models")
    log("info: compiled steps: %s" % json.dumps(report))

    log("chip_smoke: %.1f s in all" % (time.perf_counter() - t_start))
    if failures:
        raise Failed("checks failed: %s" % ", ".join(failures))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Failed as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
