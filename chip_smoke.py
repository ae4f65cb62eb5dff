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
4b. drives the engine's three options: a small f32 model (2 layers,
   d_model 128, 2 heads, vocab 128) through the captured engine on the card with
   ``prefix_cache``, ``spec_K=3`` and ``overlap`` each alone and all three
   together on a preempting pool (ngram and an adversarial callable
   drafter), each token-identical to ``generate`` on the card, and greedy
   ``generate_speculative`` (ngram and self drafters) equal to it; then
   on the ``full`` preset (captured, one warm request outside the clock):
   the 64-request mix with overlap off and on in turns (tokens identical,
   tok/s, ms/step, ``host_hidden_ms``, ``overlap_steps``, a profiled
   window each for busy time and idle share, and one more run each with
   timers for the host's phases and the device's time a step),
   serve_bench's shared-prefix
   mix (``shared_prefix_frac=0.5``, 96-token prefix) with the prefix cache
   off and on in turns (tokens identical, ``prefix_hit_tokens``,
   ``cow_copies``),
   ``run_gate_prefix``'s hit and cold TTFT (P = 192, N = 4, best of 3),
   ``spec_K`` = 0, 2, 4 with the ngram drafter (accept rate, tokens
   committed per decode slot-step; tokens against ``spec_K=0`` reported)
   after holding the paged kernel against its plain version on a live
   ``spec_K=4`` step's inputs (96 rows),
   and all three options on the shared-prefix mix with the paged
   kernel's counter from 0 held to steps x layers; every run ends with
   no page or prefix ref left;
4c. drives telemetry (``metrics=True``, the profiler's request lanes)
   and the host-DRAM KV tier (``tier_bytes``), the kernel counters from
   0: the small f32 model through a captured engine with the prefix
   cache, a 64 MB tier and a 12-page pool that preempts and spills,
   overlap off and on, float KV token-identical to ``generate`` on the
   card and int8 KV to the same engine with the tier off, tier spills,
   installs and swap-ins > 0, no page, ref or tier entry left; on the
   ``full`` preset serve_bench's ``run_gate_tier`` (TTFT of a P = 192
   prompt cold, hot and warm, best of 3, ``hot < warm < cold``; resume
   after ``preempt()`` with the tier on and off, ``swap <
   recompute``, tokens identical); the 64-request mix through a
   150-page pool with the tier on and off (tokens identical, swap-ins >
   0); the 12-page chain's export and install by CUDA events beside
   plain pinned copies and ``nvidia-smi``'s PCIe link; and the mix,
   overlapped, with metrics off, on, and on with the profiler
   recording, in turns (tokens identical; ``serving_steps_total``,
   ``serving_tokens_total`` and the TTFT count equal to the steps,
   tokens and requests; the profiler's dump loads as JSON with a ``req
   N`` lane per request holding admission_wait, prefill, decode and
   retire);
5. holds the paged kernel against its plain version on the inputs kept
   from the live engine (its real pools, block table and positions);
6. drives the training paths, each with the counters set to 0 just
   before it and read just after: 20 steps of BERT-base masked-LM
   pretraining (bs 16 x 512, dropout 0.1, bf16, AdamW, no remat) on
   one synthetic batch, asserting finite, falling loss and 12 launches
   of each flash kernel per step, then one step with remat (the
   "nothing" and the "dots" policy) against one without from the same
   state; the step op by op's peak memory, the captured step's ms and
   its flash launches a step with no remat, "nothing" and "dots" (in
   turns; 2 forwards a layer under both policies); ``scan_steps=4``:
   one call against 4 single calls bit for bit, then ms a step of each
   in turns, their graph pools and the device operations a replay; and
   12 steps of causal GPT training at the ``full`` width (bs 8 x 512),
   then one GPT step under "dots" against one without; each step
   replays one CUDA graph;
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
7a. drives the symbolic API (the ``module`` phase): the model zoo's
   ResNet-50 v1 (Xavier from a seed) exported by ``HybridBlock.export``,
   loaded by ``mx.sym.load``, wrapped in ``SoftmaxOutput`` and bound by
   ``mx.mod.Module(context=mx.gpu(0))`` at bs 64 x 3 x 224 x 224, f32,
   SGD lr 0.1 momentum 0.9 wd 1e-4: 3 steps with the executor replaying
   its CUDA graphs against 3 with ``_eager`` bit for bit (outputs,
   parameters, running statistics, momentum; deterministic cuDNN); then,
   with every launch counter from 0 (all stay 0: no hand-written kernel
   is on this path), 20 steps of each, and of a captured module at wd 0
   (the Gluon step's settings), in turns beside the hybridized Gluon
   step, and a profiled window each; ``Module.fit`` over an
   ``NDArrayIter`` of 4 batches with ``Speedometer`` and
   ``do_checkpoint``, then ``Module.load`` and ``score`` (equal to the
   live module's); ``SymbolBlock.imports`` of the export at bs 64
   against the Gluon net's eval output (f32, plain and hybridized) and
   ``amp.convert_model(..., "bfloat16")`` against f32, with ms per batch
   of both; examples/nmt_bucketing.py's ``BucketingModule`` (buckets
   8/16/24, vocab 32, 60 batches of 32) captured, ``_eager`` and on the
   CPU (parameters bit for bit, accuracy within 0.02 of the CPU's); a
   ResNet-18 Module on the card and on the CPU from one ``.params``
   file, losses compared;
7d. drives the op library (the ``library`` phase, after ``module``),
   every launch counter from 0 (all but ``nms_keep``, which the vision
   ops' cases launch, stay 0): every case of ``tests/_torch_port.py``'s ``OP_SPECS``
   (each op and alias of the registry) through the port on the card and
   on the CPU from the same inputs, forward and backward, TF32 off,
   within ``CARD_TOL`` by family, and any registered op the sweep
   misses fails the run; each sampler of ``RANDOM_SPECS`` on the card
   (seeded draws repeat, unseeded differ, support, moments within 6
   standard errors) and a hybridized block drawing ``F.random_uniform``
   through its CUDA graph (new values each replay, repeated after a
   re-seed); ResNet-50 v1 (bs 64 x 224^2, f32) through ``gluon.Trainer``
   with Adam under a ``CosineScheduler``, 20 steps eager and 20
   hybridized (finite, falling loss; the rate each step equal to a
   scheduler stepped on the host), then the eager and hybridized Adam
   steps and the hybridized SGD step timed in turns, a profiled window
   each and ``trainer.step``'s host time alone; every optimizer of the
   reference's registry (and ``multi_precision`` on float16 for sgd,
   nag, adam and lamb) training a thumbnail ResNet-18 3 steps on the
   card and on the CPU within FAMILY_LOSS_TOL; ``save_states`` /
   ``load_states`` resuming bit for bit; ``SequentialModule`` with Adam
   on the card past the reference test's accuracy;
7e. drives recurrent networks (the ``rnn`` phase, after ``library``),
   every launch counter from 0 (all stay 0: no hand-written kernel is
   on this path): the fused ``RNN`` op for each mode, 1 and 2 layers,
   uni- and bidirectional, outputs and gradients on the card against
   the CPU within RNN_TOL; the cells unrolled against the fused layer
   whose flat vector packs their weights; ``foreach``, ``while_loop``
   and ``cond`` in a hybridized block replayed bit for bit against the
   block op by op; ``mx.sym.RNN`` through a bound executor, card against
   CPU; MXNet's word language model at full width (WLM_*: 2-layer LSTM
   650, vocabulary 33,278, tied, dropout 0.5, bs 32 x bptt 35, SGD lr
   20, ``clip_global_norm``) built from the public API, 20 steps op by
   op then 20 hybridized (finite loss, the median of the last 5 below
   the first), 3 captured
   steps bit for bit against op by op at dropout 0, then the eager and
   hybridized steps timed in turns with tokens/s, a profiled window each
   (busy, idle, kernels a step) and the peak memory; and the port's
   2 x 650 LSTM layer forward + backward, op by op and hybridized,
   beside cuDNN's (``torch._VF.lstm`` on the same weights as views, a
   call the port never makes), outputs within YARD_TOL, in turns;
7f. drives the vision zoo (the ``zoo`` phase, after ``rnn``), every
   launch counter from 0 (all stay 0: no hand-written kernel is on this
   path): each case of ``tests/_torch_zoo.py``'s ``CONV_CASES`` (the
   conv, transposed conv, pooling and padding layers) hybridized on the
   card against the CPU from the same weights, forward and backward,
   within ``CARD_TOL`` by family; then AlexNet, VGG-16, DenseNet-121,
   SqueezeNet 1.0, Inception v3 and MobileNet v2 1.0 through
   ``get_model`` at ImageNet width (ZOO: 1000 classes, 224^2, Inception
   299^2; bs 64, f32, TF32 off, Dropout 0) under ``gluon.Trainer`` SGD:
   ZOO_CHECK steps hybridized against op by op bit for bit (outputs,
   parameters, running statistics, momentum; deterministic cuDNN), the
   eager and hybridized steps timed in turns with images/s, the
   hybridized net's loss finite and falling, and a profiled window
   (busy, idle, kernels a step) for MobileNet v2 and Inception v3;
7g. drives the detection ops (the ``detection`` phase, after ``zoo``),
   every launch counter from 0 around its main path (only ``nms_keep``
   may launch, and must): ``examples/ssd_detection.py``'s SSD at its
   own width through ``tests/_torch_ssd.py`` (32 x 32 images, bs 32,
   Adam lr 2e-3), 3 steps hybridized against op by op bit for bit, then
   the example's 40 hybridized steps and its decode (mean IoU, class
   accuracy, ms a step beside op by op); one call each of
   ``MultiBoxTarget`` and ``MultiBoxDetection`` at SSD300 scale (MXNet's
   example/ssd VGG16-reduced 300: six maps, 8732 anchors; B 32, 16
   label rows, 21 classes, hard negatives 3:1, NMS 0.45 over the top
   400) and ``Proposal`` at Faster R-CNN's RPN scale (38 x 50 x 9
   anchors, 6000 -> 300 at 0.7); the SSD symbol bound and replayed
   against op by op; then, counters kept, the ops against their CPU
   path (2 images), ``nms_keep`` against its plain version on the card
   (N 400 and 8732, with class ids and across them, and flag for flag
   at the SSD300 decode's own inputs, all 32 images) and the ops and
   the kernel timed;
7h. drives Gluon data, the Estimator and the sparse storage (the
   ``data`` phase, after ``detection``), every launch counter from 0
   and still 0 after: a thumbnail ResNet-18 (apache/mxnet
   example/gluon/image_classification.py for CIFAR-10, full width, f32,
   TF32 off, hybridized, SGD lr 0.1 momentum 0.9 wd 5e-4) through
   ``Estimator.fit`` from a ``DataLoader`` (CIFAR-10's 50,000 synthetic
   train images, flips, ``ToTensor``, ``Normalize``, bs 128, 4 forked
   workers, pinned batches) with a ``CheckpointHandler``: first the 4
   workers' batches against the in-process loader's on a deterministic
   pipeline and 3 Estimator steps hybridized against op by op, bit for
   bit; then 150 batches (images/s, the consumer's wait on the loader,
   the train accuracy, which must beat chance), the checkpoint reloaded
   to the same outputs, the same step fed from batches on the card and
   from a loader with no workers; matrix factorization (apache/mxnet
   example/sparse/matrix_factorization at MovieLens-10M's id ranges,
   factor 128, hidden 64, bs 1024) with ``Embedding(sparse_grad=True)``
   and lazy Adam, hybridized, 100 steps, against dense Adam on the same
   net (ms a step, rows touched and host reads a step), one step held
   against the CPU and a step's untouched rows held bit for bit; the
   sparse ops at Criteo's shape (8192 x 1,000,000, 39 entries a row):
   ``dot(csr, w)``, ``dot(csr.T, g)`` and a lazy ``sgd_update`` against
   scipy and numpy, each timed;
7i. drives the image pipeline (the ``image`` phase, after ``bench``; under
   60 s), every launch counter from 0 around its main path (only
   ``image_aug`` and ``jpeg_color`` may launch, and both must): 2,048
   seeded synthetic photos at ImageNet's stored shape (``im2rec --resize
   480 --quality 95``: 480 x 640 or 640 x 480, 4:2:0) encoded by nvJPEG
   and packed with ``recordio``; the card's decode (nvJPEG's planes, then
   ``jpeg_color``) against libjpeg's pixels of ``tests/data/torch_image``
   in full and at 1/2 scale within DECODE_*/HALF_*; ``jpeg_color`` (at
   scale 1, 1/2, 1/4) and ``image_aug`` bit for bit against their plain
   versions on two batches decoded and planned as the iterator's card
   route does (random crops and flips with DCT scaling, the main path's
   own input; centre crops; ``resize=256``; NHWC without DCT scaling; an
   image smaller than the crop), ``image_aug``'s bound from the pixels
   its crop windows read; then ``ImageRecordIter`` on the card alone (bs
   128, 224^2 random crops and flips, e2e_train_bench.py's mean and std:
   images/s, ms a batch of reading, decoding and augmenting, a profiled
   window) and the full path ``ImageRecordIter ->
   DevicePrefetchIter(super_size=BENCH_STEPS) -> run_steps`` of the
   ``bench`` phase's s2d trainer (images/s over IMG_SUPERS superbatches
   after the ones filled ahead, beside its resident-batch figure; the
   consumer's wait a superbatch, a profiled superbatch, a falling loss);
   no image decoded outside a batched nvJPEG call; the host route (the
   native libjpeg loader) beside it where the machine has libjpeg's and
   libpng's headers, else a line naming the missing ones;
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
   kernels, SDPA, ``nms_keep`` (at the SSD300 decode's own inputs),
   ``image_aug`` and ``jpeg_color`` (at a decoded batch of 128) by their
   device time (torch.profiler, 20 calls)
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
import random
import shutil
import subprocess
import sys
import tempfile
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
PREFIX_LEN = (max(PROMPT_LENS) // 2 // PAGE) * PAGE      # 96
# the serving options on the preset (serve_bench.py: the shared-prefix
# mix at shared_prefix_frac 0.5, run_gate_prefix's TTFT at P = 192,
# N = 4, best of 3; speculation depths)
SHARED_FRAC, TTFT_NEW, TTFT_REPS = 0.5, 4, 3
SPEC_KS = (0, 2, 4)
# the telemetry and tier phase: serve_bench.py run_gate_tier's host tier
# (_TIER_BYTES, 64 MB) and resume pair (n_new 8, preempted after 4);
# the 64-request mix through a pool of TIER_POOL pages (of the 513 the
# 16 slots need at most), so that preemptions swap out; the 12-page
# chain's transfers timed TRANSFER_REPS times
TIER_BYTES, TIER_POOL, RESUME_NEW, TRANSFER_REPS = 1 << 26, 150, 8, 10
# PCIe per-lane rates (GT/s) and line-code efficiency by generation
PCIE_GTS = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}

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
REMAT_POLICIES = (None, "nothing", "dots")
SCAN_K = 4

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

# the library phase: ResNet-50 v1 at the Gluon cell's shapes (bs 64 x 3 x
# 224 x 224, 1000 classes, f32, Xavier from np.random.seed(0)) trained by
# gluon.Trainer with Adam (lr 1e-3, wd 1e-4) under a CosineScheduler
# (max_update 40, warmup 5): LIB_STEPS eager steps, then LIB_STEPS
# hybridized; then windows of LIB_WINDOW steps of each, and of the
# hybridized SGD step (the Gluon cell's), in turns
LIB_LR, LIB_WD, LIB_MAX_UPDATE, LIB_WARMUP = 1e-3, 1e-4, 40, 5
LIB_STEPS, LIB_WINDOW, LIB_TURNS, LIB_PROFILE = 20, 5, 2, 5
# the optimizer family: each optimizer of the reference's registry trains
# the thumbnail ResNet-18 3 steps on the card and on the CPU (f32, TF32
# off, 32 x 32, batch 4) from the same weights, at its own default rate
# (momentum 0.9 for sgd, nag and lars) but for adagrad and signum (lr
# 1e-3) and adadelta (epsilon 1e-7): at their defaults (lr 0.01, epsilon
# 1e-5) the first steps move every weight by about 0.01 whatever its
# gradient's size and this net's loss rises (H100: adagrad 1.23 then
# 1.57), a regime where f32 rounding noise in near-zero gradients picks
# the trajectory (gaps of 0.27 measured); multi_precision on a float16
# copy at 16 x 16 for sgd, nag, adam and lamb (the CPU's float16
# convolutions are slow).  Mean-loss limits, times (1 + |loss|): the first
# step (a forward of the same weights) and the later ones.  SGD and NAG
# take SMALL_RESNET_LOSS_TOL; the others scale each update element by its
# own history (Adam, RMSProp, AdaGrad, AdaDelta, Adamax, Nadam, FTRL,
# LAMB) or take its sign (Signum), so a gradient element that is f32
# rounding noise on both devices moves its weight by up to lr on one and
# not the other (tests/test_torch_optimizers.py measures 2986 of 11.2M
# ResNet-18 weights apart after one Adam step, port against reference):
# 1e-3 later; float16 rounds each activation to 2^-11, 2e-2 later
FAMILY = ("sgd", "nag", "adam", "adagrad", "rmsprop", "rmsprop-centered",
          "ftrl", "signum", "lamb", "lars", "adadelta", "adamax", "nadam")
FAMILY_OPTS = {"sgd": {"momentum": 0.9}, "nag": {"momentum": 0.9},
               "lars": {"momentum": 0.9}, "adagrad": {"learning_rate": 1e-3},
               "signum": {"learning_rate": 1e-3},
               "adadelta": {"epsilon": 1e-7},
               "rmsprop-centered": {"centered": True}}
FAMILY_MP = ("sgd", "nag", "adam", "lamb")
FAMILY_LOSS_TOL = {"sgd": SMALL_RESNET_LOSS_TOL,
                   "nag": SMALL_RESNET_LOSS_TOL, "other": (1e-5, 1e-3),
                   "float16": (1e-2, 2e-2)}

# the rnn phase.  The word language model: apache/mxnet
# example/gluon/word_language_model (model.py, train.py) with its README's
# WikiText-2 command --tied --nhid 650 --emsize 650 --dropout 0.5 and the
# script's defaults for the rest: a 2-layer LSTM, WikiText-2's vocabulary,
# batch 32 x bptt 35 (TNC), SGD lr 20, gradients clipped by
# clip_global_norm at 0.25 x bptt x batch, f32 (TF32 off); depth not cut.
# The tokens are a seeded Zipf stream over the vocabulary (no dataset is
# fetched).  The weights are Uniform(0.1): the fused layer's flat
# parameter vector takes no Xavier (ndim 1), in the reference too.
WLM_VOCAB, WLM_WIDTH, WLM_LAYERS, WLM_DROPOUT = 33278, 650, 2, 0.5
WLM_BPTT, WLM_B, WLM_LR, WLM_CLIP = 35, 32, 20.0, 0.25
WLM_STEPS, WLM_CHECK, WLM_WINDOW, WLM_TURNS, WLM_PROFILE = 20, 3, 10, 2, 5
# the small card-vs-CPU checks (T, N, input width, hidden): outputs and
# gradients within RNN_TOL x (1 + |CPU|) (cuBLAS's f32 sums in another
# order over 5 steps), the cells against the fused layer too
RNN_SMALL, RNN_TOL = (5, 3, 4, 6), 1e-5
# the port's LSTM layer against cuDNN's (torch._VF.lstm, never called by
# the port) at the word LM's shape, on the same weights: outputs within
# YARD_TOL (35 steps of f32 summed in two orders; |h| < 1)
YARD_TOL = 1e-4

# the zoo phase: the six vision families the port gained, each through
# get_model at ImageNet width (1000 classes, 3 x 224^2; inceptionv3 3 x
# 299^2), Xavier from np.random.seed, at the Gluon ResNet-50 cell's
# settings (bs 64, f32, TF32 off) under gluon.Trainer SGD lr 0.01
# momentum 0.9 wd 1e-4 on one seeded synthetic batch, Dropout rates 0:
# ZOO_CHECK steps hybridized against op by op bit for bit (deterministic
# cuDNN), then, captured again with cuDNN's default algorithms and one
# step each outside the clock, ZOO_WINDOW-step windows eager,
# hybridized, hybridized, eager, and a profiled window of ZOO_PROFILE
# hybridized steps for the two families whose structure is new
# (depthwise convs, concats)
ZOO = (("alexnet", 224), ("vgg16", 224), ("densenet121", 224),
       ("squeezenet1.0", 224), ("inceptionv3", 299),
       ("mobilenetv2_1.0", 224))
ZOO_B, ZOO_LR, ZOO_CHECK, ZOO_WINDOW, ZOO_PROFILE = 64, 0.01, 3, 5, 3
ZOO_PROFILED = ("mobilenetv2_1.0", "inceptionv3")

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

# the module phase: the model zoo's ResNet-50 v1 exported from Gluon,
# loaded with mx.sym.load, wrapped in SoftmaxOutput and trained through
# mx.mod.Module at the Gluon ResNet cell's settings (bs 64 x 3 x 224 x
# 224, f32, SGD lr 0.1 momentum 0.9) with wd 1e-4 (and, timed beside it,
# wd 0, as the Gluon step runs); MODULE_CHECK steps captured vs eager
# bit for bit, MODULE_STEPS timed steps of each in windows of
# MODULE_WINDOW in turns, MODULE_FIT batches through fit
MODULE_WD, MODULE_CHECK, MODULE_STEPS, MODULE_WINDOW = 1e-4, 3, 20, 10
MODULE_FIT, SERVE_CALLS = 4, 10
# SymbolBlock serving of the export, TF32 off: the f32 graph against the
# Gluon net's eval output, max |diff| <= SERVE_F32_TOL x (1 + max |gluon|)
# (the same ops and weights; only cuDNN's choice of algorithm, and so the
# f32 summation order, can differ); amp.convert_model's bf16 graph
# against the f32 one, ||bf16 - f32|| / ||f32|| <= SERVE_BF16_TOL (bf16
# rounds every conv input to 8 bits of mantissa, 2^-9 relative, over 53
# convolutions)
SERVE_F32_TOL, SERVE_BF16_TOL = 1e-4, 5e-2
# examples/nmt_bucketing.py (the Sockeye configuration at the example's
# size): buckets 8/16/24, vocab 32, embedding 16, 60 batches of 32 from
# its seeded BucketIter, SGD lr 0.5; the card's accuracy within
# NMT_ACC_TOL of the same run on the CPU
NMT_BUCKETS, NMT_VOCAB, NMT_EMB = (8, 16, 24), 32, 16
NMT_BATCHES, NMT_B, NMT_LR, NMT_ACC_TOL = 60, 32, 0.5, 0.02
AMP_LOSS_TOL = (1e-2, 2e-2)


# the image phase (after bench): MXNet's ImageNet input pipeline on the
# card.  IMG_N seeded synthetic photos at ImageNet's stored shape
# (tools/im2rec.py --resize 480 --quality 95: short side 480, a 4:3 /
# 3:4 mix, 4:2:0), encoded by nvJPEG, packed with recordio, read by
# ImageRecordIter on the card (bs 128, 224^2 random crops and flips, the
# mean and std of benchmark/e2e_train_bench.py:82-83) and fed through
# DevicePrefetchIter(super_size=BENCH_STEPS) to bench.py's s2d trainer
# (the pipeline shape of e2e_train_bench.py:60-100)
IMG_N, IMG_B, IMG_SHORT, IMG_LONG, IMG_Q = 2048, 128, 480, 640, 95
IMG_SHAPE = (3, 224, 224)
IMG_MEAN, IMG_STD = (123.68, 116.78, 103.94), (58.4, 57.12, 57.38)
# batches timed alone and profiled alone; the full path's superbatches
# timed, after a warm one and IMG_DRAIN more (DevicePrefetchIter's queue
# of one and the one its worker holds, filled while the warm one trained)
IMG_ALONE, IMG_PROFILE = 12, 4
IMG_SUPERS, IMG_DRAIN = 3, 2
# the card's decode (nvJPEG's planes, then jpeg_color's libjpeg
# upsampling and colour tables) against libjpeg's pixels of the fixtures
# (tests/data/torch_image, OpenCV's decode): only the IDCT's rounding
# differs, so each image's mean |difference| stays within DECODE_MEAN
# levels and no pixel moves more than DECODE_MAX; the DCT-scaling
# stand-in (planes box-averaged) against libjpeg's 1/2-scale decode (a
# reduced IDCT) within HALF_MEAN and HALF_MAX
DECODE_MEAN, DECODE_MAX = 0.25, 4
HALF_MEAN, HALF_MAX = 1.0, 24
IMG_FIXTURES = os.path.join(REPO, "tests", "data", "torch_image")

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


def workload(seed=0, shared_prefix_frac=0.0):
    """The preset's request mix, drawn as serve_bench.py ``_workload``
    draws it (same seed, same sequence of draws): [(prompt, n_new)].
    With ``shared_prefix_frac`` F, a fraction F of the requests open
    with one fixed prefix of PREFIX_LEN tokens (a "system prompt": half
    the longest prompt on the page grid, at most the prompt less one
    token) and a random tail."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, VOCAB, PREFIX_LEN).astype(np.int32)
    out = []
    for _ in range(N_REQ):
        rng.exponential(1.0 / 100.0)
        P = int(rng.choice(PROMPT_LENS))
        N = int(rng.choice(OUT_LENS))
        if shared_prefix_frac > 0.0 and rng.rand() < shared_prefix_frac:
            head = shared[:min(P - 1, PREFIX_LEN)]
            tail = rng.randint(1, VOCAB, P - head.size).astype(np.int32)
            out.append((np.concatenate([head, tail]), N))
        else:
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
# the device's idle time on each side of a profiled window's steps, and
# the name of the host span around them (profile_window)
PROFILE_MARGIN_S = 0.05
PROFILE_SPAN = "chip_smoke.profiled_steps"


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


def log_window_edges(work, kernels):
    """Information on a window that disagrees: where its first and last
    device events lie, and where the checked kernels' first and last do,
    in ms from the window's first device event (a loss at one edge shows
    as a checked kernel near it)."""
    if not work:
        log("info: the window holds no device event")
        return
    t0 = min(ev.time_range.start for ev in work)
    t1 = max(ev.time_range.end for ev in work)
    log("info: the window's device events span %.3f ms" % ((t1 - t0) / 1e3))
    for label, _, symbols in kernels:
        hit = [ev for ev in work if any(sym in ev.name for sym in symbols)]
        if hit:
            log("info:   %s: first starts at %.3f ms, last ends %.3f ms "
                "before the window's last device event"
                % (label, (min(ev.time_range.start for ev in hit) - t0) / 1e3,
                   (t1 - max(ev.time_range.end for ev in hit)) / 1e3))


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
    that ran other kernels disagrees every time).

    The profiler there also loses, now and then, the first device
    events of its session (seen on the card in the kernel timings: the
    first step's layer-1 ``paged_split`` missing, its ``paged_combine``
    the window's first device event).  So a checked window opens with one
    call of ``step`` that is neither timed nor held to the counters
    (its counts are logged); then the device idles PROFILE_MARGIN_S, the
    ``n`` calls run inside a ``record_function`` span, and the device
    idles PROFILE_MARGIN_S again.  Only device events inside that span,
    widened by half the margin each side, count, are timed and are held
    to the counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    margin_us = PROFILE_MARGIN_S * 1e6 / 2
    for attempt in range(1, 4 if kernels else 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if kernels:
                w0 = [counter() for _, counter, _ in kernels]
                step()
                torch.cuda.synchronize()
                warm = [counter() - c for (_, counter, _), c
                        in zip(kernels, w0)]
                time.sleep(PROFILE_MARGIN_S)
            before = [counter() for _, counter, _ in kernels]
            with record_function(PROFILE_SPAN):
                t0 = time.perf_counter()
                for _ in range(n):
                    step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / n
            after = [counter() for _, counter, _ in kernels]
            time.sleep(PROFILE_MARGIN_S)
        work, other, how = device_work(prof)
        span = [ev for ev in prof.events() if ev.name == PROFILE_SPAN
                and ev.device_type == DeviceType.CPU]
        if len(span) != 1:
            raise Failed("profile of %s: %d spans named %s recorded, 1 "
                         "expected" % (what, len(span), PROFILE_SPAN))
        lo = span[0].time_range.start - margin_us
        hi = span[0].time_range.end + margin_us

        def inside(ev):
            return lo <= ev.time_range.start and ev.time_range.end <= hi

        if kernels:
            for (label, _, symbols), c in zip(kernels, warm):
                log("info: profile of %s, attempt %d, its opening call "
                    "(not held): %s counted %d launches, the device ran %d"
                    % (what, attempt, label, c, sum(
                        1 for ev in work if not inside(ev)
                        and any(sym in ev.name for sym in symbols))))
        work = [ev for ev in work if inside(ev)]
        other = [ev for ev in other if inside(ev)]
        by_name = {}
        for ev in work:
            t, c = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (t + ev.time_range.elapsed_us(), c + 1)
        seen = [(label, c1 - c0,
                 sum(c for name, (_, c) in by_name.items()
                     if any(sym in name for sym in symbols)))
                for (label, _, symbols), c0, c1 in zip(kernels, before,
                                                       after)]
        bad = [x for x in seen if x[1] != x[2]]
        for label, counted, ran in seen:
            log("check profile of %d %s, attempt %d: %s counted %d "
                "launches, the device ran %d such kernels  %s"
                % (n, what, attempt, label, counted, ran,
                   "ok" if counted == ran else "MISMATCH"))
        if not bad:
            break
        log_window_edges(work, kernels)
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
                  warm=60, n=20, **kw):
    """Profile ``n`` engine steps (bf16/w8, float KV, engine options
    ``kw``) after ``warm``, the step captured or (``eager``) op by op,
    its paged kernels held to the launch counter (``kernels``, as
    profile_window takes them); returns profile_window's numbers."""
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, device=dev, **kw)
    eng._eager = eager
    for p, n_new in reqs:
        eng.submit(p, n_new)
    for _ in range(warm):
        eng.step()
    try:
        return profile_window(eng.step, n, "engine steps, %s%s"
                              % ("eager" if eager else "captured",
                                 "".join(", %s=%s" % x for x in kw.items())),
                              kernels=kernels)
    finally:
        eng.close()


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


def remat_cfg(cfg, policy):
    """``cfg`` with remat under ``policy`` ("nothing", "dots"), or off
    for None."""
    return dataclasses.replace(cfg, remat=policy is not None,
                               remat_policy=policy or "nothing")


def check_remat(make_train_step, cfg, params, batch, dev, failures,
                policy="nothing", name="BERT-base"):
    """One step with remat under ``policy`` and one without from the
    same params and the same generator seed: the same loss and
    gradients."""
    from mxnet_tpu_torch.convert import tree_leaves
    out = []
    for pol in (None, policy):
        init_state, step = make_train_step(remat_cfg(cfg, pol), device=dev)
        state = init_state(params=params)
        gen = torch.Generator(device=dev).manual_seed(11)
        state, loss = step(state, batch, gen)
        out.append((float(loss), [p.grad for p in tree_leaves(state[0])]))
        del state
    (l0, g0), (l1, g1) = out
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(g1, g0))
    ok = abs(l1 - l0) <= REMAT_LOSS_TOL * abs(l0) and worst <= REMAT_GRAD_TOL
    label = "remat" if policy == "nothing" else "remat %s" % policy
    log("check %s vs no remat (%s, one step): loss %.6f vs %.6f, "
        "largest grad diff / leaf max %.3e (tol %.0e)  %s"
        % (label, name, l1, l0, worst, REMAT_GRAD_TOL,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("%s vs no remat (%s)" % (label, name))


def held_memory():
    """Bytes the caching allocator holds once dead objects and free
    cached blocks are released: live tensors and the private pools of
    the live CUDA graphs."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def remat_costs(T_, FA, PA, FO, cfg, params, batch, dev, failures, n=10,
                warm=3):
    """BERT-base with no remat, "nothing" and "dots": the step op by
    op's peak memory above the state it starts from (one step after a
    first one made the AdamW state), the captured step's ms (host clock
    over ``n`` synchronised steps after ``warm``, in turns none,
    nothing, dots, dots, nothing, none; medians), what the captured step
    holds (``graph_pool_gib``: its state, gradients, AdamW moments and
    graph pool, :func:`held_memory` before and after) and the flash
    launches a step of the first timed turn (counters from 0 around
    it); 2 forwards a layer under both remat policies (the recompute),
    1 without."""
    steps = {pol: T_.make_train_step(remat_cfg(cfg, pol), device=dev)
             for pol in REMAT_POLICIES}
    out = {}
    for pol, (init_state, step) in steps.items():
        state = init_state(params=params)
        gen = torch.Generator(device=dev).manual_seed(3)
        step._eager = True
        try:
            step(state, batch, gen)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(state, batch, gen)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        finally:
            step._eager = False
        del state
        gc.collect()
        torch.cuda.empty_cache()
        out[str(pol)] = {"eager_peak_gib": peak / 2**30, "ms": [],
                         "graph_pool_gib": None}
    sides = {}
    for pol in REMAT_POLICIES + REMAT_POLICIES[::-1]:
        init_state, step = steps[pol]
        row = out[str(pol)]
        if pol not in sides:
            reserved = held_memory()
            sides[pol] = (init_state(params=params),
                          torch.Generator(device=dev).manual_seed(3))
        state, gen = sides[pol]
        for _ in range(warm):
            step(state, batch, gen)
        torch.cuda.synchronize()
        if row["graph_pool_gib"] is None:
            row["graph_pool_gib"] = (held_memory() - reserved) / 2**30
            zero_counters(FA, PA, FO)
        first = not row["ms"]
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
        row["ms"].append((time.perf_counter() - t0) * 1e3 / n)
        if first:
            row["flash_launches"] = counters(FA)
            row["flash_per_step"] = {k: c / n for k, c in
                                     row["flash_launches"].items()}
    for pol in REMAT_POLICIES:
        row = out[str(pol)]
        row["ms_per_step"] = float(np.median(row["ms"]))
        want = 1 if pol is None else 2
        got = row["flash_per_step"]["flash_fwd"] / LAYERS
        ok = got == want and all(
            row["flash_per_step"][k] == LAYERS
            for k in ("flash_bwd_dq", "flash_bwd_dkv"))
        log("check BERT-base remat %s: %.3f ms/step captured (runs %s), "
            "eager step peak %.2f GiB above the state, held after capture "
            "(state, gradients, AdamW, graph pool) %.2f GiB, "
            "flash launches a step %s (flash_fwd %d a layer expected)  %s"
            % (pol, row["ms_per_step"], " ".join("%.3f" % x
                                                 for x in row["ms"]),
               row["eager_peak_gib"], row["graph_pool_gib"],
               json.dumps(row["flash_per_step"]), want,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("remat %s flash launches" % pol)
    del sides, steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_scan(T_, FA, PA, FO, cfg, params, batch, dev, failures, k=SCAN_K,
               calls=3):
    """``scan_steps=k``: one call (one replayed graph of k steps)
    against k single captured calls from the same params and generator
    seed, losses, parameters and AdamW state bit for bit; then ms a
    step of each, in turns (single, scan, scan, single; ``calls``
    scanned calls against ``calls * k`` single ones), what each
    captured step holds (:func:`held_memory`: state, gradients, AdamW
    moments and graph pool), and the device operations one replay runs
    (profiler).  Returns (numbers, flash launches of the first timed
    scanned calls)."""
    from mxnet_tpu_torch.convert import tree_leaves
    makers = {"single": T_.make_train_step(cfg, device=dev),
              "scan": T_.make_train_step(cfg, device=dev, scan_steps=k)}
    sides, runs, pools = {}, {}, {}
    for name, (init_state, step) in makers.items():
        reserved = held_memory()
        state = init_state(params=params)
        gen = torch.Generator(device=dev).manual_seed(5)
        if name == "single":
            losses = torch.stack([step(state, batch, gen)[1]
                                  for _ in range(k)])
        else:
            losses = step(state, batch, gen)[1]
        torch.cuda.synchronize()
        pools[name] = (held_memory() - reserved) / 2**30
        leaves = tree_leaves(state[0])
        runs[name] = (losses, leaves, [v for p in leaves
                                       for v in state[1].state[p].values()],
                      gen.get_state())
        sides[name] = (state, gen)
    (l0, p0, s0, g0), (l1, p1, s1, g1) = runs["single"], runs["scan"]
    same = (torch.equal(l0, l1) and torch.equal(g0, g1)
            and all(torch.equal(a, b) for a, b in zip(p0 + s0, p1 + s1)))
    log("check BERT-base scan_steps=%d, one call vs %d single calls "
        "(captured): losses %s vs %s, %d parameters and %d AdamW tensors "
        "bit for bit: %s  %s"
        % (k, k, " ".join("%.6f" % x for x in l1.tolist()),
           " ".join("%.6f" % x for x in l0.tolist()), len(p0), len(s0),
           same, "ok" if same else "FAIL"))
    if not same:
        failures.append("scan_steps vs single calls")
    del runs
    times = {"single": [], "scan": []}
    launches = None
    for name in ("single", "scan", "scan", "single"):
        state, gen = sides[name]
        step = makers[name][1]
        n = calls * k if name == "single" else calls
        step(state, batch, gen)
        torch.cuda.synchronize()
        if name == "scan" and launches is None:
            zero_counters(FA, PA, FO)
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / (calls * k))
        if name == "scan" and launches is None:
            launches = counters(FA)
    ops = {}
    for name in ("single", "scan"):
        state, gen = sides[name]
        step = makers[name][1]
        ops[name] = device_kernels(lambda: step(state, batch, gen))[0]
    out = {name: {"ms_per_step": float(np.median(v)), "runs": v,
                  "graph_pool_gib": pools[name],
                  "device_ops_per_call": ops[name]}
           for name, v in times.items()}
    ratio = out["scan"]["ms_per_step"] / out["single"]["ms_per_step"]
    log("info: BERT-base scan_steps=%d: %.3f ms/step scanned vs %.3f "
        "single captured calls (ratio %.4f), held after capture (state, "
        "gradients, AdamW, graph pool) %.2f vs %.2f GiB, "
        "device operations a replay %s vs %s; flash launches over %d "
        "scanned calls %s"
        % (k, out["scan"]["ms_per_step"], out["single"]["ms_per_step"],
           ratio, pools["scan"], pools["single"], ops["scan"],
           ops["single"], calls, json.dumps(launches)))
    if any(c != calls * k * LAYERS for c in launches.values()):
        failures.append("scan_steps flash launches %s" % launches)
    del sides, makers
    gc.collect()
    torch.cuda.empty_cache()
    out["scan_over_single"] = ratio
    return out, launches


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


# ---------------------------------------------------------------- module --
def export_resnet(mx, tmp, name, ctx, x, seed, **kw):
    """The model zoo's ``name`` with Xavier weights from
    ``np.random.seed(seed)`` on ``ctx``, one predict-mode forward on
    ``x`` (deferred shapes), exported to ``tmp``: (net, prefix)."""
    np.random.seed(seed)
    net = getattr(mx.gluon.model_zoo.vision, name)(**kw)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(x)
    prefix = os.path.join(tmp, name)
    net.export(prefix)
    return net, prefix


def softmax_module(mx, head, args, aux, ctx, shape, lr, mom, wd, eager):
    """``mx.mod.Module`` over ``head`` bound for training at ``shape``,
    parameters from ``args``/``aux``, SGD; ``eager`` runs its executor
    op by op."""
    mod = mx.mod.Module(head, context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": lr, "momentum": mom, "wd": wd})
    mod._exec._eager = eager
    return mod


def module_step(mod, batch):
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()


def module_state(mod):
    """Copies of the outputs, the parameters, the aux states and the
    momentum traces."""
    exe = mod._exec
    return ([o._data.clone() for o in mod.get_outputs()]
            + [exe.arg_dict[n]._data.clone() for n in mod._param_names]
            + [exe.aux_dict[n]._data.clone() for n in mod._aux_names]
            + [s._data.clone() for s in mod._opt_states.values()
               if s is not None])


def softmax_loss(mod, y):
    """The mean cross-entropy of the module's softmax outputs at ``y``
    (host, float64)."""
    p = mod.get_outputs()[0].asnumpy().astype(np.float64)
    return float(-np.log(p[np.arange(len(y)), y.astype(np.int64)]).mean())


def module_path(mx, failures, gluon):
    """The symbolic API on the card as a reference-era user drives it:
    ResNet-50 v1 exported from Gluon, loaded with ``mx.sym.load`` and
    trained through ``mx.mod.Module`` (captured vs eager bit for bit;
    MODULE_STEPS steps of each, timed in turns beside the hybridized
    Gluon step ``gluon``, with every launch counter from 0; a profiled
    window each); ``fit`` with ``Speedometer`` and ``do_checkpoint``,
    then ``Module.load`` and ``score``; ``SymbolBlock.imports`` of the
    export against the Gluon net, plain, hybridized and through
    ``amp.convert_model`` in bf16; the NMT ``BucketingModule``.
    Returns the numbers."""
    from mxnet_tpu_torch._graphs import kept_launches
    card = card_line()
    ctx = mx.gpu(0)
    torch.backends.cudnn.allow_tf32 = True       # as the Gluon cell
    tmp = tempfile.mkdtemp(prefix="chip_smoke_module_")
    nums = {"card": card}
    try:
        rng = np.random.RandomState(11)
        xs = rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW).astype(np.float32)
        ys = rng.randint(0, RESNET_CLASSES, RESNET_B).astype(np.float32)
        x, y = mx.nd.array(xs, ctx=ctx), mx.nd.array(ys, ctx=ctx)
        net, prefix = export_resnet(mx, tmp, "resnet50_v1", ctx, x[:1], 0,
                                    classes=RESNET_CLASSES)
        sym = mx.sym.load(prefix + "-symbol.json")
        ops = [n.op.name for n in sym._nodes() if not n.is_var]
        head = mx.sym.SoftmaxOutput(sym, name="softmax")
        args, aux = mx.model.load_params(prefix + "-0000.params")
        log("module: ResNet-50 v1 exported and loaded: %d nodes, %d ops "
            "(%s), %d arguments, %d aux states"
            % (len(sym._nodes()), len(ops), json.dumps(
                {k: ops.count(k) for k in sorted(set(ops))}),
               len(head.list_arguments()), len(head.list_auxiliary_states())))
        batch = mx.io.DataBatch(data=[x], label=[y])
        shape = (RESNET_B, 3, RESNET_HW, RESNET_HW)

        def make(eager, wd=MODULE_WD):
            return softmax_module(mx, head, args, aux, ctx, shape, RESNET_LR,
                                  RESNET_MOM, wd, eager)

        flag = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        runs = []
        try:
            for eager in (True, False):
                mod = make(eager)
                for _ in range(MODULE_CHECK):
                    module_step(mod, batch)
                runs.append(module_state(mod))
                del mod
                gc.collect()
        finally:
            torch.backends.cudnn.deterministic = flag
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log("check Module ResNet-50 %d steps captured vs eager "
            "(deterministic cuDNN): %d tensors (outputs, parameters, running "
            "statistics, momentum traces) bit for bit: %s  %s"
            % (MODULE_CHECK, len(runs[0]), same, "ok" if same else "FAIL"))
        if not same:
            failures.append("Module ResNet-50 captured vs eager")
        del runs

        # the main path: MODULE_STEPS steps of each, in turns, every launch
        # counter from 0 (no hand-written kernel is on this path); and the
        # captured step without weight decay, the Gluon step's optimizer
        # settings (two fewer launches a tensor in the per-tensor update)
        torch.cuda.reset_peak_memory_stats()
        mods = {"eager": make(True), "captured": make(False),
                "captured wd 0": make(False, 0.0)}
        times = {m: [] for m in mods}
        losses = {m: [] for m in mods}
        with kept_launches() as (counters, _):
            for h, a in counters:
                setattr(h, a, 0)
            for m, mod in mods.items():
                module_step(mod, batch)          # the captured one captures
                losses[m].append(softmax_loss(mod, ys))
            for m in ("eager", "captured", "captured wd 0", "captured wd 0",
                      "captured", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(MODULE_WINDOW):
                    module_step(mods[m], batch)
                torch.cuda.synchronize()
                times[m].append((time.perf_counter() - t0) / MODULE_WINDOW)
                losses[m].append(softmax_loss(mods[m], ys))
            launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__),
                                   a): getattr(h, a) for h, a in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        log("Module path launches of the port's kernels over %d steps: %s "
            "(no hand-written kernel is on this path)"
            % (3 * (MODULE_STEPS + 1), json.dumps(launches)))
        for m in mods:
            ls = losses[m]
            if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
                raise Failed("Module ResNet-50 %s: losses %s" % (m, ls))
            per = times[m]
            nums[m] = {"ms_per_step": [p * 1e3 for p in per],
                       "images_per_s": [RESNET_B / p for p in per],
                       "losses": ls}
            log("Module ResNet-50 v1 %s (bs %d, f32, cudnn.allow_tf32=%s): "
                "%s ms/step, %s images/s (host clock over %d-step windows, "
                "synchronised, in turns eager, captured, captured wd 0, "
                "captured wd 0, captured, eager), losses %s; the hybridized "
                "Gluon Trainer step (wd 0) %.3f ms, %.1f images/s in this "
                "call; %s"
                % (m, RESNET_B, torch.backends.cudnn.allow_tf32,
                   " ".join("%.3f" % v for v in nums[m]["ms_per_step"]),
                   " ".join("%.1f" % v for v in nums[m]["images_per_s"]),
                   MODULE_WINDOW, " ".join("%.4f" % v for v in ls),
                   gluon["hybridized_ms_per_step"],
                   gluon["hybridized_images_per_s"], card))
        nums["gluon_hybridized_ms_per_step"] = gluon["hybridized_ms_per_step"]
        nums["peak_gib"] = peak
        nums["launches"] = launches
        log("Module ResNet-50 peak memory %.2f GiB (three modules, the "
            "captured ones' graphs)" % peak)
        for m, mod in mods.items():
            nums["profile_" + m] = profile_window(
                lambda: module_step(mod, batch), RESNET_PROFILE,
                "Module ResNet-50 train steps, %s" % m)
        del mods, mod
        gc.collect()
        torch.cuda.empty_cache()

        nums["fit"] = module_fit(mx, head, args, aux, ctx, tmp, failures)
        nums["serve"] = serve_export(mx, net, sym, prefix, args, aux, x, ctx,
                                     failures)
        del net
        gc.collect()
        torch.cuda.empty_cache()
        nums["nmt"] = nmt_path(mx, failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.allow_tf32 = False
    return nums


def module_fit(mx, head, args, aux, ctx, tmp, failures):
    """``Module.fit`` over an ``NDArrayIter`` of MODULE_FIT synthetic
    batches (one epoch, ``Speedometer`` every 2 batches, ``do_checkpoint``),
    then ``Module.load`` of the checkpoint and ``score``: its accuracy
    must equal the live module's."""
    rng = np.random.RandomState(7)
    n = MODULE_FIT * RESNET_B
    X = rng.randn(n, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    Y = rng.randint(0, RESNET_CLASSES, n).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=RESNET_B)
    ckpt = os.path.join(tmp, "fit")
    speed = mx.callback.Speedometer(RESNET_B, frequent=2)
    mod = mx.mod.Module(head, context=ctx)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, arg_params=args, aux_params=aux,
            optimizer="sgd", optimizer_params={
                "learning_rate": RESNET_LR, "momentum": RESNET_MOM,
                "wd": MODULE_WD},
            batch_end_callback=speed,
            epoch_end_callback=mx.callback.do_checkpoint(ckpt))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    live = mod.score(it, "acc")
    loaded = mx.mod.Module.load(ckpt, 1, context=ctx)
    loaded.bind(it.provide_data, it.provide_label, for_training=False)
    loaded.init_params()
    got = loaded.score(it, "acc")
    ok = got == live and os.path.exists(ckpt + "-0001.params")
    log("check Module.fit (%d batches of %d, one epoch: %.3f s with the "
        "capture, Speedometer %.1f samples/s) -> do_checkpoint -> "
        "Module.load -> score: %s loaded vs %s live  %s"
        % (MODULE_FIT, RESNET_B, fit_s, speed.last_speed or float("nan"),
           got, live, "ok" if ok else "FAIL"))
    if not ok:
        failures.append("Module fit/checkpoint/load/score")
    return {"fit_s": fit_s, "speedometer_samples_per_s": speed.last_speed,
            "score_live": live, "score_loaded": got}


def serve_export(mx, net, sym, prefix, args, aux, x, ctx, failures):
    """``SymbolBlock.imports`` of the export at bs 64 in inference,
    plain and hybridized, against the Gluon net's eval output (TF32
    off, SERVE_F32_TOL); ``amp.convert_model(..., "bfloat16")`` of it
    against f32 (SERVE_BF16_TOL); ms per batch of the hybridized f32 and
    bf16 blocks in turns."""
    torch.backends.cudnn.allow_tf32 = False
    ref = net(x)._data
    scale = 1.0 + float(ref.abs().max())
    sb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                      prefix + "-0000.params", ctx=ctx)
    nums = {}
    outs = {"plain": sb(x)._data}
    sb.hybridize()
    sb(x)                                       # captures
    outs["hybridized"] = sb(x)._data
    for tag, out in outs.items():
        err = float((out - ref).abs().max())
        ok = err <= SERVE_F32_TOL * scale
        nums["f32_" + tag + "_max_abs_err"] = err
        log("check SymbolBlock.imports ResNet-50 (%s, bs %d, f32) vs the "
            "Gluon net: max |diff| %.3e (tol %.0e x (1 + max|ref| = %.3f))  "
            "%s" % (tag, RESNET_B, err, SERVE_F32_TOL, scale,
                    "ok" if ok else "FAIL"))
        if not ok:
            failures.append("SymbolBlock %s vs Gluon" % tag)
    csym, cargs, caux = mx.contrib.amp.convert_model(sym, args, aux,
                                                     "bfloat16")
    casts = sum(1 for n in csym._nodes()
                if not n.is_var and n.op.name == "amp_cast")
    sb16 = mx.gluon.SymbolBlock(csym, "data", params=dict(cargs, **caux),
                                ctx=ctx)
    sb16.hybridize()
    sb16(x)
    out16 = sb16(x)._data.float()
    rel = float((out16 - outs["hybridized"]).norm()
                / outs["hybridized"].norm())
    ok = rel <= SERVE_BF16_TOL
    nums["bf16_rel_l2_err"] = rel
    nums["bf16_casts"] = casts
    log("check amp.convert_model(bfloat16) ResNet-50 (%d amp_cast nodes) "
        "vs f32: ||bf16 - f32|| / ||f32|| %.3e (tol %.0e)  %s"
        % (casts, rel, SERVE_BF16_TOL, "ok" if ok else "FAIL"))
    if not ok:
        failures.append("amp.convert_model bf16 vs f32")
    times = {"f32": [], "bf16": []}
    blocks = {"f32": sb, "bf16": sb16}
    for tag in ("f32", "bf16", "bf16", "f32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_CALLS):
            blocks[tag](x)
        torch.cuda.synchronize()
        times[tag].append((time.perf_counter() - t0) * 1e3 / SERVE_CALLS)
    for tag, ts in times.items():
        nums[tag + "_ms_per_batch"] = ts
    log("SymbolBlock ResNet-50 inference bs %d, hybridized, TF32 off: f32 "
        "%s ms/batch, bf16 (convert_model) %s ms/batch (host clock over %d "
        "calls, synchronised, in turns f32, bf16, bf16, f32); %s"
        % (RESNET_B, " ".join("%.3f" % t for t in times["f32"]),
           " ".join("%.3f" % t for t in times["bf16"]), SERVE_CALLS,
           card_line()))
    return nums


def nmt_sym_gen(mx):
    """examples/nmt_bucketing.py's ``sym_gen`` over the port's ``mx``:
    Embedding -> per-position FullyConnected -> per-position
    SoftmaxOutput (normalization "valid")."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        emb = mx.sym.Embedding(data, input_dim=NMT_VOCAB,
                               output_dim=NMT_EMB, name="emb")
        fc = mx.sym.FullyConnected(emb, num_hidden=NMT_VOCAB, flatten=False,
                                   name="fc")
        out = mx.sym.SoftmaxOutput(fc, preserve_shape=True,
                                   normalization="valid", name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def nmt_batches(mx, ctx, seed=0):
    """examples/nmt_bucketing.py's ``BucketIter``: NMT_BATCHES batches,
    each of a bucket drawn from its seeded RandomState, the label every
    token's successor id."""
    rng = np.random.RandomState(seed)
    for _ in range(NMT_BATCHES):
        L = int(rng.choice(NMT_BUCKETS))
        data = rng.randint(0, NMT_VOCAB, (NMT_B, L))
        label = (data + 1) % NMT_VOCAB
        yield mx.io.DataBatch(
            data=[mx.nd.array(data.astype(np.float32), ctx=ctx)],
            label=[mx.nd.array(label.astype(np.float32), ctx=ctx)],
            bucket_key=L, provide_data=[("data", (NMT_B, L))],
            provide_label=[("softmax_label", (NMT_B, L))])


def nmt_train(mx, ctx, eager):
    """The example's training loop (Xavier from np.random.seed(0)):
    (accuracy, BLEU, tokens/s, parameters, programs per bucket).  On the
    card every bucket's module is made first and ``eager`` set on its
    executor."""
    np.random.seed(0)
    bm = mx.mod.BucketingModule(nmt_sym_gen(mx),
                                default_bucket_key=max(NMT_BUCKETS),
                                context=ctx)
    bm.bind(data_shapes=[("data", (NMT_B, max(NMT_BUCKETS)))],
            label_shapes=[("softmax_label", (NMT_B,))])
    bm.init_params(initializer=mx.init.Xavier())
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": NMT_LR})
    if eager is not None:
        for L in NMT_BUCKETS:
            bm.switch_bucket(L, [("data", (NMT_B, L))],
                             [("softmax_label", (NMT_B, L))])
        for m in bm._buckets.values():
            m._exec._eager = eager
    metric = mx.metric.Accuracy(axis=2)
    bleu = mx.metric.BLEU(smooth=True)
    batches = list(nmt_batches(mx, ctx))
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    marks = [time.perf_counter()]
    for b in batches:       # the metrics read the outputs: a sync a batch
        bm.forward(b, is_train=True)
        bm.backward()
        bm.update()
        metric.update(b.label[0], bm.get_outputs()[0])
        bleu.update(b.label[0], bm.get_outputs()[0])
        marks.append(time.perf_counter())
    # tokens/s over the run, and over the batches after every bucket's
    # first (which captures its graphs)
    keys = [b.bucket_key for b in batches]
    warm = max(keys.index(k) for k in set(keys)) + 1
    tokens = [b.data[0].size for b in batches]
    rates = (sum(tokens) / (marks[-1] - marks[0]),
             sum(tokens[warm:]) / (marks[-1] - marks[warm]))
    params = bm._curr_module.get_params()[0]
    programs = {k: len(m._exec._programs) for k, m in bm._buckets.items()}
    return (metric.get()[1], bleu.get()[1], rates,
            {k: v._data.cpu() for k, v in params.items()}, programs)


def nmt_path(mx, failures):
    """The NMT BucketingModule on the card, captured and op by op
    (parameters bit for bit after the run), and on the CPU (accuracy
    within NMT_ACC_TOL)."""
    runs = {"captured": nmt_train(mx, mx.gpu(0), False),
            "eager": nmt_train(mx, mx.gpu(0), True),
            "cpu": nmt_train(mx, mx.cpu(), None)}
    same = all(torch.equal(runs["captured"][3][k], runs["eager"][3][k])
               for k in runs["eager"][3])
    gap = abs(runs["captured"][0] - runs["cpu"][0])
    ok = same and gap <= NMT_ACC_TOL and \
        set(runs["captured"][4]) == set(NMT_BUCKETS)
    nums = {}
    for name, (acc, bl, tps, _, programs) in runs.items():
        nums[name] = {"accuracy": acc, "bleu": bl, "tokens_per_s": tps[0],
                      "steady_tokens_per_s": tps[1],
                      "programs_per_bucket": programs}
        log("NMT BucketingModule %s (buckets %s, vocab %d, %d batches of "
            "%d): accuracy %.4f, BLEU %.4f, %.1f tokens/s over the run, "
            "%.1f after every bucket's first batch (host clock, metrics "
            "per batch), executor programs per bucket %s"
            % (name, list(NMT_BUCKETS), NMT_VOCAB, NMT_BATCHES, NMT_B, acc,
               bl, tps[0], tps[1], json.dumps(programs)))
    log("check NMT BucketingModule: captured vs eager parameters bit for "
        "bit %s, accuracy card vs CPU gap %.4f (tol %.2f)  %s"
        % (same, gap, NMT_ACC_TOL, "ok" if ok else "FAIL"))
    if not ok:
        failures.append("NMT BucketingModule")
    return nums


def check_small_module(mx, failures):
    """A thumbnail ResNet-18 (10 classes), exported on the CPU, trains 3
    Module steps at 32 x 32, batch 4 (SGD lr 0.01, momentum 0.9, the
    head's gradient the batch mean: ``normalization="batch"``, the step
    of check_small_resnet's ``trainer.step(4)``), on the card (TF32 off)
    and on the CPU from the same ``.params`` file; the mean losses must
    agree within SMALL_RESNET_LOSS_TOL.  (With the head's default sum
    over the batch the step is 4x larger and the loss falls from 2.3 to
    0.01 in two steps; f32 rounding differences then grew to 1.4e-3 by
    step 3 on an H100, past the limit.)"""
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_module18_")
    try:
        _, prefix = export_resnet(mx, tmp, "resnet18_v1", mx.cpu(),
                                  mx.nd.array(x, ctx=mx.cpu()), 5,
                                  classes=10, thumbnail=True)
        head = mx.sym.SoftmaxOutput(mx.sym.load(prefix + "-symbol.json"),
                                    normalization="batch", name="softmax")
        args, aux = mx.model.load_params(prefix + "-0000.params")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = softmax_module(mx, head, args, aux, ctx, x.shape, 0.01, 0.9,
                             0.0, False)
        batch = mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx)],
                                label=[mx.nd.array(y, ctx=ctx)])
        out = []
        for _ in range(3):
            module_step(mod, batch)
            out.append(softmax_loss(mod, y))
        runs.append(out)
    first, later = SMALL_RESNET_LOSS_TOL
    gaps = [abs(a - b) for a, b in zip(*runs)]
    ok = all(gap <= (first if i == 0 else later) * (1 + abs(b))
             for i, (gap, b) in enumerate(zip(gaps, runs[1])))
    log("check small ResNet-18 Module 3 steps, card vs CPU (f32, TF32 off): "
        "%s vs %s, gaps %s (tol %.0e then %.0e, times 1+|loss|)  %s"
        % (" ".join("%.6f" % v for v in runs[0]),
           " ".join("%.6f" % v for v in runs[1]),
           " ".join("%.2e" % g for g in gaps), first, later,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("small ResNet-18 Module card vs CPU")


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


def bench_path(mx, failures, gluon, keep=None):
    """bench.py's workload through ``DataParallelTrainer.run_steps`` on
    the card (a CUDA graph of whole steps replayed BENCH_STEPS times a
    dispatch): the captured-vs-eager check, then the main path with
    every launch counter from 0 (one warm dispatch and two timed ones,
    in turns with the 7x7 stem: 7x7, s2d, s2d, 7x7), a profiled window,
    and BENCH_AMP=0 (f32, bs 64) beside the Gluon Trainer's hybridized
    figure ``gluon``.  Returns the numbers; ``keep["s2d"]`` gets the
    s2d trainer (for the ``image`` phase)."""
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
    if keep is not None:
        keep["s2d"] = trainers["s2d"]
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


# -------------------------------------------------------- serving options --
def leak_check(name, eng, failures):
    """No page in use but the prefix cache's, no ref held; with the
    cache cleared, no page in use at all."""
    cached = 0 if eng.prefix is None else eng.prefix.cached_pages
    refs = 0 if eng.prefix is None else eng.prefix.refs_total
    held = eng.cache.pages_in_use - cached
    if eng.prefix is not None:
        eng.prefix.clear()
    ok = held == 0 and refs == 0 and eng.cache.pages_in_use == 0
    log("check leak %s: %d pages in use besides %d cached, %d refs, %d "
        "pages in use after clearing the cache  %s"
        % (name, held, cached, refs, eng.cache.pages_in_use,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("leak " + name)


def small_options(G, ServingEngine, dev, failures):
    """Gate: a small f32 model (2 layers, d_model 128, 2 heads: head dim
    64, which the flash kernel of ``generate``'s prefill takes) on the
    card through the captured engine,
    each option alone, then all three together on a preempting pool with
    the ngram and an adversarial callable drafter, each token-identical
    to the port's ``generate`` on the card; greedy
    ``generate_speculative`` (ngram and self drafters) equal to it."""
    tiny = G.gpt_tiny(dtype="float32", vocab_size=128, max_len=64,
                      d_model=128, n_heads=2, d_ff=256, dropout=0.0)
    tp = G.init_params(3, tiny, device=dev)
    rng = np.random.RandomState(0)
    shared = rng.randint(1, 90, 12)
    cases = [(np.concatenate([shared, rng.randint(1, 90, 2 + i)]), 6 + i)
             for i in range(5)]
    cases += [(rng.randint(1, 90, P), N)
              for P, N in [(5, 8), (3, 12), (9, 4), (2, 6), (7, 10)]]
    cases.append((shared, 8))         # whole-input match: a copy on write
    want = {i: G.generate(tp, tiny, p[None], n, device=dev)[0].cpu().numpy()
            for i, (p, n) in enumerate(cases)}
    pool = dict(num_pages=14, pages_per_slot=8)
    variants = [
        ("prefix_cache", dict(prefix_cache=True)),
        ("spec_K=3 ngram", dict(spec_K=3)),
        ("overlap", dict(overlap=True)),
        ("all three, preempting pool, ngram",
         dict(prefix_cache=True, spec_K=2, overlap=True, **pool)),
        ("all three, preempting pool, adversarial drafter",
         dict(prefix_cache=True, spec_K=2, overlap=True,
              spec_drafter=lambda t, K: np.full(K, 7, np.int32), **pool))]
    for name, kw in variants:
        eng = ServingEngine(tp, tiny, num_slots=3, page_size=4,
                            prefill_chunk=6, device=dev, **kw)
        rids = [eng.submit(p, n) for p, n in cases]
        outs = eng.run()
        eng.close()
        st = eng.stats
        log("info: small f32 engine %s: %d steps, %d preemptions, %d "
            "prefix hit tokens, %d copies on write, %d/%d drafts accepted, "
            "%d overlapped steps, %d fences"
            % (name, st["steps"], st["preemptions"],
               st["prefix_hit_tokens"], st["cow_copies"],
               st["spec_accepted"], st["spec_drafted"],
               st["overlap_steps"], st["overlap_fences"]))
        same_tokens("small f32 engine (card, captured) %s vs generate "
                    "(card)" % name, {i: outs[r] for i, r in enumerate(rids)},
                    want, failures)
        leak_check("small f32 " + name, eng, failures)
    prompts = np.tile(rng.randint(1, 90, (2, 4)), 3)
    ref = G.generate(tp, tiny, prompts, 24, device=dev).cpu().numpy()
    dp, dc = G.draft_slice_params(tp, tiny, 1)
    for drafter, kw in (("ngram", {}),
                        ("self", dict(draft_params=dp, draft_cfg=dc))):
        out, st = G.generate_speculative(tp, tiny, prompts, 24, K=3,
                                         drafter=drafter, return_stats=True,
                                         device=dev, **kw)
        log("info: small f32 generate_speculative %s: %s"
            % (drafter, json.dumps(st)))
        same_tokens("small f32 generate_speculative %s vs generate (card)"
                    % drafter, dict(enumerate(out.cpu().numpy())),
                    dict(enumerate(ref)), failures)


def serve_mix(ServingEngine, params, cfg, reqs, dev, failures, name,
              **kw):
    """The mix through one captured engine with options ``kw``, after a
    warm request outside the clock (the capture); asserts every request
    finished and no page leaked.  Returns (outputs, numbers of the timed
    run: tokens/s, ms/step and the stats' changes)."""
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, device=dev, **kw)
    eng.submit(np.arange(1, PAGE + 1, dtype=np.int32), 4)
    eng.run()
    base = dict(eng.stats)
    rids = [eng.submit(p, n) for p, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.step() is not False:
        pass
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eng.close()
    st = {k: eng.stats[k] - base[k] for k in base}
    bad = [r for r in rids if eng.requests[r].state != "done"
           or len(eng.requests[r].generated) != eng.requests[r]
           .max_new_tokens]
    if bad:
        raise Failed("%s: requests not finished: %s" % (name, bad[:8]))
    toks = sum(len(eng.requests[r].generated) for r in rids)
    run = {"tokens_per_s": toks / dt, "ms_per_step": dt * 1e3 / st["steps"],
           "seconds": dt, "tokens": toks, "warm_steps": base["steps"], **st}
    leak_check(name, eng, failures)
    return [eng.requests[r].output for r in rids], run


def step_breakdown(ServingEngine, params, cfg, reqs, dev, **kw):
    """Information: where a step's time goes, on one more run of the mix
    with options ``kw`` (timers on, so its wall time is not the timed
    one): host milliseconds a step in the plan build, the dispatch, the
    wait for the tokens, the commit and (overlap) the wait for the
    planner; the device's time a step (CUDA events around each dispatch:
    its copies and the replayed graph, gaps between kernels included);
    and the pages the live rows walk a step."""
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, device=dev, **kw)
    eng.submit(np.arange(1, PAGE + 1, dtype=np.int32), 4)
    eng.run()
    host, events, walk = {}, [], []

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name] = host.get(name, 0.0) + time.perf_counter() - t0
        return run

    build, dispatch, put = eng._build_plan, eng._dispatch, eng._readback.put

    def build_walk(overlap=False):
        plan = build(overlap)
        if plan.buf is not None:
            pos = plan.buf.row_pos[plan.buf.row_live != 0]
            walk.append(int((pos // PAGE + 1).sum()))
        return plan

    def dispatch_timed(plan):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = dispatch(plan)
        e1.record()
        events.append((e0, e1))
        return out

    eng._build_plan = timed("build", build_walk)
    eng._dispatch = timed("dispatch", dispatch_timed)
    eng._commit = timed("commit", eng._commit)
    eng._take_plan = timed("take_plan", eng._take_plan)
    eng._readback.put = lambda tok: timed("token_wait", put(tok))
    for p, n in reqs:
        eng.submit(p, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.step() is not False:
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.close()
    n = len(events)
    dev_ms = [a.elapsed_time(b) for a, b in events]
    out = {"steps": n, "wall_ms_per_step": wall * 1e3 / n,
           "device_ms_per_step": float(np.mean(dev_ms)),
           "device_ms_median": float(np.median(dev_ms)),
           "pages_walked_per_step": float(np.mean(walk)),
           **{"host_%s_ms" % k: v * 1e3 / n for k, v in sorted(host.items())}}
    log("info: step breakdown %s: %s" % (
        ", ".join("%s=%s" % x for x in kw.items()),
        json.dumps({k: round(v, 4) for k, v in out.items()})))
    return out


def prefix_ttft(ServingEngine, params, cfg, dev):
    """serve_bench.py ``run_gate_prefix`` on the card: TTFT of a request
    whose whole prompt (P = 192) sits in the prefix cache against a cold
    prompt of that length, N = 4 new tokens, best of 3 each, on one
    captured engine."""
    rng = np.random.RandomState(0)
    P = max(PROMPT_LENS)
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, prefix_cache=True, device=dev)
    wid = eng.submit(rng.randint(1, VOCAB, P).astype(np.int32), TTFT_NEW)
    eng.run()
    del eng.requests[wid]
    shared = rng.randint(1, VOCAB, P).astype(np.int32)
    cold = min(ttft_ms(eng, rng.randint(1, VOCAB, P).astype(np.int32),
                       TTFT_NEW) for _ in range(TTFT_REPS))
    ttft_ms(eng, shared, TTFT_NEW)        # populate the cache
    hit = min(ttft_ms(eng, shared, TTFT_NEW) for _ in range(TTFT_REPS))
    return {"ttft_cold_ms": cold, "ttft_hit_ms": hit,
            "speedup": cold / hit,
            "hit_tokens": eng.stats["prefix_hit_tokens"], "prompt_len": P}


def check_paged_spec(PA, ServingEngine, params, cfg, reqs, dev, failures):
    """The paged kernel against its plain version on the inputs of a live
    spec_K=4 engine step: 96 rows, each decode slot's pending and four
    draft rows at consecutive positions over one block table (kept at
    step 60 of an op-by-op run, before any counter is read)."""
    from mxnet_tpu_torch.serving import engine as E
    kept, at = {}, {"step": -1}
    orig = E.paged_attention

    def spy(q, pool_kv, pool_s, bt, pos, *, page_size):
        if at["step"] == 60 and not kept:
            kept["in"] = tuple(None if x is None else x.clone()
                               for x in (q, pool_kv, pool_s, bt, pos))
        return orig(q, pool_kv, pool_s, bt, pos, page_size=page_size)

    E.paged_attention = spy
    try:
        eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                            prefill_chunk=CHUNK, spec_K=4, device=dev)
        eng._eager = True
        for p, n in reqs[:SLOTS]:
            eng.submit(p, n)
        for i in range(61):
            at["step"] = i
            eng.step()
    finally:
        E.paged_attention = orig
    q, pool, s, bt, pos = kept["in"]
    got = PA.paged_attention(q, pool, s, bt, pos, page_size=PAGE)
    torch.cuda.synchronize()
    live = int((bt[:, 0] != 0).sum())
    return check_paged(PA, "paged bfloat16 spec_K=4 engine step (%d rows, "
                       "%d live)" % (q.shape[0], live), got, q, pool, s, bt,
                       pos, failures)


def serving_options(G, PA, ServingEngine, params, cfg, dev, card, failures):
    """Gates and numbers of the three serving options on the card: the
    small f32 gates; on the ``full`` preset overlap off and on in turns
    (tokens identical), the shared-prefix mix with the cache off and on
    (tokens identical) and its hit/cold TTFT, speculation at spec_K = 0,
    2, 4 (tokens against spec_K = 0 reported), and all three together on
    the shared-prefix mix with the paged kernel's launch counter from 0
    held to the steps.  Returns the report and the paged launches."""
    small_options(G, ServingEngine, dev, failures)
    reqs = workload(0)
    mix = workload(0, SHARED_FRAC)
    shared = shared_prefix(0)
    log("shared-prefix mix: %d requests, %d opening with the %d-token "
        "prefix, prompt tokens %d, new tokens %d"
        % (len(mix), sum(np.array_equal(p[:8], shared[:8]) for p, _ in mix),
           PREFIX_LEN, sum(p.size for p, _ in mix),
           sum(n for _, n in mix)))
    rep = {"card": card}

    def show(name, run):
        log("serve %s [%s]: %.1f tok/s, %.3f ms/step, %d steps, %d tokens, "
            "host_hidden_ms %.3f, overlap_steps %d, prefix_hit_tokens %d, "
            "cow_copies %d, spec %d/%d accepted"
            % (name, card, run["tokens_per_s"], run["ms_per_step"],
               run["steps"], run["tokens"], run["host_hidden_ms"],
               run["overlap_steps"], run["prefix_hit_tokens"],
               run["cow_copies"], run["spec_accepted"], run["spec_drafted"]))

    # overlap off and on, in turns
    outs, runs = {}, {False: [], True: []}
    for overlap in (False, True, True, False):
        name = "full mix overlap=%s" % overlap
        o, run = serve_mix(ServingEngine, params, cfg, reqs, dev, failures,
                           name, overlap=overlap)
        show(name, run)
        outs.setdefault(overlap, o)
        runs[overlap].append(run)
    same_tokens("full mix bf16/w8, overlap on vs off",
                dict(enumerate(outs[True])), dict(enumerate(outs[False])),
                failures)
    paged = [("paged_split", lambda: PA.paged_attention.launches,
              ["paged_split"]),
             ("paged_combine", lambda: PA.paged_attention.launches,
              ["paged_combine"])]
    rep["overlap"] = {}
    for overlap in (False, True):
        prof = profile_steps(ServingEngine, params, cfg, reqs, dev, False,
                             paged, overlap=overlap)
        rep["overlap"][str(overlap)] = {
            "tokens_per_s": [r["tokens_per_s"] for r in runs[overlap]],
            "ms_per_step": [r["ms_per_step"] for r in runs[overlap]],
            "host_hidden_ms": [r["host_hidden_ms"] for r in runs[overlap]],
            "overlap_steps": [r["overlap_steps"] for r in runs[overlap]],
            "profile": prof}
        rep["overlap"][str(overlap)]["breakdown"] = step_breakdown(
            ServingEngine, params, cfg, reqs, dev, overlap=overlap)
    log("info: overlap off vs on [%s]: %s" % (card,
                                              json.dumps(rep["overlap"])))

    # the shared-prefix mix, cache off and on, in turns; TTFT
    mouts, pruns = {}, {False: [], True: []}
    for on in (False, True, True, False):
        name = "shared-prefix mix prefix_cache=%s" % on
        o, run = serve_mix(ServingEngine, params, cfg, mix, dev, failures,
                           name, prefix_cache=on)
        show(name, run)
        mouts.setdefault(on, o)
        pruns[on].append(run)
    same_tokens("shared-prefix mix bf16/w8, prefix cache on vs off",
                dict(enumerate(mouts[True])), dict(enumerate(mouts[False])),
                failures)
    rep["prefix"] = {str(on): {
        "tokens_per_s": [r["tokens_per_s"] for r in pruns[on]],
        "ms_per_step": [r["ms_per_step"] for r in pruns[on]],
        **{k: pruns[on][0][k] for k in ("steps", "prefill_rows",
                                        "prefix_hit_tokens", "cow_copies",
                                        "peak_pages")},
        "breakdown": step_breakdown(ServingEngine, params, cfg, mix, dev,
                                    prefix_cache=on)} for on in pruns}
    rep["ttft"] = prefix_ttft(ServingEngine, params, cfg, dev)
    log("serve prefix TTFT (run_gate_prefix, P=%d, N=%d, best of %d) [%s]: "
        "hit %.3f ms, cold %.3f ms, %.2fx"
        % (rep["ttft"]["prompt_len"], TTFT_NEW, TTFT_REPS, card,
           rep["ttft"]["ttft_hit_ms"], rep["ttft"]["ttft_cold_ms"],
           rep["ttft"]["speedup"]))

    # speculation depths on the full mix; the paged kernel at 96 rows
    rep["paged_spec4_max_abs_err"] = check_paged_spec(
        PA, ServingEngine, params, cfg, reqs, dev, failures)
    rep["spec"] = {}
    souts = {}
    for K in SPEC_KS:
        name = "full mix spec_K=%d ngram" % K
        o, run = serve_mix(ServingEngine, params, cfg, reqs, dev, failures,
                           name, spec_K=K)
        show(name, run)
        souts[K] = o
        run["accept_rate"] = run["spec_accepted"] / max(1, run["spec_drafted"])
        run["tokens_per_slot_step"] = (run["decode_rows"]
                                       + run["spec_accepted"]) \
            / max(1, run["decode_rows"])
        run["same_requests_as_spec0"] = sum(
            np.array_equal(a, b) for a, b in zip(o, souts[0]))
        run["token_agreement_with_spec0"] = float(np.mean(
            [np.mean(a == b) for a, b in zip(o, souts[0])]))
        log("info: spec_K=%d [%s]: accept rate %.4f, %.4f tokens committed "
            "per decode slot-step, %d of %d requests and %.4f of tokens as "
            "spec_K=0 (reported, not gated: bf16)"
            % (K, card, run["accept_rate"], run["tokens_per_slot_step"],
               run["same_requests_as_spec0"], len(o),
               run["token_agreement_with_spec0"]))
        rep["spec"][str(K)] = run

    # all three together on the shared-prefix mix, the paged counter from 0
    PA.paged_attention.launches = 0
    name = "shared-prefix mix, all three options"
    o, run = serve_mix(ServingEngine, params, cfg, mix, dev, failures, name,
                       prefix_cache=True, spec_K=2, overlap=True)
    launches = PA.paged_attention.launches
    show(name, run)
    rep["all_three"] = run
    # the counter counts the warm request's steps too
    steps_all = run["steps"] + run["warm_steps"]
    ok = launches == steps_all * LAYERS
    log("check all three options: paged_attention counted %d launches, %d "
        "steps x %d layers = %d  %s" % (launches, steps_all, LAYERS,
                                        steps_all * LAYERS,
                                        "ok" if ok else "FAIL"))
    if not ok:
        failures.append("all three options: paged launches")
    agree = float(np.mean([np.mean(a == b) for a, b in zip(o, mouts[False])]))
    log("info: all three options vs the plain engine on the shared-prefix "
        "mix: %.4f of tokens agree (bf16, spec_K=2 verify rows: reported)"
        % agree)
    return rep, launches


def tier_leak_check(name, eng, failures):
    """No swap entry left in the tier, its pages exactly the spilled
    chains'; then ``leak_check`` (which clears the prefix cache) and an
    empty tier after it."""
    swaps = [k for k in eng.tier._entries if k[0] == "swap"]
    spilled = 0 if eng.prefix is None else eng.prefix.spilled_pages
    held = eng.tier.pages_held
    leak_check(name, eng, failures)
    ok = not swaps and held == spilled and eng.tier.pages_held == 0 \
        and len(eng.tier) == 0
    log("check tier leak %s: %d swap entries, %d tier pages for %d "
        "spilled, %d tier pages after clearing  %s"
        % (name, len(swaps), held, spilled, eng.tier.pages_held,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("tier leak " + name)


def small_tier(G, ServingEngine, dev, failures):
    """Gate: the small f32 model of ``small_options`` through a captured
    engine with the prefix cache, a host tier and a 12-page pool that
    preempts (victims swap out and back in) and spills (refcount-0
    chains go to the tier and come back as warm hits), overlap off and
    on, float and int8 KV: float KV token-identical to ``generate`` on
    the card, int8 KV to the same engine with the tier off; the tier's
    counters > 0 and nothing left over."""
    tiny = G.gpt_tiny(dtype="float32", vocab_size=128, max_len=64,
                      d_model=128, n_heads=2, d_ff=256, dropout=0.0)
    tp = G.init_params(3, tiny, device=dev)
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 90, 12).astype(np.int32)
    first = [(np.concatenate([shared, rng.randint(1, 90, 3 + i)
                              .astype(np.int32)]), 5 + 2 * i)
             for i in range(4)]
    first += [(rng.randint(1, 90, P).astype(np.int32), N)
              for P, N in [(11, 9), (6, 12), (14, 6)]]
    waves = [first, [(shared, 6), (first[0][0], 4)]]
    cases = first + waves[1]
    want = {i: G.generate(tp, tiny, torch.as_tensor(p)[None], n,
                          device=dev)[0].cpu().numpy()
            for i, (p, n) in enumerate(cases)}
    kw = dict(num_slots=3, page_size=4, prefill_chunk=6, pages_per_slot=8,
              num_pages=13, prefix_cache=True, metrics=True)

    def run(**more):
        eng = ServingEngine(tp, tiny, device=dev, **kw, **more)
        rids = []
        for wave in waves:
            rids += [eng.submit(p, n) for p, n in wave]
            eng.run()
        eng.close()
        return eng, {i: eng.requests[r].output for i, r in enumerate(rids)}

    counters = {}
    for kv_int8 in (False, True):
        for overlap in (False, True):
            name = "small f32 tiered engine kv_int8=%s overlap=%s" % (
                kv_int8, overlap)
            eng, outs = run(kv_int8=kv_int8, overlap=overlap,
                            tier_bytes=TIER_BYTES)
            c = eng.metrics()["counters"]
            counters[name] = {k: c[k] for k in (
                "serving_tier_spills_total", "serving_tier_installs_total",
                "serving_tier_bytes_total", "serving_swap_outs_total",
                "serving_swap_ins_total", "serving_preemptions_total",
                "serving_prefix_warm_hit_tokens_total")}
            log("info: %s: %s" % (name, json.dumps(counters[name])))
            moved = all(c[k] > 0 for k in (
                "serving_tier_spills_total", "serving_tier_installs_total",
                "serving_swap_ins_total"))
            log("check %s: tier spills, installs and swap-ins all > 0  %s"
                % (name, "ok" if moved else "FAIL"))
            if not moved:
                failures.append(name + ": tier not exercised")
            if kv_int8:
                off, outs_off = run(kv_int8=True, overlap=overlap,
                                    tier_bytes=0)
                same_tokens(name + " vs tier off", outs, outs_off, failures)
                leak_check(name + " (tier off)", off, failures)
            else:
                same_tokens(name + " vs generate (card)", outs, want,
                            failures)
            tier_leak_check(name, eng, failures)
    return counters


def ttft_ms(eng, prompt, n):
    """Submit to first committed token on a serial engine (synchronised
    host clock), then drain.  Returns the milliseconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = eng.submit(prompt, n)
    req = eng.requests[rid]
    while not req.generated:
        eng.step()
    dt = (time.perf_counter() - t0) * 1e3
    eng.run()
    return dt


def tier_gate(ServingEngine, params, cfg, dev, failures):
    """serve_bench.py ``run_gate_tier`` on the card (the ``full`` preset,
    captured, one warm request outside the clock): TTFT of a P = 192
    prompt (12 whole pages, N = 4) cold, hot (its chain in the prefix
    cache) and warm (the chain spilled to the host tier by
    ``prefix.spill()`` and restored by the match), best of 3 each,
    ``hot < warm < cold`` required; then the wall time from
    ``preempt()`` to the next committed token with the tier on (swap
    out, install at resume) and off (recompute), best of 3 on the same
    3 prompts, ``swap < recompute`` required and the two resumes'
    tokens identical.  Returns the report and the gate's engine."""
    rng = np.random.RandomState(0)
    P = (max(PROMPT_LENS) // PAGE) * PAGE
    chain = P // PAGE
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, prefix_cache=True, metrics=True,
                        tier_bytes=TIER_BYTES, device=dev)
    wid = eng.submit(np.ones(1, np.int32), 1)
    eng.run()
    del eng.requests[wid]
    eng.reset_metrics()

    def draw():
        return rng.randint(1, VOCAB, P).astype(np.int32)

    shared = draw()
    cold = min(ttft_ms(eng, draw(), TTFT_NEW) for _ in range(TTFT_REPS))
    ttft_ms(eng, shared, TTFT_NEW)                # populate the chain
    hot = min(ttft_ms(eng, shared, TTFT_NEW) for _ in range(TTFT_REPS))
    warms, probes = [], []
    for _ in range(TTFT_REPS):
        eng.prefix.spill()
        # the reference's spill() returns once its exports landed; the
        # port's queues them for the next dispatch: run them before the
        # clock, as a spill under pressure runs before its step
        eng.cache.run_transfers()
        probes.append(eng.prefix.probe_depth(shared))
        warms.append(ttft_ms(eng, shared, TTFT_NEW))
    warm = min(warms)
    deep = all(h == 0 and w >= chain - 1 for h, w in probes)
    log("check tier gate: spill() left the shared chain (hot, warm) "
        "pages %s of %d  %s" % (probes, chain, "ok" if deep else "FAIL"))
    if not deep:
        failures.append("tier gate: the warm runs missed the host tier")
    ordered = hot < warm < cold
    log("serve tier TTFT (run_gate_tier, P=%d, N=%d, best of %d): hot %.3f "
        "ms, warm %.3f ms, cold %.3f ms  %s"
        % (P, TTFT_NEW, TTFT_REPS, hot, warm, cold,
           "ok" if ordered else "FAIL"))
    if not ordered:
        failures.append("tier gate: hot < warm < cold")
    c = eng.metrics()["counters"]
    rep = {"prompt_len": P, "ttft_cold_ms": cold, "ttft_hot_ms": hot,
           "ttft_warm_ms": warm, "ttft_warm_all_ms": warms,
           "counters": {k: c[k] for k in (
               "serving_tier_spills_total", "serving_tier_installs_total",
               "serving_tier_bytes_total",
               "serving_prefix_warm_hit_tokens_total",
               "serving_prefix_hit_tokens_total")}}
    log("info: tier gate counters: %s" % json.dumps(rep["counters"]))

    prompts = [draw() for _ in range(TTFT_REPS)]
    resume, outs = {}, {}
    for tier_on in (True, False):
        e2 = ServingEngine(params, cfg, num_slots=2, page_size=PAGE,
                           prefill_chunk=CHUNK, prefix_cache=False,
                           tier_bytes=TIER_BYTES if tier_on else 0,
                           device=dev)
        w2 = e2.submit(np.ones(1, np.int32), 1)
        e2.run()
        del e2.requests[w2]
        times = []
        for i, pr in enumerate(prompts):
            rid = e2.submit(pr, RESUME_NEW)
            req = e2.requests[rid]
            while len(req.generated) < RESUME_NEW // 2:
                e2.step()
            k = len(req.generated)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            swapped = e2.preempt(rid)
            while len(req.generated) <= k:
                e2.step()
            times.append((time.perf_counter() - t0) * 1e3)
            e2.run()
            outs[(tier_on, i)] = req.output
            if swapped != tier_on:
                failures.append("tier gate: preempt() swapped=%s with the "
                                "tier %s" % (swapped, tier_on))
        if tier_on and e2.stats["swap_ins"] != len(prompts):
            failures.append("tier gate: %d swap-ins for %d preemptions"
                            % (e2.stats["swap_ins"], len(prompts)))
        leak_check("tier gate resume tier=%s" % tier_on, e2, failures)
        resume["swap" if tier_on else "recompute"] = times
    swap, recompute = min(resume["swap"]), min(resume["recompute"])
    ok = swap < recompute
    log("serve tier resume (preempt -> next token, best of %d): swap %.3f "
        "ms, recompute %.3f ms  %s" % (len(prompts), swap, recompute,
                                       "ok" if ok else "FAIL"))
    if not ok:
        failures.append("tier gate: swap-resume < recompute-resume")
    same_tokens("tier gate swap-resume vs recompute-resume",
                {i: outs[(True, i)] for i in range(len(prompts))},
                {i: outs[(False, i)] for i in range(len(prompts))},
                failures)
    rep.update({"resume_swap_ms": swap, "resume_recompute_ms": recompute,
                "resume_all_ms": resume})
    return rep, eng


def pcie_link():
    """(generation, width, max generation) of the card's host link, from
    ``nvidia-smi``; None where it does not say."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current,pcie.link.gen.max",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    try:
        return tuple(int(x) for x in out.stdout.splitlines()[0].split(","))
    except (ValueError, IndexError):
        log("info: nvidia-smi gave no PCIe link: %r" % out.stdout)
        return None


def link_bound(gen, width):
    """One direction's bytes/s over a PCIe link of ``gen`` x ``width``
    (line code 8b/10b to gen 2, 128b/130b from gen 3)."""
    enc = 0.8 if gen <= 2 else 128.0 / 130.0
    return PCIE_GTS[gen] * 1e9 * width * enc / 8.0


def copy_rates(nbytes, reps):
    """Median GB/s of one plain copy of ``nbytes`` between pinned host
    memory and the card, each way, by CUDA events: what the host link
    gives a single copy of that size."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for name, dst, src in (("d2h", host, card), ("h2d", card, host)):
        ms = []
        for _ in range(reps + 1):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            dst.copy_(src, non_blocking=True)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        out[name + "_GBps"] = nbytes / float(np.median(ms[1:])) / 1e6
    return out


def transfer_rates(cfg, dev, card):
    """Export (gather + copy into pinned host memory) and install (copy
    to the card + scatter) of the ``full`` preset's 12-page chain, float
    (bf16) and int8 KV, each TRANSFER_REPS times between CUDA events on
    the stream the engine uses; GB/s beside the host link: its bound
    from ``nvidia-smi`` (read right after the transfers; "[N/A]" in some
    sandboxes) and the rate of one plain pinned copy of the chain's
    bytes and of 256 MB, each way."""
    from mxnet_tpu_torch.serving.paged_kv import PagedKVCache
    chain = (max(PROMPT_LENS) // PAGE)
    out = {}
    for kv_int8 in (False, True):
        cache = PagedKVCache(cfg, 4 * chain + 1, PAGE, kv_int8=kv_int8,
                             device=dev)
        cache.deferred = True
        ids = cache.alloc(chain)
        ms = {"export": [], "install": []}
        for _ in range(TRANSFER_REPS + 1):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            content = cache.export_pages(ids)
            cache.run_transfers()
            e[1].record()
            cache.install_pages(ids, content)
            cache.run_transfers()
            e[2].record()
            torch.cuda.synchronize()
            ms["export"].append(e[0].elapsed_time(e[1]))
            ms["install"].append(e[1].elapsed_time(e[2]))
        nbytes = chain * cache.bytes_per_page
        row = {"pages": chain, "bytes_per_page": cache.bytes_per_page,
               "bytes": nbytes}
        for k, v in ms.items():
            v = v[1:]                               # the first warms up
            row[k + "_ms_median"] = float(np.median(v))
            row[k + "_ms_min"] = float(np.min(v))
            row[k + "_GBps_median"] = nbytes / float(np.median(v)) / 1e6
        out["int8" if kv_int8 else "bf16"] = row
    out["plain_copy_chain"] = copy_rates(out["bf16"]["bytes"],
                                         TRANSFER_REPS)
    out["plain_copy_256MB"] = copy_rates(256 << 20, 3)
    link = pcie_link()
    if link is not None:
        gen, width, gen_max = link
        out["link"] = {"gen": gen, "width": width, "gen_max": gen_max,
                       "bound_GBps": link_bound(gen, width) / 1e9,
                       "bound_GBps_at_gen_max": link_bound(gen_max,
                                                           width) / 1e9}
    log("info: tier transfers of the %d-page chain [%s]: %s"
        % (chain, card, json.dumps(out)))
    return out


def telemetry_mix(ServingEngine, params, cfg, reqs, dev, failures, mode):
    """The mix through one captured overlapped engine with metrics
    ``mode`` ("off", "on", or "profiler": on, with the profiler
    recording), after a warm request outside the clock (and
    ``reset_metrics()``).  With metrics, holds ``serving_steps_total``
    to the steps, ``serving_tokens_total`` to the tokens committed and
    the TTFT histogram's count to the requests; with the profiler, its
    dump must load as JSON with a ``req N`` lane per request, each
    holding admission_wait, prefill, decode and retire events."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.obs import REQ_TID_BASE
    eng = ServingEngine(params, cfg, num_slots=SLOTS, page_size=PAGE,
                        prefill_chunk=CHUNK, device=dev, overlap=True,
                        metrics=mode != "off")
    eng.submit(np.arange(1, PAGE + 1, dtype=np.int32), 4)
    eng.run()
    eng.reset_metrics()
    base = eng.stats["steps"]
    rids = [eng.submit(p, n) for p, n in reqs]
    if mode == "profiler":
        trace_dir = tempfile.mkdtemp()
        profiler.set_config(filename=os.path.join(trace_dir, "serve.json"))
        profiler.set_state("run")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.step() is not False:
        pass
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eng.close()
    steps = eng.stats["steps"] - base
    toks = sum(len(eng.requests[r].generated) for r in rids)
    run = {"tokens_per_s": toks / dt, "ms_per_step": dt * 1e3 / steps,
           "steps": steps, "tokens": toks}
    if mode != "off":
        m = eng.metrics()
        got = (m["counters"]["serving_steps_total"],
               m["counters"]["serving_tokens_total"],
               m["histograms"]["serving_ttft_ms"]["count"])
        ok = got == (steps, toks, len(rids))
        log("check telemetry %s: steps_total %d, tokens_total %d, ttft "
            "count %d against %d steps, %d tokens, %d requests  %s"
            % (mode, *got, steps, toks, len(rids), "ok" if ok else "FAIL"))
        if not ok:
            failures.append("telemetry %s: counters" % mode)
        run["ttft_ms"] = m["histograms"]["serving_ttft_ms"]
        run["tbt_ms"] = m["histograms"]["serving_tbt_ms"]
        run["step_ms"] = m["histograms"]["serving_step_ms"]
    if mode == "profiler":
        profiler.set_state("stop")
        with open(profiler.dump()) as f:
            events = json.load(f)["traceEvents"]
        shutil.rmtree(trace_dir)
        lanes = {}
        for e in events:
            if e.get("tid", 0) >= REQ_TID_BASE:
                lanes.setdefault(e["tid"] - REQ_TID_BASE, []).append(e)
        need = {"admission_wait", "decode", "retire"}
        bad = [r for r in rids if r not in lanes
               or sum(e["name"] == "thread_name"
                      and e["args"]["name"] == "req %d" % r
                      for e in lanes[r]) != 1
               or not need <= {e["name"] for e in lanes[r]}
               or not any(e["name"].startswith("prefill[")
                          for e in lanes[r])]
        log("check telemetry trace: %d events, %d request lanes, %d of %d "
            "requests with a named lane and admission_wait, prefill, "
            "decode and retire  %s"
            % (len(events), len(lanes), len(rids) - len(bad), len(rids),
               "FAIL" if bad else "ok"))
        if bad:
            failures.append("telemetry trace lanes")
        run["trace_events"] = len(events)
    leak_check("telemetry " + mode, eng, failures)
    return [eng.requests[r].output for r in rids], run


def telemetry_and_tier(G, ServingEngine, params, cfg, dev, card, failures):
    """The telemetry and tier phase: the small f32 tier gates, the
    ``run_gate_tier`` twin, the tier on and off over the 64-request mix
    through a TIER_POOL-page pool (tokens identical), the transfer
    rates, and telemetry's cost over the mix (metrics off, on, on with
    the profiler, in turns: tokens identical)."""
    rep = {"card": card}
    rep["small_gates"] = small_tier(G, ServingEngine, dev, failures)
    rep["gate"], gate_eng = tier_gate(ServingEngine, params, cfg, dev,
                                      failures)
    reqs = workload(0)
    outs, rep["mix"] = {}, {}
    for on in (True, False):
        name = "full mix, %d-page pool, tier %s" % (TIER_POOL,
                                                    "on" if on else "off")
        o, run = serve_mix(ServingEngine, params, cfg, reqs, dev, failures,
                           name, num_pages=TIER_POOL, prefix_cache=True,
                           tier_bytes=TIER_BYTES if on else 0)
        log("serve %s [%s]: %.1f tok/s, %.3f ms/step, %d steps, %d "
            "preemptions, %d swap-outs, %d swap-ins"
            % (name, card, run["tokens_per_s"], run["ms_per_step"],
               run["steps"], run["preemptions"], run["swap_outs"],
               run["swap_ins"]))
        outs[on] = o
        rep["mix"]["tier_on" if on else "tier_off"] = run
    same_tokens("full mix bf16/w8, tier on vs off",
                dict(enumerate(outs[True])), dict(enumerate(outs[False])),
                failures)
    if rep["mix"]["tier_on"]["swap_ins"] == 0:
        failures.append("full mix: the tier served no swap-in")
    del gate_eng
    rep["transfers"] = transfer_rates(cfg, dev, card)
    touts, truns = {}, {"off": [], "on": [], "profiler": []}
    for mode in ("off", "on", "profiler", "profiler", "on", "off"):
        o, run = telemetry_mix(ServingEngine, params, cfg, reqs, dev,
                               failures, mode)
        log("serve full mix overlap, metrics %s [%s]: %.1f tok/s, %.3f "
            "ms/step, %d steps, %d tokens" % (mode, card, run["tokens_per_s"],
                                              run["ms_per_step"], run["steps"],
                                              run["tokens"]))
        touts.setdefault(mode, o)
        truns[mode].append(run)
    for mode in ("on", "profiler"):
        same_tokens("full mix bf16/w8 overlap, metrics %s vs off" % mode,
                    dict(enumerate(touts[mode])),
                    dict(enumerate(touts["off"])), failures)
    rep["telemetry"] = truns
    log("info: telemetry and tier [%s]: %s" % (card, json.dumps(
        {k: v for k, v in rep.items() if k != "telemetry"})))
    log("info: telemetry cost [%s]: %s" % (card, json.dumps(
        {m: {"tokens_per_s": [r["tokens_per_s"] for r in runs],
             "ms_per_step": [r["ms_per_step"] for r in runs]}
         for m, runs in truns.items()})))
    return rep



def shared_prefix(seed):
    """The shared prefix of ``workload(seed, F)``: the seeded
    generator's first draw."""
    return np.random.RandomState(seed).randint(1, VOCAB, PREFIX_LEN)


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


# ---------------------------------------------------------------- library --
def op_cases():
    """``tests/_torch_port.py``: the op library's and the samplers' cases,
    shared with the CPU parity tests (imports no JAX)."""
    path = os.path.join(REPO, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import _torch_port
    return _torch_port


def op_sweep(mx, failures, checked):
    """Every case of ``OP_SPECS`` through the port on the card and on the
    CPU from the same inputs, forward and (where differentiable)
    backward, TF32 off, within ``CARD_TOL`` of its family; each alias
    of an op runs the op's first case under that name.  The grouped SGD
    ops take their per-tensor loop (``MXNET_FUSED_OPTIMIZER=0``): their
    kernel is held in the kernel checks.  Returns the count of cases
    run and the worst error of each family."""
    TP = op_cases()
    worst, n, bad = {}, 0, 0
    fused = os.environ.get("MXNET_FUSED_OPTIMIZER")
    os.environ["MXNET_FUSED_OPTIMIZER"] = "0"
    try:
        for module, specs in TP.OP_SPECS.items():
            seen = set()
            for spec in specs:
                names = [spec.name]
                if spec.name not in seen:
                    seen.add(spec.name)
                    names += [a for a in TP.op_names_of(spec.name)
                              if a != spec.name]
                for name in names:
                    try:
                        err = TP.check_on_card(spec, name=name)
                    except Exception as e:      # noqa: BLE001 (logged)
                        bad += 1
                        failures.append("op sweep %r as %s" % (spec, name))
                        log("check op %r as %s, card vs CPU  FAIL: %s"
                            % (spec, name, str(e).replace("\n", " ")[:300]))
                        continue
                    n += 1
                    checked.add(name)
                    worst[spec.fam] = max(worst.get(spec.fam, 0.0), err)
    finally:
        if fused is None:
            os.environ.pop("MXNET_FUSED_OPTIMIZER", None)
        else:
            os.environ["MXNET_FUSED_OPTIMIZER"] = fused
    log("check op sweep, card vs CPU (TF32 off): %d cases over %d op names, "
        "%d failed; worst |card - CPU| by family (limits %s): %s  %s"
        % (n, len(checked), bad, json.dumps(TP.CARD_TOL),
           json.dumps({k: float("%.3e" % v) for k, v in worst.items()}),
           "ok" if not bad else "FAIL"))
    return {"cases": n, "names": len(checked), "failed": bad,
            "worst_by_family": worst}


def random_on_card(mx, failures, checked):
    """Each sampler case (under each name it is registered by) on the
    card: two draws after ``mx.random.seed(0)`` bit-identical, a third
    without a re-seed different, the support and the moments
    (``check_draw``); then a hybridized block drawing
    ``F.random_uniform`` through its CUDA graph.  Returns the worst
    moment error in standard errors."""
    TP = op_cases()
    ctx = mx.gpu(0)
    worst, bad = 0.0, 0
    for spec in TP.RANDOM_SPECS:
        for name in TP.op_names_of(spec.name):
            try:
                mx.random.seed(0)
                a = TP.random_draw(mx, spec, ctx, name)
                mx.random.seed(0)
                b = TP.random_draw(mx, spec, ctx, name)
                c = TP.random_draw(mx, spec, ctx, name)
                same = all(np.array_equal(u, v) for u, v in zip(a, b))
                if not same or np.array_equal(a[0], c[0]):
                    raise AssertionError("seeded draws equal %s, unseeded "
                                         "draw differs %s"
                                         % (same,
                                            not np.array_equal(a[0], c[0])))
                worst = max(worst, TP.check_draw(spec, a))
                checked.add(name)
            except Exception as e:              # noqa: BLE001 (logged)
                bad += 1
                failures.append("random %s on the card" % name)
                log("check random %s on the card  FAIL: %s"
                    % (name, str(e).replace("\n", " ")[:300]))
    try:
        TP.check_hybridized_draws(ctx)
        hyb = True
    except Exception as e:                      # noqa: BLE001 (logged)
        hyb = False
        failures.append("hybridized random_uniform on the card")
        log("check hybridized F.random_uniform  FAIL: %s" % e)
    log("check random ops on the card: %d cases, seeded draws repeat, "
        "unseeded differ, support and moments within 6 standard errors "
        "(worst %.2f), %d failed; a hybridized block's F.random_uniform new "
        "at each replay and repeated after a re-seed: %s  %s"
        % (len(TP.RANDOM_SPECS), worst, bad, hyb,
           "ok" if not bad and hyb else "FAIL"))
    return {"worst_moment_se": worst, "failed": bad, "hybridized": hyb}


def lib_scheduler(mx):
    return mx.lr_scheduler.CosineScheduler(
        max_update=LIB_MAX_UPDATE, base_lr=LIB_LR, warmup_steps=LIB_WARMUP)


def lib_trainer(mx, net, opt):
    if opt == "adam":
        return mx.gluon.Trainer(net.collect_params(), "adam", {
            "learning_rate": LIB_LR, "wd": LIB_WD,
            "lr_scheduler": lib_scheduler(mx)})
    return mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": RESNET_LR, "momentum": RESNET_MOM})


def adam_path(mx, failures):
    """The slice's full-width path: ResNet-50 v1 through ``gluon.Trainer``
    with Adam under a cosine schedule, LIB_STEPS steps eager and
    LIB_STEPS after ``net.hybridize()``; the scheduler's rate at each
    step against a scheduler stepped apart on the host; then windows of
    the eager and hybridized Adam steps and of the hybridized SGD step
    (the Gluon cell's) in turns, a profiled window each, and the host
    time of ``trainer.step`` alone.  Returns the numbers."""
    card = card_line()
    ctx = mx.gpu(0)
    torch.backends.cudnn.allow_tf32 = True       # as the Gluon cell
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW)
                    .astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, RESNET_CLASSES, RESNET_B)
                    .astype(np.float32), ctx=ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def make(opt, hybridize):
        np.random.seed(0)
        net = mx.gluon.model_zoo.vision.resnet50_v1(classes=RESNET_CLASSES)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        if hybridize:
            net.hybridize()
        return net, lib_trainer(mx, net, opt)

    def stepper(net, trainer, host=None):
        def step():
            with mx.autograd.record():
                L = loss_fn(net(x), y)
            L.backward()
            if host is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            trainer.step(RESNET_B)
            if host is not None:
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                host.append(((t1 - t0) * 1e3,
                             (time.perf_counter() - t0) * 1e3))
            return L
        return step

    net, trainer = make("adam", False)
    sched = lib_scheduler(mx)
    step = stepper(net, trainer)
    losses, lr_ok, t_run = [], True, {}
    for phase_name in ("eager", "hybridized"):
        if phase_name == "hybridized":
            net.hybridize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LIB_STEPS):
            losses.append(float(step().asnumpy().mean()))
            n = trainer.optimizer.num_update
            lr_ok &= trainer.learning_rate == sched(n)
        t_run[phase_name] = (time.perf_counter() - t0) / LIB_STEPS
    eager_l, hyb_l = losses[:LIB_STEPS], losses[LIB_STEPS:]
    log("library: ResNet-50 v1 Adam (lr %g, wd %g, cosine to update %d, "
        "warmup %d) bs %d x 3 x %d x %d f32: eager losses %s; hybridized "
        "losses %s" % (LIB_LR, LIB_WD, LIB_MAX_UPDATE, LIB_WARMUP, RESNET_B,
                       RESNET_HW, RESNET_HW,
                       " ".join("%.4f" % v for v in eager_l),
                       " ".join("%.4f" % v for v in hyb_l)))
    for tag, ls in (("eager", eager_l), ("hybridized", hyb_l)):
        if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
            raise Failed("ResNet-50 Adam %s: losses %s" % (tag, ls))
    log("check cosine schedule: the Trainer's rate at each of %d steps "
        "equals a CosineScheduler stepped on the host: %s  %s"
        % (2 * LIB_STEPS, lr_ok, "ok" if lr_ok else "FAIL"))
    if not lr_ok:
        failures.append("Adam path learning rates")

    # in turns: eager Adam, hybridized Adam, hybridized SGD
    eager_net, eager_tr = make("adam", False)
    sgd_net, sgd_tr = make("sgd", True)
    steps = {"adam eager": stepper(eager_net, eager_tr),
             "adam hybridized": step,
             "sgd hybridized": stepper(sgd_net, sgd_tr)}
    for fn in steps.values():
        fn()                        # the SGD net captures here
    times = {m: [] for m in steps}
    order = ["adam eager", "adam hybridized", "sgd hybridized"]
    for m in (order + order[::-1]) * (LIB_TURNS // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LIB_WINDOW):
            steps[m]()
        torch.cuda.synchronize()
        times[m].append((time.perf_counter() - t0) / LIB_WINDOW)
    nums = {"card": card, "losses_eager": eager_l,
            "losses_hybridized": hyb_l,
            "run_ms_per_step": {k: v * 1e3 for k, v in t_run.items()}}
    for m, per in times.items():
        nums[m] = {"ms_per_step": [p * 1e3 for p in per],
                   "images_per_s": [RESNET_B / p for p in per]}
        log("library: ResNet-50 v1 %s step (bs %d, f32, cudnn.allow_tf32="
            "True): %s ms, %s images/s (host clock over %d-step windows, "
            "synchronised, in turns %s); %s"
            % (m, RESNET_B, " ".join("%.3f" % v for v in
                                     nums[m]["ms_per_step"]),
               " ".join("%.1f" % v for v in nums[m]["images_per_s"]),
               LIB_WINDOW, " ".join(order + order[::-1]), card))
    for m, fn in steps.items():
        nums[m]["profile"] = profile_window(
            fn, LIB_PROFILE, "ResNet-50 train steps, %s" % m)
    for m, net_, tr_ in (("adam", net, trainer), ("sgd", sgd_net, sgd_tr)):
        host = []
        fn = stepper(net_, tr_, host)
        for _ in range(LIB_PROFILE):
            fn()
        nums[m + " trainer.step"] = {
            "host_ms": [h for h, _ in host], "wall_ms": [w for _, w in host]}
        log("library: %s trainer.step alone (hybridized net, %d trainable "
            "tensors): "
            "host %.3f ms (median of %d, the call's own time after a "
            "synchronise), %.3f ms to the update's end; %s"
            % (m, sum(p.grad_req != "null" for p in tr_._params),
               float(np.median([h for h, _ in host])),
               len(host), float(np.median([w for _, w in host])), card))
    del net, trainer, eager_net, eager_tr, sgd_net, sgd_tr, steps, step
    gc.collect()
    torch.cuda.empty_cache()
    return nums


def family_run(mx, name, f16, ctx):
    """3 Trainer steps of optimizer ``name`` on the thumbnail ResNet-18
    on ``ctx`` and on the CPU from the same weights: the mean losses of
    both."""
    from mxnet_tpu_torch.convert import set_block_params
    hw = 16 if f16 else 32
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, hw, hw).astype(np.float32)
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
    set_block_params(card_net, arrays, ctx=ctx)
    opt = name.split("-")[0]
    opts = dict(FAMILY_OPTS.get(name, {}))
    dtype = "float32"
    if f16:
        dtype = "float16"
        opts["multi_precision"] = True
        for net in (card_net, cpu_net):
            net.cast(dtype)
    runs = []
    for net, c in ((card_net, ctx), (cpu_net, mx.cpu())):
        tr = mx.gluon.Trainer(net.collect_params(), opt, opts)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        X = mx.nd.array(x, ctx=c, dtype=dtype)
        Y = mx.nd.array(y, ctx=c)
        out = []
        for _ in range(3):
            with mx.autograd.record():
                L = loss_fn(net(X), Y)
            L.backward()
            tr.step(4)
            out.append(float(L.asnumpy().astype(np.float64).mean()))
        runs.append(out)
    return runs


def check_optimizer_family(mx, failures, names=FAMILY,
                           multi_precision=FAMILY_MP, ctx=None):
    """Each optimizer of the reference's registry (and the float16
    ``multi_precision`` cases) trains the thumbnail ResNet-18 3 steps on
    the card and on the CPU from the same weights, TF32 off; the mean
    losses within FAMILY_LOSS_TOL.  Returns the gaps by case."""
    ctx = ctx or mx.gpu(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gaps = {}
    cases = [(n, False) for n in names] + [(n, True)
                                          for n in multi_precision]
    for name, f16 in cases:
        card_l, cpu_l = family_run(mx, name, f16, ctx)
        tag = name + (" float16 multi_precision" if f16 else "")
        first, later = FAMILY_LOSS_TOL["float16" if f16 else
                                       name if name in FAMILY_LOSS_TOL
                                       else "other"]
        gap = [abs(a - b) for a, b in zip(card_l, cpu_l)]
        ok = all(np.isfinite(card_l)) and all(
            g <= (first if i == 0 else later) * (1 + abs(b))
            for i, (g, b) in enumerate(zip(gap, cpu_l)))
        gaps[tag] = gap
        log("check optimizer %s, thumbnail ResNet-18 3 steps, card vs CPU: "
            "%s vs %s, gaps %s (tol %.0e then %.0e, times 1+|loss|)  %s"
            % (tag, " ".join("%.6f" % v for v in card_l),
               " ".join("%.6f" % v for v in cpu_l),
               " ".join("%.2e" % g for g in gap), first, later,
               "ok" if ok else "FAIL"))
        if not ok:
            failures.append("optimizer %s card vs CPU" % tag)
    return gaps


def check_resume(mx, failures):
    """``save_states`` after 3 Adam steps of the thumbnail ResNet-18 on
    the card, ``load_states`` into a fresh Trainer over the same
    Parameters, 3 more steps: bit for bit the uninterrupted 6
    (deterministic cuDNN)."""
    from mxnet_tpu_torch.convert import set_block_params
    ctx = mx.gpu(0)
    rng = np.random.RandomState(6)
    x = mx.nd.array(rng.randn(4, 3, 32, 32).astype(np.float32), ctx=ctx)
    y = mx.nd.array(rng.randint(0, 10, 4).astype(np.float32), ctx=ctx)
    np.random.seed(6)
    net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(x)
    arrays = {k: v.data().asnumpy()
              for k, v in net._collect_params_with_prefix().items()}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def steps(tr, n):
        for _ in range(n):
            with mx.autograd.record():
                L = loss_fn(net(x), y)
            L.backward()
            tr.step(4)

    def trainer():
        return mx.gluon.Trainer(net.collect_params(), "adam", {
            "learning_rate": 1e-3, "wd": 1e-4,
            "lr_scheduler": mx.lr_scheduler.CosineScheduler(
                max_update=10, base_lr=1e-3, warmup_steps=2)})

    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_states_")
    try:
        steps(trainer(), 6)
        want = [v.data().asnumpy() for _, v in
                sorted(net._collect_params_with_prefix().items())]
        set_block_params(net, arrays, ctx=ctx)
        tr = trainer()
        steps(tr, 3)
        f = os.path.join(tmp, "adam.states")
        tr.save_states(f)
        tr2 = mx.gluon.Trainer(net.collect_params(), "adam")
        tr2.load_states(f)
        steps(tr2, 3)
        got = [v.data().asnumpy() for _, v in
               sorted(net._collect_params_with_prefix().items())]
    finally:
        torch.backends.cudnn.deterministic = flag
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    log("check save_states after 3 Adam steps, load_states into a fresh "
        "Trainer, 3 more: %d tensors bit for bit the uninterrupted 6 steps "
        "(deterministic cuDNN): %s  %s"
        % (len(got), same, "ok" if same else "FAIL"))
    if not same:
        failures.append("Trainer save/load resume on the card")
    return same


def sequential_on_card(mx, failures):
    """The twin of tests/test_symbol_module.py's SequentialModule case on
    ``mx.gpu(0)``: two chained Modules, Adam (lr 0.05), 10 epochs of 4
    batches of 16; the accuracy must pass the reference test's 0.8."""
    ctx = mx.gpu(0)
    sym = mx.sym
    np.random.seed(0)
    body = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                             num_hidden=16, name="fc_body"),
                          act_type="relu", name="act_body")
    head = sym.SoftmaxOutput(sym.FullyConnected(sym.Variable("data"),
                                                num_hidden=3,
                                                name="fc_head"),
                             name="softmax")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(body, label_names=[], context=ctx))
    seq.add(mx.mod.Module(head, label_names=["softmax_label"], context=ctx),
            take_labels=True)
    X = np.random.randn(64, 10).astype("float32")
    Y = X[:, :3].argmax(1).astype("float32")
    seq.bind(data_shapes=[("data", (16, 10))],
             label_shapes=[("softmax_label", (16,))])
    seq.init_params(mx.initializer.Xavier())
    seq.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.05})
    metric = mx.metric.create("acc")
    for _ in range(10):
        metric.reset()
        for i in range(0, 64, 16):
            batch = mx.io.DataBatch(data=[mx.nd.array(X[i:i + 16], ctx=ctx)],
                                    label=[mx.nd.array(Y[i:i + 16],
                                                       ctx=ctx)])
            seq.forward(batch, is_train=True)
            seq.backward()
            seq.update()
            seq.update_metric(metric, batch.label)
    acc = metric.get()[1]
    ok = acc > 0.8 and seq.get_outputs()[0].shape == (16, 3)
    log("check SequentialModule (two Modules, Adam) on the card: accuracy "
        "%.4f after 10 epochs (> 0.8, the reference test's)  %s"
        % (acc, "ok" if ok else "FAIL"))
    if not ok:
        failures.append("SequentialModule on the card")
    return acc


def library_path(mx, failures):
    """The ``library`` phase, every registered launch counter from 0 (all
    but ``nms_keep``, which the vision ops' cases launch, stay 0): the op
    sweep and the
    samplers on the card (every op name of the registry but ``Custom``
    must be covered), the ResNet-50 Adam path, the optimizer family and
    ``multi_precision`` card against CPU, the save/load resume and
    ``SequentialModule``.  Returns the numbers."""
    from mxnet_tpu_torch._graphs import kept_launches
    from mxnet_tpu_torch.ops import registry as reg
    nums, checked = {}, set()
    with kept_launches() as (counters, _):
        for h, a in counters:
            setattr(h, a, 0)
        t0 = time.perf_counter()
        nums["sweep"] = op_sweep(mx, failures, checked)
        nums["random"] = random_on_card(mx, failures, checked)
        t_sweep = time.perf_counter() - t0
        missed = sorted(set(reg.list_ops()) - checked - {"Custom"})
        log("check op sweep coverage: %d of %d registered op names run on "
            "the card (Custom aside); missed %s  %s"
            % (len(checked), len(reg.list_ops()), missed,
               "ok" if not missed else "FAIL"))
        if missed:
            failures.append("op sweep missed %s" % missed)
        t0 = time.perf_counter()
        nums["adam"] = adam_path(mx, failures)
        t_adam = time.perf_counter() - t0
        t0 = time.perf_counter()
        nums["family"] = check_optimizer_family(mx, failures)
        t_family = time.perf_counter() - t0
        nums["resume"] = check_resume(mx, failures)
        nums["sequential_accuracy"] = sequential_on_card(mx, failures)
        launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__), a):
                    getattr(h, a) for h, a in counters}
    log("library path launches of the port's kernels: %s (only nms_keep, "
        "through the vision ops' cases, is on this path)"
        % json.dumps(launches))
    if any(v for k, v in launches.items() if k != "nms_keep.launches"):
        failures.append("a hand-written kernel launched on the library "
                        "path: %s" % json.dumps(launches))
    log("library phase seconds: sweep and samplers %.1f, ResNet-50 Adam "
        "%.1f, optimizer family %.1f" % (t_sweep, t_adam, t_family))
    nums["launches"] = launches
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return nums


def close(name, pairs, failures, tol):
    """One check over [(got, ref)] tensors: shapes equal, ``got`` finite
    and within ``tol`` x (1 + |ref|) of ``ref`` (``tol`` 0: bit for bit).
    Logs the largest error and error / limit; returns the largest
    error."""
    err, ratio, ok = 0.0, 0.0, True
    for g, r in pairs:
        g, r = g.detach().double().cpu(), r.detach().double().cpu()
        ok &= tuple(g.shape) == tuple(r.shape) and bool(
            torch.isfinite(g).all())
        if not ok:
            break
        d = (g - r).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if tol > 0 and d.numel():
            ratio = max(ratio, float((d / (tol * (1 + r.abs()))).max()))
    ok &= ratio <= 1.0 if tol > 0 else err == 0.0
    log("check %-56s max_abs_err %.3e  %s  err/limit %.3f  %s"
        % (name, err, "tol %.0e*(1+|ref|)" % tol if tol else "bit for bit",
           ratio, "ok" if ok else "FAIL"))
    if not ok:
        failures.append(name)
    return err


def rnn_op_on_card(mx, failures):
    """The fused op for each mode, 1 and 2 layers, uni- and
    bidirectional, from initial states: outputs and the gradients of the
    data, the flat parameters and the states, card against CPU.
    Returns the largest error."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    Tn, N, I, H = RNN_SMALL
    rng = np.random.RandomState(0)

    def run(ctx, arrays, attrs, heads):
        xs = [mx.nd.array(a, ctx=ctx) for a in arrays]
        for x in xs:
            x.attach_grad()
        with mx.autograd.record():
            outs = mx.nd.RNN(*xs, **attrs)
        mx.autograd.backward(list(outs),
                             [mx.nd.array(h, ctx=ctx) for h in heads])
        return [o._data for o in outs] + [x.grad._data for x in xs]

    worst = 0.0
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for L, bi in itertools.product((1, 2), (False, True)):
            D, n_st = 2 if bi else 1, 2 if mode == "lstm" else 1
            arrays = [rng.randn(Tn, N, I),
                      rng.uniform(-0.6, 0.6,
                                  rnn_param_size(mode, L, I, H, bi))]
            arrays += [rng.randn(L * D, N, H) for _ in range(n_st)]
            heads = [rng.randn(Tn, N, H * D)] + [rng.randn(L * D, N, H)
                                                 for _ in range(n_st)]
            arrays = [a.astype(np.float32) for a in arrays]
            heads = [h.astype(np.float32) for h in heads]
            attrs = dict(state_size=H, num_layers=L, mode=mode,
                         bidirectional=bi, state_outputs=True)
            worst = max(worst, close(
                "RNN %s L%d %s, outputs and grads, card vs CPU"
                % (mode, L, "bi" if bi else "uni"),
                zip(run(mx.gpu(0), arrays, attrs, heads),
                    run(mx.cpu(), arrays, attrs, heads)), failures,
                RNN_TOL))
    return worst


def cells_vs_fused_on_card(mx, failures):
    """Each mode's cells unrolled on the card (two stacked, and one
    bidirectional pair) against the fused layer whose flat vector packs
    their weights and biases: outputs and states.  Returns the largest
    error."""
    Tn, N, I, H = RNN_SMALL
    ctx, rnn = mx.gpu(0), mx.gluon.rnn
    x = mx.nd.array(np.random.RandomState(1).randn(Tn, N, I)
                    .astype(np.float32), ctx=ctx)

    def cell(mode, width):
        if mode == "lstm":
            return rnn.LSTMCell(H, input_size=width)
        if mode == "gru":
            return rnn.GRUCell(H, input_size=width)
        return rnn.RNNCell(H, activation=mode[4:], input_size=width)

    worst = 0.0
    for mode, bi in itertools.product(("lstm", "gru", "rnn_tanh"),
                                      (False, True)):
        if bi:
            cells = [cell(mode, I), cell(mode, I)]
            net = rnn.BidirectionalCell(*cells)
        else:
            cells = [cell(mode, I), cell(mode, H)]
            net = rnn.SequentialRNNCell()
            for c in cells:
                net.add(c)
        net.initialize(mx.init.Uniform(0.5), ctx=ctx)
        # the fused packing: every weight (W then R) by layer and
        # direction, then every bias (bW then bR)
        flat = [getattr(c, k).data()._data.reshape(-1)
                for names in (("i2h_weight", "h2h_weight"),
                              ("i2h_bias", "h2h_bias"))
                for c in cells for k in names]
        cls = {"lstm": rnn.LSTM, "gru": rnn.GRU}.get(mode, rnn.RNN)
        extra = {} if mode in ("lstm", "gru") else {"activation": "tanh"}
        fused = cls(H, 1 if bi else 2, bidirectional=bi, input_size=I,
                    **extra)
        fused.initialize(ctx=ctx)
        fused.parameters.set_data(torch.cat(flat))
        want, want_st = net.unroll(Tn, x, layout="TNC")
        got, got_st = fused(x, fused.begin_state(N, ctx=ctx))
        per = 2 if mode == "lstm" else 1
        pairs = [(got._data, want._data)] + [
            (s._data, torch.stack([want_st[j * per + k]._data
                                   for j in range(2)]))
            for k, s in enumerate(got_st)]
        worst = max(worst, close("cells vs fused %s %s (card)" % (
            mode, "bidirectional" if bi else "2 stacked"), pairs, failures,
            RNN_TOL))
    return worst


def control_flow_on_card(mx, failures):
    """foreach, while_loop and cond inside one hybridized block: its
    forward and backward CUDA graphs replayed on three inputs, bit for
    bit against the same block op by op, and within RNN_TOL of the
    CPU."""
    contrib = mx.nd.contrib

    class Loops(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            outs, h = contrib.foreach(
                lambda xt, s: (F.tanh(xt + s), F.tanh(xt + s)), x,
                F.zeros_like(x[0]))
            w_outs, (v, s) = contrib.while_loop(
                lambda v, s: s.sum() < 4.0,
                lambda v, s: (v * 2, (v * 1.1, s + F.abs(v))), [h, h * 0],
                max_iterations=6)
            c = contrib.cond(x.sum() > 0, lambda a: a * 3,
                             lambda a: a - 1, [v])
            return outs, w_outs, s, c

    def run(net, ctx):
        res = []
        for seed in range(3):
            x = mx.nd.array(np.random.RandomState(seed).randn(4, 3)
                            .astype(np.float32) * (1 if seed % 2 else -1),
                            ctx=ctx)
            x.attach_grad()
            with mx.autograd.record():
                outs = net(x)
                loss = sum((o * o).sum() for o in outs)
            loss.backward()
            res += [o._data.clone() for o in outs] + [x.grad._data.clone()]
        return res

    hyb = Loops()
    hyb.hybridize()
    eager, replay = run(Loops(), mx.gpu(0)), run(hyb, mx.gpu(0))
    cpu = run(Loops(), mx.cpu())
    close("foreach/while_loop/cond hybridized: replay vs eager (card)",
          zip(replay, eager), failures, 0)
    return close("foreach/while_loop/cond on the card vs CPU",
                 zip(eager, cpu), failures, RNN_TOL)


def sym_rnn_on_card(mx, failures):
    """``mx.sym.RNN`` (2-layer bidirectional LSTM) bound by the
    executor on the card (its CUDA graphs) and on the CPU: the output
    and every argument's gradient."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    Tn, N, I, H = RNN_SMALL
    rng = np.random.RandomState(2)
    sym = mx.sym
    y = sym.RNN(sym.Variable("data"), sym.Variable("rnn_params"),
                sym.Variable("state"), sym.Variable("state_cell"),
                state_size=H, num_layers=2, mode="lstm", bidirectional=True,
                state_outputs=True, name="rnn0")[0]
    values = {"data": rng.rand(Tn, N, I),
              "rnn_params": (rng.rand(rnn_param_size("lstm", 2, I, H, True))
                             - 0.5) * 0.4,
              "state": 0.1 * rng.randn(4, N, H),
              "state_cell": 0.1 * rng.randn(4, N, H)}
    head = rng.randn(Tn, N, 2 * H).astype(np.float32)
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        args = {k: mx.nd.array(v.astype(np.float32), ctx=ctx)
                for k, v in values.items()}
        ex = y.bind(ctx, args, grad_req="write")
        out = ex.forward(is_train=True)[0]._data.clone()
        ex.backward(mx.nd.array(head, ctx=ctx))
        res.append([out] + [ex.grad_dict[k]._data.clone()
                            for k in sorted(values)])
    return close("mx.sym.RNN executor, output and grads, card vs CPU",
                 zip(*res), failures, RNN_TOL)


def word_lm_model(mx, dropout):
    """The word language model as the example's model.py builds it
    (``--tied``): embedding, dropout, LSTM, dropout, a decoder sharing
    the embedding's weight."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class RNNModel(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(WLM_VOCAB, WLM_WIDTH)
                self.rnn = rnn.LSTM(WLM_WIDTH, WLM_LAYERS, dropout=dropout,
                                    input_size=WLM_WIDTH)
                self.decoder = nn.Dense(WLM_VOCAB, flatten=False,
                                        in_units=WLM_WIDTH,
                                        params=self.encoder.params)

        def hybrid_forward(self, F, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            return self.decoder(self.drop(output)), hidden

    return RNNModel()


def wlm_tokens(segments, seed=0):
    """``segments`` x bptt + 1 rows of WLM_B token streams (the example's
    batchify layout), each id drawn with probability 1 / rank."""
    p = 1.0 / np.arange(1, WLM_VOCAB + 1)
    rng = np.random.RandomState(seed)
    return rng.choice(WLM_VOCAB, size=(segments * WLM_BPTT + 1, WLM_B),
                      p=p / p.sum()).astype(np.float32)


def wlm_run(mx, data, dropout, seed):
    """A model on the card from ``np.random.seed(seed)`` and the
    example's training step over ``data`` (segment after segment):
    (net, step, its record {"norms": [...]}).  ``step()`` returns the
    per-token losses."""
    ctx = mx.gpu(0)
    np.random.seed(seed)
    net = word_lm_model(mx, dropout)
    net.initialize(mx.init.Uniform(0.1), ctx=ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": WLM_LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = list(net.collect_params().values())
    n_seg = (data.shape[0] - 1) // WLM_BPTT
    rec = {"hidden": net.rnn.begin_state(WLM_B, ctx=ctx), "i": 0,
           "norms": []}

    def step():
        i = rec["i"] % n_seg
        rec["i"] += 1
        x = data[i * WLM_BPTT:(i + 1) * WLM_BPTT]
        y = data[i * WLM_BPTT + 1:(i + 1) * WLM_BPTT + 1]
        hidden = [h.detach() for h in rec["hidden"]]
        with mx.autograd.record():
            out, hidden = net(x, hidden)
            L = loss_fn(out.reshape((-1, WLM_VOCAB)), y.reshape((-1,)))
        L.backward()
        rec["norms"].append(mx.gluon.utils.clip_global_norm(
            [p.grad() for p in params], WLM_CLIP * WLM_BPTT * WLM_B))
        trainer.step(WLM_BPTT * WLM_B)
        rec["hidden"] = hidden
        return L

    return net, step, rec


def word_lm_path(mx, failures):
    """The word LM at full width: WLM_STEPS steps op by op, then
    WLM_STEPS after ``net.hybridize()`` (the forward and backward as
    CUDA graphs through ``_CachedOp``, one signature), a finite loss
    that falls; WLM_CHECK steps captured against op by op at dropout 0,
    bit for bit; then windows of an eager and the hybridized model in
    turns and a profiled window each.  Returns the numbers."""
    card = card_line()
    ctx = mx.gpu(0)
    data = mx.nd.array(wlm_tokens(2 * WLM_STEPS), ctx=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # earlier phases' live tensors
    net, step, rec = wlm_run(mx, data, WLM_DROPOUT, 0)
    n_params = sum(int(np.prod(p.shape))
                   for p in net.collect_params().values())
    losses, t_run = [], {}
    for name in ("eager", "hybridized"):
        if name == "hybridized":
            net.hybridize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WLM_STEPS):
            losses.append(float(step().mean().asscalar()))
        t_run[name] = (time.perf_counter() - t0) / WLM_STEPS
    peak = torch.cuda.max_memory_allocated() - held
    # lr 20 on a random stream spikes a step now and then: the end is
    # the median of the last 5 steps
    ok = all(np.isfinite(losses)) and np.median(losses[-5:]) < losses[0]
    log("check word LM (%d-layer LSTM %d, vocab %d, tied, dropout %.1f, "
        "%d parameters) bs %d x bptt %d, SGD lr %g, clip %g: losses at "
        "steps 1, %d, %d: %.4f %.4f %.4f (finite; the median of the last "
        "5, %.4f, below step 1's)  %s"
        % (WLM_LAYERS, WLM_WIDTH, WLM_VOCAB, WLM_DROPOUT, n_params, WLM_B,
           WLM_BPTT, WLM_LR,
           WLM_CLIP * WLM_BPTT * WLM_B, WLM_STEPS, 2 * WLM_STEPS,
           losses[0], losses[WLM_STEPS - 1], losses[-1],
           np.median(losses[-5:]), "ok" if ok else "FAIL"))
    log("info: word LM losses, eager %s; hybridized %s; clip norms %s"
        % (" ".join("%.4f" % v for v in losses[:WLM_STEPS]),
           " ".join("%.4f" % v for v in losses[WLM_STEPS:]),
           " ".join("%.1f" % v for v in rec["norms"])))
    if not ok:
        failures.append("word LM loss")

    runs = []
    for hybrid in (False, True):
        n2, s2, r2 = wlm_run(mx, data, 0.0, 1)
        if hybrid:
            n2.hybridize()
        ls = [s2()._data.clone() for _ in range(WLM_CHECK)]
        runs.append(ls + [p.data()._data.clone()
                          for p in n2.collect_params().values()])
        runs[-1].append(torch.tensor(r2["norms"], dtype=torch.float64))
        del n2, s2, r2
    close("word LM %d steps at dropout 0: captured vs eager (losses, "
          "norms, parameters)" % WLM_CHECK, zip(runs[1], runs[0]),
          failures, 0)
    del runs

    _, eager_step, _ = wlm_run(mx, data, WLM_DROPOUT, 2)
    steps = {"eager": eager_step, "hybridized": step}
    eager_step()
    order = ["eager", "hybridized"]
    times = {m: [] for m in order}
    for m in (order + order[::-1]) * (WLM_TURNS // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WLM_WINDOW):
            steps[m]()
        torch.cuda.synchronize()
        times[m].append((time.perf_counter() - t0) / WLM_WINDOW)
    tokens = WLM_BPTT * WLM_B
    nums = {"card": card, "parameters": n_params,
            "losses": [losses[0], losses[WLM_STEPS - 1], losses[-1]],
            "run_ms_per_step": {k: v * 1e3 for k, v in t_run.items()},
            "peak_memory_gib": peak / 2**30}
    for m in order:
        nums[m] = {"ms_per_step": [t * 1e3 for t in times[m]],
                   "tokens_per_s": [tokens / t for t in times[m]],
                   "profile": profile_window(
                       steps[m], WLM_PROFILE, "word LM train steps, %s" % m)}
        log("rnn: word LM %s step (bs %d x bptt %d, f32): %s ms, %s "
            "tokens/s (host clock over %d-step windows, synchronised, in "
            "turns %s); %s"
            % (m, WLM_B, WLM_BPTT,
               " ".join("%.3f" % v for v in nums[m]["ms_per_step"]),
               " ".join("%.1f" % v for v in nums[m]["tokens_per_s"]),
               WLM_WINDOW, " ".join((order + order[::-1])
                                    * (WLM_TURNS // 2)), card))
    log("rnn: word LM peak memory %.3f GiB over the %.3f GiB held before "
        "its 40 steps; run ms/step eager %.3f, hybridized %.3f (steps "
        "21-40, the capture included)"
        % (peak / 2**30, held / 2**30, t_run["eager"] * 1e3,
           t_run["hybridized"] * 1e3))
    del net, step, eager_step, steps
    return nums


def lstm_yardstick(mx, failures):
    """The port's 2-layer LSTM layer at the word LM's shape (T 35, N 32,
    650), forward and backward, op by op and hybridized, beside cuDNN's
    fused LSTM (``torch._VF.lstm``, a library call the port never makes)
    on the same weights unpacked as views of the flat vector: outputs
    within YARD_TOL, the three timed in turns.  Returns the numbers."""
    import warnings
    from mxnet_tpu_torch.ops.rnn_op import _unpack_params
    ctx, Tn, N, W = mx.gpu(0), WLM_BPTT, WLM_B, WLM_WIDTH
    rng = np.random.RandomState(3)
    x = mx.nd.array(rng.randn(Tn, N, W).astype(np.float32), ctx=ctx)
    x.attach_grad()
    h0 = [mx.nd.array(0.1 * rng.randn(WLM_LAYERS, N, W).astype(np.float32),
                      ctx=ctx) for _ in range(2)]
    head = mx.nd.array(rng.randn(Tn, N, W).astype(np.float32), ctx=ctx)
    layers = {}
    for hybrid in (False, True):
        np.random.seed(3)
        layer = mx.gluon.rnn.LSTM(W, WLM_LAYERS, input_size=W)
        layer.initialize(mx.init.Uniform(0.1), ctx=ctx)
        if hybrid:
            layer.hybridize()
        layers[hybrid] = layer

    def port(layer):
        def run():
            with mx.autograd.record():
                out, _ = layer(x, h0)
            out.backward(head)
            return out._data
        return run

    flat = layers[False].parameters.data()._data
    weights, biases = _unpack_params(flat, "lstm", WLM_LAYERS, W, W, 1)
    views = [t for (wr, b) in zip(weights, biases) for t in wr[0] + b[0]]
    xt = x._data.detach().requires_grad_()
    hx = tuple(h._data for h in h0)

    def cudnn():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the views are not one chunk
            out = torch._VF.lstm(xt, hx, views, True, WLM_LAYERS, 0.0, True,
                                 False, False)[0]
        out.backward(head._data)
        return out

    runs = {"port eager": port(layers[False]),
            "port hybridized": port(layers[True]), "cudnn": cudnn}
    outs = {k: fn().detach().clone() for k, fn in runs.items()}
    err = close("LSTM 2x650 T35 N32: port vs cuDNN (torch._VF.lstm)",
                [(outs["port eager"], outs["cudnn"])], failures, YARD_TOL)
    close("LSTM 2x650: hybridized vs eager", [(outs["port hybridized"],
                                               outs["port eager"])],
          failures, 0)
    order = list(runs)
    times = {k: [] for k in order}
    for k in order + order[::-1]:
        for _ in range(2):
            runs[k]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WLM_WINDOW):
            runs[k]()
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0) * 1e3 / WLM_WINDOW)
    log("rnn: LSTM 2 x 650 (T %d, N %d, f32) forward + backward ms: %s "
        "(host clock over %d calls, synchronised, in turns); %s"
        % (Tn, N, json.dumps({k: [round(v, 3) for v in t]
                              for k, t in times.items()}), WLM_WINDOW,
           card_line()))
    del layers, runs
    return {"max_abs_err": err, "ms": times}


def rnn_path(mx, failures):
    """The ``rnn`` phase, every registered launch counter from 0 (all
    stay 0: no hand-written kernel is on this path): the small checks,
    the word LM and the LSTM yardstick.  Returns the numbers."""
    from mxnet_tpu_torch._graphs import kept_launches
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nums = {}
    with kept_launches() as (counters, _):
        for h, a in counters:
            setattr(h, a, 0)
        t0 = time.perf_counter()
        nums["small"] = {"rnn_op": rnn_op_on_card(mx, failures),
                         "cells": cells_vs_fused_on_card(mx, failures),
                         "control_flow": control_flow_on_card(mx, failures),
                         "sym": sym_rnn_on_card(mx, failures)}
        t_small = time.perf_counter() - t0
        t0 = time.perf_counter()
        nums["word_lm"] = word_lm_path(mx, failures)
        t_wlm = time.perf_counter() - t0
        nums["yardstick"] = lstm_yardstick(mx, failures)
        launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__), a):
                    getattr(h, a) for h, a in counters}
    log("rnn path launches of the port's kernels: %s (no hand-written "
        "kernel is on this path)" % json.dumps(launches))
    if any(launches.values()):
        failures.append("a hand-written kernel launched on the rnn path: %s"
                        % json.dumps(launches))
    log("rnn phase seconds: small checks %.1f, word LM %.1f"
        % (t_small, t_wlm))
    nums["launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return nums


def zoo_nets(mx, name, size, x):
    """Two copies of ``name`` on the card with the same Xavier weights
    (the second hybridized), Dropout rates 0, shapes resolved by a
    predict-mode forward (which moves no running statistic)."""
    nets = []
    for hybrid in (False, True):
        np.random.seed(0)
        net = mx.gluon.model_zoo.vision.get_model(name)

        def no_dropout(block):
            if type(block).__name__ == "Dropout":
                block._rate = 0.0
        net.apply(no_dropout)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(x[:1])
        nets.append(net)
    for a, b in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        b.set_data(a.data())
    nets[1].hybridize()
    return nets


def zoo_step(mx, net, x, y):
    """A ``gluon.Trainer`` SGD step of ``net`` on (x, y): returns
    (step(), trainer); step() returns the output and the mean loss."""
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": ZOO_LR, "momentum": 0.9, "wd": 1e-4})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step():
        with mx.autograd.record():
            out = net(x)
            L = loss_fn(out, y)
        L.backward()
        trainer.step(ZOO_B)
        return out, L.mean()
    return step, trainer


def zoo_state(net, trainer):
    """Parameters (running statistics included) and momentum traces."""
    return ([p.data()._data.clone() for p in net.collect_params().values()]
            + [s._data.clone() for _, s in sorted(
                trainer._updater.states.items()) if s is not None])


def zoo_family(mx, name, size, failures):
    """One family: the captured-vs-eager check, timings in turns, the
    loss over the hybridized net's steps, and a profile for ZOO_PROFILED.
    Returns its numbers."""
    card = card_line()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = mx.nd.NDArray(torch.randn(ZOO_B, 3, size, size, device="cuda",
                                  generator=g))
    y = mx.nd.NDArray(torch.randint(0, 1000, (ZOO_B,), device="cuda",
                                    generator=g).float())
    t0 = time.perf_counter()
    nets = zoo_nets(mx, name, size, x)
    n_params = sum(int(np.prod(p.shape)) for p in
                   nets[0].collect_params().values() if p.grad_req != "null")
    steps, runs, losses = [], [], {}
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for net, kind in zip(nets, ("eager", "hybridized")):
            step, trainer = zoo_step(mx, net, x, y)
            outs = []
            losses[kind] = []
            for _ in range(ZOO_CHECK):
                out, L = step()
                outs.append(out._data.clone())
                losses[kind].append(L._data)
            runs.append(outs + zoo_state(net, trainer))
            steps.append(step)
    finally:
        torch.backends.cudnn.deterministic = flag
    close("zoo %s: %d steps hybridized vs op by op (outputs, parameters, "
          "running statistics, momentum)" % (name, ZOO_CHECK),
          zip(runs[1], runs[0]), failures, 0)
    del runs
    t_check = time.perf_counter() - t0
    # the graphs were captured with deterministic cuDNN: capture again
    # with cuDNN's default choices, which the eager steps now make too;
    # one step each outside the clock
    nets[1].hybridize()
    for step in steps:
        step()
    order = ["eager", "hybridized"]
    times = {m: [] for m in order}
    for m in order + order[::-1]:
        step = steps[order.index(m)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ZOO_WINDOW):
            losses[m].append(step()[1]._data)
        torch.cuda.synchronize()
        times[m].append((time.perf_counter() - t0) * 1e3 / ZOO_WINDOW)
    seq = [float(v) for v in losses["hybridized"]]
    ok = all(np.isfinite(seq)) and np.median(seq[-3:]) < seq[0]
    log("check zoo %s loss over %d hybridized steps: %s (finite; the "
        "median of the last 3 below the first)  %s"
        % (name, len(seq), " ".join("%.4f" % v for v in seq),
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("zoo %s loss" % name)
    nums = {"card": card, "size": size, "parameters": n_params,
            "losses": seq, "check_seconds": t_check}
    for m in order:
        nums[m] = {"ms_per_step": times[m],
                   "images_per_s": [ZOO_B * 1e3 / t for t in times[m]]}
        log("zoo: %s %s step (bs %d x 3 x %d^2, f32): %s ms, %s images/s "
            "(host clock over %d-step windows, synchronised, in turns "
            "%s); %s"
            % (name, m, ZOO_B, size,
               " ".join("%.3f" % v for v in times[m]),
               " ".join("%.1f" % v for v in nums[m]["images_per_s"]),
               ZOO_WINDOW, " ".join(order + order[::-1]), card))
    if name in ZOO_PROFILED:
        nums["hybridized"]["profile"] = profile_window(
            steps[1], ZOO_PROFILE, "%s hybridized train steps" % name)
    del nets, steps
    gc.collect()
    torch.cuda.empty_cache()
    return nums


def conv_layers_on_card(mx, failures):
    """Every case of ``tests/_torch_zoo.py``'s ``CONV_CASES`` (the conv,
    transposed conv, pooling and padding layers this slice added) on the
    card, hybridized, against the CPU from the same weights, forward and
    backward, within ``CARD_TOL`` of its family (gradients at
    ``GRAD_FACTOR`` times it).  Returns the largest error / limit."""
    from mxnet_tpu_torch.convert import set_block_params
    tp = op_cases()
    import _torch_zoo as tz
    worst, bad = 0.0, []
    for name, (make, x, fam) in sorted(tz.CONV_CASES.items()):
        np.random.seed(0)
        cpu = make(mx)
        cpu.initialize(mx.init.Uniform(0.5), ctx=mx.cpu())
        cpu(mx.nd.array(x, ctx=mx.cpu()))
        card = make(mx)
        card.initialize(ctx=mx.gpu(0))
        set_block_params(card, {
            k: v.data().asnumpy()
            for k, v in cpu._collect_params_with_prefix().items()},
            ctx=mx.gpu(0))
        card.hybridize()
        want = tz.run_block(mx, cpu, x, mx.cpu())
        got = tz.run_block(mx, card, x, mx.gpu(0))
        rtol, atol = tp.CARD_TOL[fam]
        for k, (a, b) in enumerate(zip(got, want)):
            f = 1.0 if k == 0 else tp.GRAD_FACTOR
            lim = atol * f + rtol * f * np.abs(b)
            r = float((np.abs(a - b) / np.maximum(lim, 1e-30)).max()) \
                if a.size else 0.0
            if a.shape != b.shape or not np.isfinite(a).all() or r > 1.0:
                bad.append("%s[%d]" % (name, k))
            worst = max(worst, r)
    log("check zoo conv/pool layers card vs CPU: %d cases (output, input "
        "and parameter gradients), CARD_TOL by family, worst err/limit "
        "%.3f; failing %s  %s"
        % (len(tz.CONV_CASES), worst, bad, "FAIL" if bad else "ok"))
    if bad:
        failures.append("zoo conv layers on the card: %s" % bad)
    return worst


def zoo_path(mx, failures):
    """The ``zoo`` phase, every registered launch counter from 0 (all
    stay 0: no hand-written kernel is on this path): the conv/pool
    layers on the card against the CPU, then each family of ZOO.
    Returns the numbers."""
    from mxnet_tpu_torch._graphs import kept_launches
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nums = {}
    with kept_launches() as (counters, _):
        for h, a in counters:
            setattr(h, a, 0)
        nums["conv_layers_err_over_limit"] = conv_layers_on_card(mx,
                                                                 failures)
        for name, size in ZOO:
            t0 = time.perf_counter()
            nums[name] = zoo_family(mx, name, size, failures)
            nums[name]["seconds"] = time.perf_counter() - t0
        launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__), a):
                    getattr(h, a) for h, a in counters}
    log("zoo path launches of the port's kernels: %s (no hand-written "
        "kernel is on this path)" % json.dumps(launches))
    if any(launches.values()):
        failures.append("a hand-written kernel launched on the zoo path: "
                        "%s" % json.dumps(launches))
    log("zoo phase seconds (the build and captured-vs-eager check of "
        "each in brackets): %s" % json.dumps(
            {k: "%.1f (%.1f)" % (v["seconds"], v["check_seconds"])
             for k, v in nums.items() if isinstance(v, dict)}))
    nums["launches"] = launches
    return nums


# ------------------------------------------------------------- detection --
# MXNet's example/ssd VGG16-reduced 300 (symbol/symbol_factory.py): six
# feature maps, their anchor sizes, ratios and steps; 8732 anchors
SSD300 = dict(
    maps=(38, 19, 10, 5, 3, 1),
    sizes=((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
           (.88, .961)),
    ratios=((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5, 3, 1. / 3),
            (1, 2, .5, 3, 1. / 3), (1, 2, .5), (1, 2, .5)),
    steps=(8, 16, 32, 64, 100, 300))
DET_B, DET_M, DET_CLASSES = 32, 16, 21
# Faster R-CNN's RPN on a 600 x 800 image: a 38 x 50 map at stride 16,
# 9 anchors, 6000 boxes into NMS at 0.7, 300 out
RPN = dict(H=38, W=50, stride=16, scales=(8, 16, 32), ratios=(0.5, 1, 2),
           pre=6000, post=300, thresh=0.7)
DET_CALLS = 20
SSD_CHECK_STEPS = 3
# SSD300 ops, card against CPU: the box decode's and the targets' exp and
# log round differently in CUDA's libm (a few ulp of a unit box)
DET_BOX_TOL = 1e-5
RPN_BOX_TOL = 1e-3      # pixel coordinates up to 800: a few ulp


def ssd_helpers():
    """``tests/_torch_ssd.py``: the example's SSD driven through the
    port's API (shared with the CPU tests; imports no JAX)."""
    op_cases()                      # puts tests/ on sys.path
    import _torch_ssd
    return _torch_ssd


def ssd300_anchors(mx, ctx):
    parts = [mx.nd.MultiBoxPrior(mx.nd.zeros((1, 1, m, m), ctx=ctx),
                                 sizes=sz, ratios=r,
                                 steps=(st / 300.0, st / 300.0))
             for m, sz, r, st in zip(SSD300["maps"], SSD300["sizes"],
                                     SSD300["ratios"], SSD300["steps"])]
    return mx.nd.concat(*parts, dim=1)


def ssd300_inputs(mx, ctx, seed=0):
    """Labels (B, M, 5) with 2..M-2 valid rows an image (the rest padded
    with class -1), class scores (B, 21, A) and box offsets (B, 4A)."""
    rng = np.random.RandomState(seed)
    A = 8732
    xy = rng.uniform(0, 0.7, (DET_B, DET_M, 2))
    wh = rng.uniform(0.05, 0.3, (DET_B, DET_M, 2))
    lab = np.concatenate([rng.randint(0, DET_CLASSES - 1,
                                      (DET_B, DET_M, 1)), xy, xy + wh], 2)
    n_valid = rng.randint(2, DET_M - 1, DET_B)
    lab[np.arange(DET_M)[None, :] >= n_valid[:, None], 0] = -1
    cls_pred = rng.randn(DET_B, DET_CLASSES, A) * 2
    loc = rng.randn(DET_B, 4 * A) * 0.5
    return (mx.nd.array(lab.astype("float32"), ctx=ctx),
            mx.nd.array(cls_pred.astype("float32"), ctx=ctx),
            mx.nd.array(loc.astype("float32"), ctx=ctx))


def rpn_inputs(mx, ctx, seed=1):
    rng = np.random.RandomState(seed)
    A = len(RPN["scales"]) * len(RPN["ratios"])
    cls = rng.uniform(0, 1, (1, 2 * A, RPN["H"], RPN["W"]))
    bb = rng.randn(1, 4 * A, RPN["H"], RPN["W"]) * 0.1
    info = np.array([[RPN["H"] * RPN["stride"], RPN["W"] * RPN["stride"],
                      1.0]])
    return [mx.nd.array(x.astype("float32"), ctx=ctx)
            for x in (cls, bb, info)]


def rpn_call(mx, cls, bb, info):
    return mx.nd.contrib.Proposal(
        cls, bb, info, rpn_pre_nms_top_n=RPN["pre"],
        rpn_post_nms_top_n=RPN["post"], threshold=RPN["thresh"],
        scales=RPN["scales"], ratios=RPN["ratios"],
        feature_stride=RPN["stride"], output_score=True)


def ssd_train(mx, S, net, anc, ctx, batches):
    """The example's steps on ``batches`` (numpy): losses, then every
    parameter and running statistic; the seconds of each step
    (synchronised)."""
    tr = S.trainer(mx, net)
    losses, secs = [], []
    for x, labels in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, l = S.train_step(mx, net, tr, anc, mx.nd.array(x, ctx=ctx),
                            mx.nd.array(labels, ctx=ctx))
        losses.append((float(c.asnumpy()), float(l.asnumpy())))
        secs.append(time.perf_counter() - t0)
    return losses, S.params_of(net), secs


def ssd_example_on_card(mx, failures):
    """``examples/ssd_detection.py`` at its own width (32 x 32 images, bs
    32, 3 classes with background, 64 anchors, Adam lr 2e-3) through
    ``tests/_torch_ssd.py``: SSD_CHECK_STEPS steps hybridized against op
    by op bit for bit from one set of weights (deterministic cuDNN),
    then the example's 40 hybridized steps (ms/step over steps 6-40)
    and its decode and score; 10 op-by-op steps timed beside them."""
    from mxnet_tpu_torch.convert import set_block_params
    S = ssd_helpers()
    ctx = mx.gpu(0)
    anc = S.anchors(mx, ctx)
    A = anc.shape[1]
    np.random.seed(0)
    seed = S.ssd_head(mx, A)
    seed.initialize(mx.init.Xavier(), ctx=mx.cpu())
    seed(mx.nd.array(S.make_batch(np.random.RandomState(9), 2)[0],
                     ctx=mx.cpu()))
    arrays = S.params_of(seed)

    def fresh(hybrid):
        net = S.ssd_head(mx, A)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        set_block_params(net, arrays, ctx=ctx)
        net.hybridize(hybrid)
        return net

    rng = np.random.RandomState(0)
    check = [S.make_batch(rng, S.BATCH) for _ in range(SSD_CHECK_STEPS)]
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = [ssd_train(mx, S, fresh(h), anc, ctx, check)
                for h in (False, True)]
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32) = flags
    (l0, p0, _), (l1, p1, _) = runs
    same = l0 == l1 and all(np.array_equal(p0[k], p1[k]) for k in p0)
    log("check SSD (examples/ssd_detection.py) %d steps hybridized vs op "
        "by op: losses %s vs %s, %d parameters and statistics bit for "
        "bit: %s  %s" % (SSD_CHECK_STEPS, json.dumps(l1), json.dumps(l0),
                         len(p0), same, "ok" if same else "FAIL"))
    if not same:
        failures.append("SSD hybridized vs op by op")
    rng = np.random.RandomState(0)      # the example's own run
    batches = [S.make_batch(rng, S.BATCH) for _ in range(S.EPOCHS)]
    net = fresh(True)
    losses, _, secs = ssd_train(mx, S, net, anc, ctx, batches)
    x, labels = S.make_batch(rng, S.EVAL_BATCH)
    dets = S.decode(mx, net, anc, mx.nd.array(x, ctx=ctx))
    iou, acc = S.evaluate(dets, labels)
    eager_secs = ssd_train(mx, S, fresh(False), anc, ctx, batches[:10])[2]
    out = {"hybridized_ms_per_step": float(np.mean(secs[5:])) * 1e3,
           "eager_ms_per_step": float(np.mean(eager_secs[2:])) * 1e3,
           "mean_iou": iou, "class_accuracy": acc,
           "first_loss": losses[0], "last_loss": losses[-1]}
    finite = bool(np.isfinite(np.array(losses)).all()) and \
        tuple(dets.shape) == (S.EVAL_BATCH, A, 6)
    log("SSD example on the card: %d steps hybridized, losses (cls, loc) "
        "%s -> %s; %.3f ms/step hybridized (steps 6-%d), %.3f op by op "
        "(steps 3-10); decode of %d images: mean IoU %.3f, class "
        "accuracy %.2f  %s"
        % (S.EPOCHS, json.dumps(losses[0]), json.dumps(losses[-1]),
           out["hybridized_ms_per_step"], S.EPOCHS,
           out["eager_ms_per_step"], S.EVAL_BATCH, iou, acc,
           "ok" if finite else "FAIL"))
    if not finite:
        failures.append("SSD example: loss not finite or decode shape")
    return out


def same_rows(name, got, want, tol, failures, exact=()):
    """``got`` (card) against ``want`` (CPU), numpy: the columns
    ``exact`` of the last axis (every element for "all") bit for bit,
    the rest within ``tol``; returns the largest error."""
    ok = got.shape == want.shape
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if ok and got.size else 0.0
    cols = range(got.shape[-1]) if exact == "all" else exact
    same = ok and all(np.array_equal(got[..., c], want[..., c])
                      for c in cols)
    ok = ok and same and err <= tol
    log("check %s, card vs CPU: %s bit for bit: %s, max_abs_err %.3e (tol "
        "%.0e)  %s" % (name, "every element" if exact == "all" else
                       "columns %s" % list(exact), same, err, tol,
                       "ok" if ok else "FAIL"))
    if not ok:
        failures.append(name + " card vs CPU")
    return err


def det_ops_main(mx, ctx):
    """One call of each detection op at SSD300 and RPN scale (the main
    path's)."""
    anc = ssd300_anchors(mx, ctx)
    lab, cls_pred, loc = ssd300_inputs(mx, ctx)
    prob = mx.nd.softmax(cls_pred, axis=1)
    tgt = mx.nd.MultiBoxTarget(anc, lab, cls_pred, negative_mining_ratio=3)
    det = mx.nd.MultiBoxDetection(prob, loc, anc, nms_threshold=0.45,
                                  nms_topk=400)
    rpn = rpn_inputs(mx, ctx)
    rois = rpn_call(mx, *rpn)
    torch.cuda.synchronize()
    return {"anc": anc, "lab": lab, "cls_pred": cls_pred, "prob": prob,
            "loc": loc, "tgt": tgt, "det": det, "rpn": rpn, "rois": rois}


def det_ops_checks(mx, io, failures):
    """The SSD300-scale ops and the RPN proposals on the card against
    their CPU path on the same inputs (2 images for the SSD ops), and
    DET_CALLS calls of each timed with CUDA events."""
    cpu = mx.cpu()

    def host(x, n=None):
        return mx.nd.array(x.asnumpy()[:n] if n else x.asnumpy(), ctx=cpu)

    anc = io["anc"]
    n_anc = anc.shape[1]
    ok = n_anc == 8732
    log("check SSD300 anchors: %d (8732 expected)  %s"
        % (n_anc, "ok" if ok else "FAIL"))
    if not ok:
        failures.append("SSD300 anchor count %d" % n_anc)
    c_anc = host(anc)
    same_rows("SSD300 MultiBoxPrior", anc.asnumpy(),
              ssd300_anchors(mx, cpu).asnumpy(), 0.0, failures, "all")
    c_tgt = mx.nd.MultiBoxTarget(c_anc, host(io["lab"], 2),
                                 host(io["cls_pred"], 2),
                                 negative_mining_ratio=3)
    errs = {}
    for k, (g, c) in enumerate(zip(io["tgt"], c_tgt)):
        errs["target_%d" % k] = same_rows(
            "SSD300 MultiBoxTarget output %d (2 images)" % k,
            g.asnumpy()[:2], c.asnumpy(), DET_BOX_TOL, failures,
            "all" if k else ())
    c_det = mx.nd.MultiBoxDetection(host(io["prob"], 2), host(io["loc"], 2),
                                    c_anc, nms_threshold=0.45, nms_topk=400)
    det = io["det"].asnumpy()
    errs["detection"] = same_rows(
        "SSD300 MultiBoxDetection (2 images)", det[:2], c_det.asnumpy(),
        DET_BOX_TOL, failures, (0,))
    kept = (det[..., 0] >= 0).sum(axis=1)
    log("info: SSD300 detections kept an image: min %d, mean %.1f, max %d "
        "(of 8732 anchors, top 400 valid into NMS)"
        % (kept.min(), kept.mean(), kept.max()))
    c_rois = rpn_call(mx, *[host(x) for x in io["rpn"]])
    errs["proposal"] = same_rows("RPN Proposal rois", io["rois"][0].asnumpy(),
                                 c_rois[0].asnumpy(), RPN_BOX_TOL, failures,
                                 (0,))
    same_rows("RPN Proposal scores", io["rois"][1].asnumpy(),
              c_rois[1].asnumpy(), 0.0, failures, "all")
    times = {
        "MultiBoxTarget": cuda_ms(lambda: mx.nd.MultiBoxTarget(
            anc, io["lab"], io["cls_pred"], negative_mining_ratio=3),
            iters=DET_CALLS),
        "MultiBoxDetection": cuda_ms(lambda: mx.nd.MultiBoxDetection(
            io["prob"], io["loc"], anc, nms_threshold=0.45,
            nms_topk=400), iters=DET_CALLS),
        "Proposal": cuda_ms(lambda: rpn_call(mx, *io["rpn"]),
                            iters=DET_CALLS)}
    log("info: detection ops at scale, ms a call (CUDA events, mean of %d): "
        "%s (SSD300: B=%d, A=8732, M=%d, %d classes; RPN %dx%d x 9 "
        "anchors, pre %d, post %d)"
        % (DET_CALLS, json.dumps(times), DET_B, DET_M, DET_CLASSES,
           RPN["H"], RPN["W"], RPN["pre"], RPN["post"]))
    return times, errs


def check_nms_kernel(NMS, failures):
    """``nms_keep`` against its plain version on the card, bit for bit:
    N = 400 (a batch of 32, ``nms_topk``'s count) and N = 8732 (2
    images), with class ids and across classes, at 0.45 and 0.7.
    Returns the count of differing keep flags (0 when right)."""
    nms_case = op_cases().nms_case
    bad = 0
    for B, N in ((32, 400), (2, 8732)):
        boxes, valid, ids = nms_case(B, N, N + B, device="cuda")
        for with_ids in (True, False):
            for thresh in (0.45, 0.7):
                cid = ids if with_ids else None
                got = NMS.nms_keep(boxes, valid, cid, thresh)
                torch.cuda.synchronize()
                want = NMS.nms_keep_reference(boxes, valid, cid, thresh)
                diff = int((got != want).sum())
                bad += diff
                log("check nms_keep B=%d N=%d ids=%s thresh %.2f: %d kept "
                    "of %d valid, %d flags differ from the plain version  "
                    "%s" % (B, N, with_ids, thresh, int(got.sum()),
                            int(valid.sum()), diff,
                            "ok" if diff == 0 else "FAIL"))
                if diff:
                    failures.append("nms_keep B=%d N=%d ids=%s"
                                    % (B, N, with_ids))
    return bad


def detection_nms_inputs(io):
    """What ``MultiBoxDetection`` hands ``nms_keep`` on the main path
    (``nms_threshold`` 0.45, ``nms_topk`` 400, per class), made again
    from the phase's own inputs by the op's helpers."""
    from mxnet_tpu_torch.ops import vision as V
    rec = V._detection_records(io["prob"]._data, io["loc"]._data,
                               io["anc"]._data, True, 0.01, 0,
                               (0.1, 0.1, 0.2, 0.2))
    _, boxes, valid, ids = V._nms_inputs(rec, 0.0, 400, 2, 1, 0, -1,
                                         "corner")
    return boxes.float(), valid, ids.float(), 0.45


def time_nms(NMS, io, flush, failures):
    """The kernel at the SSD300 detection's own inputs (B=32, N=8732,
    the top 400 valid rows an image): its keep mask against the plain
    version's flag for flag, device time, the plain version's time (one
    call, CUDA events), the byte bound (boxes, flags, class ids read
    once, the keep mask written once).  Returns the row and the count
    of differing flags."""
    boxes, valid, ids, thresh = detection_nms_inputs(io)
    B, N, _ = boxes.shape
    got = NMS.nms_keep(boxes, valid, ids, thresh)
    NMS.nms_keep_reference(boxes, valid, ids, thresh)
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    want = NMS.nms_keep_reference(boxes, valid, ids, thresh)
    e.record()
    e.synchronize()
    diff = int((got != want).sum())
    log("check nms_keep at the SSD300 detection's inputs B=%d N=%d ids=True "
        "thresh %.2f: %d kept of %d valid, %d flags differ from the plain "
        "version  %s" % (B, N, thresh, int(got.sum()), int(valid.sum()),
                         diff, "ok" if diff == 0 else "FAIL"))
    if diff:
        failures.append("nms_keep at the SSD300 detection's inputs")
    ms = device_time(lambda: NMS.nms_keep(boxes, valid, ids, thresh), flush,
                     "nms")[0]
    nbytes = B * N * (16 + 1 + (4 if ids is not None else 0) + 1)
    return {"ms": ms, "ms_from": "profiler: the two kernels' device time, "
            "mean of 20 calls, L2 flushed before each",
            "event_ms": cuda_ms(lambda: NMS.nms_keep(boxes, valid, ids,
                                                     thresh), flush=flush),
            "plain_ms": s.elapsed_time(e), "bound_ms": nbytes / PEAK_BYTES
            * 1e3, "bound_by": "bytes", "library_ms": None,
            "shape": "SSD300 MultiBoxDetection: B=%d N=%d, %d valid rows "
                     "into NMS, class ids, thresh %.2f"
                     % (B, N, int(valid.sum()), thresh)}, diff


def det_symbol(mx, failures):
    """``tests/_torch_ssd.py``'s symbol (MultiBoxPrior -> MultiBoxTarget
    and MultiBoxDetection) bound on the card at bs 32 over a 19 x 19
    map: the replayed executor against one run op by op
    (``exe._eager``), every output bit for bit."""
    S = ssd_helpers()
    ctx = mx.gpu(0)
    feed = S.ssd_symbol_inputs(seed=3, B=32, side=19)
    outs = []
    for eager in (True, False):
        args = {k: mx.nd.array(v, ctx=ctx) for k, v in feed.items()}
        exe = S.ssd_symbol(mx).bind(ctx, args)
        exe._eager = eager
        for _ in range(2):                  # the second call replays
            res = [o.asnumpy() for o in exe.forward()]
        outs.append(res)
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    log("check SSD symbol (MultiBoxPrior, MultiBoxTarget, "
        "MultiBoxDetection; bs 32, 1083 anchors) replayed vs op by op: "
        "%d outputs bit for bit: %s  %s"
        % (len(outs[0]), same, "ok" if same else "FAIL"))
    if not same:
        failures.append("SSD symbol replayed vs op by op")


def detection_path(mx, failures, flush):
    """The ``detection`` phase, every registered launch counter from 0
    around its main path (the example's SSD and decode, one call of
    each op at SSD300 and RPN scale, the bound symbol): only
    ``nms_keep`` may launch, and it must.  Then the checks against the
    CPU and the plain version and the timings, counters kept.  Returns
    (numbers, the nms row's numbers)."""
    from mxnet_tpu_torch._graphs import kept_launches
    from mxnet_tpu_torch.kernels import nms as NMS
    from mxnet_tpu_torch.kernels._counters import registered
    nums = {}
    t0 = time.perf_counter()
    for h, a in registered():
        setattr(h, a, 0)
    nums["ssd_example"] = ssd_example_on_card(mx, failures)
    io = det_ops_main(mx, mx.gpu(0))
    det_symbol(mx, failures)
    launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__), a):
                getattr(h, a) for h, a in registered()}
    nms_launches = launches.pop("nms_keep.launches")
    others = {k: v for k, v in launches.items() if v}
    log("detection path launches: nms_keep %d, the other kernels %s"
        % (nms_launches, json.dumps(others)))
    if nms_launches <= 0 or others:
        failures.append("detection path launches: nms_keep %d, others %s"
                        % (nms_launches, others))
    t_main = time.perf_counter() - t0
    with kept_launches():
        nums["ops_ms"], errs = det_ops_checks(mx, io, failures)
        bad = check_nms_kernel(NMS, failures)
        row, diff = time_nms(NMS, io, flush, failures)
        bad += diff
    nums["launches"] = nms_launches
    log("detection phase seconds: main path %.1f, checks and timings %.1f"
        % (t_main, time.perf_counter() - t0 - t_main))
    row.update(max_abs_err=float(bad), launches=nms_launches,
               op_errs=errs)
    return nums, row


# ------------------------------------------------------------------ data --
# apache/mxnet example/gluon/image_classification.py --dataset cifar10
# --model resnet18_v1 --use_thumbnail: full-width ResNet-18 with the CIFAR
# stem, CIFAR-10's train size drawn by the synthetic dataset (the files
# are not fetched), bs 128, SGD lr 0.1 momentum 0.9 wd 5e-4, f32
DATA_N, DATA_B, DATA_WORKERS = 50000, 128, 4
DATA_BATCHES = 150          # the main fit, 4 workers
DATA_VAL = 3                # validation batches, run once after the fit's last
DATA_CEILING = 60           # the same step fed from batches on the card
DATA_W0 = 30                # the same step from a loader with no workers
DATA_FROM = 10              # rates and waits over the batches after these
DATA_CHECK_STEPS = 3
DATA_PROFILE = 10           # batches in a profiled window
DATA_MEAN, DATA_STD = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
# apache/mxnet example/sparse/matrix_factorization (model.py): user and
# item Embedding(sparse_grad) -> relu -> Dense, the row-wise product
# summed; MovieLens-10M's id ranges (max_user 71569, max_movie 65135);
# factor, hidden and batch this run's choice; Adam lr 1e-3, wd 1e-5
MF = dict(users=71569, items=65135, factor=128, hidden=64, batch=1024,
          steps=100, lr=1e-3, wd=1e-5)
MF_FROM = 10
MF_PROFILE = 10             # steps in a profiled window
# a Criteo-shaped batch: 8192 rows over 1,000,000 hashed features, 13
# integer fields (columns 0-12) and 26 categorical ones, each hashed into
# its own range of the rest: 39 entries a row
CRITEO = dict(rows=8192, features=1000000, ints=13, cats=26)
SPARSE_CALLS = 20
# card vs CPU for the MF step, and dot against scipy in float64: a sum of
# k f32 products is within 2k ulp (2^-24) of |A| @ |x| of the exact sum
MF_TOL = 1e-5


class WaitTimer:
    """Iterates ``loader``, timing each ``next`` (the consumer's wait for
    the loader) and the moment each batch was handed out."""

    def __init__(self, loader):
        self.loader = loader
        self.waits = []

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


class Cycle:
    """``n`` batches, cycling through ``batches`` (already on the
    card)."""

    def __init__(self, batches, n):
        self.batches, self.n = batches, n

    def __iter__(self):
        return itertools.islice(itertools.cycle(self.batches), self.n)


def cifar_loader(mx, ds, workers, flips=True, shuffle=True):
    t = mx.gluon.data.vision.transforms
    chain = [t.ToTensor(), t.Normalize(DATA_MEAN, DATA_STD)]
    if flips:
        chain.insert(0, t.RandomFlipLeftRight())
    return mx.gluon.data.DataLoader(
        ds.transform_first(t.Compose(chain)), batch_size=DATA_B,
        shuffle=shuffle, last_batch="discard", num_workers=workers,
        pin_memory=True, timeout=120)


def resnet18_estimator(mx, arrays, hybrid):
    """The thumbnail ResNet-18 on the card with ``arrays`` as weights,
    under an Estimator with the example's SGD."""
    from mxnet_tpu_torch.convert import set_block_params
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    ctx = mx.gpu(0)
    net = mx.gluon.model_zoo.vision.get_model("resnet18_v1", classes=10,
                                              thumbnail=True)
    net.initialize(ctx=ctx)
    set_block_params(net, arrays, ctx=ctx)
    net.hybridize(hybrid)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 5e-4})
    return Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                     train_metrics=mx.metric.Accuracy(), trainer=trainer,
                     context=ctx)


def batch_clock(mx):
    """A BatchEnd handler that keeps each batch's end time, the device
    synchronised."""
    from mxnet_tpu_torch.gluon.contrib.estimator import BatchEnd

    class Clock(BatchEnd):
        def __init__(self):
            self.ends = []

        def batch_end(self, estimator, *args, **kwargs):
            torch.cuda.synchronize()
            self.ends.append(time.perf_counter())
    return Clock()


def timed_fit(mx, est, data, n, handlers=(), val_data=None):
    """``est.fit(data, val_data, batches=n)``: (images/s over the batches
    after DATA_FROM, mean ms the consumer waited on the loader there).
    The clock is the first handler, so a validation run in the last
    batch's handlers is not in the rate."""
    clock = batch_clock(mx)
    est.fit(data, val_data, batches=n,
            event_handlers=[clock] + list(handlers))
    if len(clock.ends) != n:
        raise Failed("fit ran %d batches, asked %d" % (len(clock.ends), n))
    rate = (n - DATA_FROM) * DATA_B / (clock.ends[-1] - clock.ends[DATA_FROM])
    waits = getattr(data, "waits", None)
    wait = float(np.mean(waits[DATA_FROM + 1:])) * 1e3 if waits else 0.0
    return rate, wait


def same_batches(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x.asnumpy(), y.asnumpy())
        for p, q in zip(a, b) for x, y in zip(p, q))


def estimator_path(mx, card, failures):
    """A thumbnail ResNet-18 fed by a 4-worker DataLoader through
    ``Estimator.fit``: the checks, then the main fit (checkpoint kept),
    the same step fed from the card and from a loader with no
    workers."""
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    np.random.seed(0)
    ds = mx.gluon.data.vision.CIFAR10(train=True, synthetic=True,
                                      synthetic_size=DATA_N)
    t_ds = time.perf_counter() - t0
    log("data: CIFAR-10 synthetic train set, %d images (%.1f MB of host "
        "uint8), drawn in %.1f s" % (len(ds), ds._data.size / 1e6, t_ds))
    # a deterministic pipeline: 4 workers hand out the batches of none
    plain = [cifar_loader(mx, ds, w, flips=False, shuffle=False)
             for w in (DATA_WORKERS, 0)]
    try:
        firsts = [list(itertools.islice(iter(ld), 3)) for ld in plain]
    finally:
        plain[0].close()
    pinned = all(x._data.is_pinned() for b in firsts[0] for x in b)
    same = same_batches(*firsts)
    log("check DataLoader %d workers vs none, first 3 batches of a "
        "deterministic pipeline: bit for bit %s, pinned %s  %s"
        % (DATA_WORKERS, same, pinned, "ok" if same and pinned else "FAIL"))
    if not (same and pinned):
        failures.append("DataLoader workers vs none")
    check = [[x.as_in_context(ctx) for x in b] for b in firsts[1]]
    np.random.seed(1)
    seed_net = mx.gluon.model_zoo.vision.get_model(
        "resnet18_v1", classes=10, thumbnail=True)
    seed_net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    seed_net(mx.nd.zeros((1, 3, 32, 32), ctx=mx.cpu()))
    arrays = {k: v.data().asnumpy()
              for k, v in seed_net._collect_params_with_prefix().items()}
    # DATA_CHECK_STEPS Estimator steps hybridized against op by op
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.gluon.contrib.estimator import BatchEnd

    class Losses(BatchEnd):
        def __init__(self):
            self.seen = []

        def batch_end(self, estimator, *args, **kwargs):
            self.seen.append(kwargs["loss"].asnumpy())

    runs = []
    try:
        for hybrid in (False, True):
            est = resnet18_estimator(mx, arrays, hybrid)
            losses = Losses()
            est.fit(check, batches=DATA_CHECK_STEPS, event_handlers=[losses])
            losses = losses.seen
            runs.append((losses, [p.data().asnumpy() for p in
                                  est.net.collect_params().values()]))
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.allow_tf32) = flags
    (l0, p0), (l1, p1) = runs
    same = all(np.array_equal(a, b) for a, b in zip(l0 + p0, l1 + p1))
    log("check ResNet-18 (thumbnail) %d Estimator steps hybridized vs op by "
        "op: losses and %d parameters and statistics bit for bit: %s  %s"
        % (DATA_CHECK_STEPS, len(p0), same, "ok" if same else "FAIL"))
    if not same:
        failures.append("ResNet-18 Estimator hybridized vs op by op")

    # the main path: DATA_BATCHES batches from DATA_WORKERS workers, then
    # DATA_VAL batches of the synthetic test set through the same
    # pipeline (no flips, in order) by the ValidationHandler; with
    # ``batches=`` no epoch ends, so the handler runs on a batch period
    from mxnet_tpu_torch.gluon.contrib.estimator import (CheckpointHandler,
                                                         ValidationHandler)
    tmp = tempfile.mkdtemp(prefix="data_ckpt_")
    out = {}
    val_ds = mx.gluon.data.vision.CIFAR10(
        train=False, synthetic=True, synthetic_size=DATA_VAL * DATA_B)
    try:
        est = resnet18_estimator(mx, arrays, True)
        np.random.seed(2)
        random.seed(2)
        loader = cifar_loader(mx, ds, DATA_WORKERS)
        val = cifar_loader(mx, val_ds, DATA_WORKERS, flips=False,
                           shuffle=False)
        try:
            data = WaitTimer(loader)
            t0 = time.perf_counter()
            out["images_per_s"], out["wait_ms"] = timed_fit(
                mx, est, data, DATA_BATCHES, [
                    CheckpointHandler(tmp, model_prefix="r18",
                                      batch_period=DATA_BATCHES),
                    ValidationHandler(val, est.evaluate,
                                      batch_period=DATA_BATCHES)],
                val_data=val)
            out["fit_s"] = time.perf_counter() - t0
        finally:
            loader.close()
            val.close()
        out["accuracy"] = float(est.train_metrics[0].get()[1])
        out["loss"] = float(est.train_loss_metric.get()[1])
        out["val_images"] = int(est.val_metrics[0].num_inst)
        # the synthetic test set draws its own class means (seed 43, the
        # train set 42), so its accuracy is near chance: only finite
        out["val_accuracy"] = float(est.val_metrics[0].get()[1])
        out["val_loss"] = float(est.val_loss_metric.get()[1])
        ok = out["val_images"] == DATA_VAL * DATA_B and \
            np.isfinite(out["val_loss"]) and 0 <= out["val_accuracy"] <= 1
        log("check ResNet-18 Estimator validation after %d batches: %d test "
            "images (%d expected), accuracy %.3f, loss %.4f, finite %s  %s"
            % (DATA_BATCHES, out["val_images"], DATA_VAL * DATA_B,
               out["val_accuracy"], out["val_loss"],
               bool(np.isfinite(out["val_loss"])), "ok" if ok else "FAIL"))
        if not ok:
            failures.append("ResNet-18 Estimator validation")
        # the checkpoint reloads to the same outputs
        net2 = resnet18_estimator(mx, arrays, True).net
        net2.load_parameters(os.path.join(
            tmp, "r18-batch%d.params" % DATA_BATCHES), ctx=ctx)
        x = check[0][0]
        a, b = est.net(x).asnumpy(), net2(x).asnumpy()
        same = np.array_equal(a, b)
        log("check ResNet-18 checkpoint after %d batches reloaded: outputs "
            "bit for bit %s (max |diff| %.3e)  %s"
            % (DATA_BATCHES, same, float(np.abs(a - b).max()),
               "ok" if same else "FAIL"))
        if not same:
            failures.append("ResNet-18 checkpoint reload")
        # the loader's ceiling: the same step fed from batches on the card
        out["card_images_per_s"], _ = timed_fit(
            mx, est, Cycle(check, DATA_CEILING), DATA_CEILING)
        out["profile"] = profile_window(
            lambda: est.fit(Cycle(check, DATA_PROFILE),
                            batches=DATA_PROFILE), 1,
            "ResNet-18 Estimator.fit calls of %d batches fed from the card"
            % DATA_PROFILE)
        # no workers: the consumer decodes every batch itself
        loader = cifar_loader(mx, ds, 0)
        data = WaitTimer(loader)
        out["w0_images_per_s"], out["w0_wait_ms"] = timed_fit(
            mx, est, data, DATA_W0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = out["accuracy"] > 0.1 and np.isfinite(out["loss"])
    log("data: ResNet-18 (thumbnail, CIFAR-10 shape) Estimator.fit, bs %d, "
        "f32, TF32 off, hybridized: %d workers %.1f images/s (the consumer "
        "waits %.3f ms a batch on the loader), fed from the card %.1f "
        "images/s, no workers %.1f images/s (waits %.3f ms); train "
        "accuracy after %d batches %.3f, loss %.4f (%s)  %s"
        % (DATA_B, DATA_WORKERS, out["images_per_s"], out["wait_ms"],
           out["card_images_per_s"], out["w0_images_per_s"],
           out["w0_wait_ms"], DATA_BATCHES, out["accuracy"], out["loss"],
           card, "ok" if ok else "FAIL"))
    if not ok:
        failures.append("ResNet-18 Estimator: accuracy %.3f not above "
                        "chance" % out["accuracy"])
    return out


def mf_net(mx, sparse, ctx, arrays=None):
    """The matrix-factorization net on ``ctx`` (``arrays``, by
    structural name, else drawn: Xavier, seeded)."""
    from mxnet_tpu_torch.convert import set_block_params
    nn = mx.gluon.nn

    class MFNet(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.user = nn.Embedding(MF["users"], MF["factor"],
                                         sparse_grad=sparse)
                self.user_fc = nn.Dense(MF["hidden"], in_units=MF["factor"])
                self.item = nn.Embedding(MF["items"], MF["factor"],
                                         sparse_grad=sparse)
                self.item_fc = nn.Dense(MF["hidden"], in_units=MF["factor"])

        def hybrid_forward(self, F, user, item):
            u = self.user_fc(F.relu(self.user(user)))
            i = self.item_fc(F.relu(self.item(item)))
            return F.sum(u * i, axis=1)

    net = MFNet(prefix="mf_")
    if arrays is None:
        np.random.seed(3)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
    else:
        net.initialize(ctx=ctx)
        set_block_params(net, arrays, ctx=ctx)
    return net


def mf_batches(mx, ctx, n, seed=4):
    """(user ids, item ids, ratings 1-5) on ``ctx``, from a seed."""
    rng = np.random.RandomState(seed)
    return [tuple(mx.nd.array(a, ctx=ctx) for a in (
        rng.randint(0, MF["users"], MF["batch"]).astype(np.float32),
        rng.randint(0, MF["items"], MF["batch"]).astype(np.float32),
        rng.randint(1, 6, MF["batch"]).astype(np.float32)))
        for _ in range(n)]


def mf_state(net, trainer):
    """Each parameter with its Adam mean and variance (host copies)."""
    out = {}
    for i, p in enumerate(net.collect_params().values()):
        mean, var = trainer._updater.states[i]
        out[p.name] = (p.data().asnumpy(), mean.asnumpy(), var.asnumpy())
    return out


def mf_step(mx, net):
    """(a step of ``net`` on one batch under Adam, its Trainer)."""
    loss_fn = mx.gluon.loss.L2Loss()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", {
        "learning_rate": MF["lr"], "wd": MF["wd"]})

    def step(u, i, r):
        with mx.autograd.record():
            loss = loss_fn(net(u, i), r)
        loss.backward()
        trainer.step(MF["batch"])
    return step, trainer


def mf_run(mx, net, batches, spy=None, watch=None):
    """Adam over ``batches``: (ms a step over the steps after MF_FROM,
    the step, the state after step 1, and for step ``watch`` the user
    table's (rows of the step's gradient, state before, state
    after))."""
    step, trainer = mf_step(mx, net)
    user = net.user.weight
    ends, first, seen = [], None, None
    for s, (u, i, r) in enumerate(batches):
        if s == watch:
            before = mf_state(net, trainer)[user.name]
        step(u, i, r)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        if spy is not None:
            spy["steps"] += 1
        if s == 0:
            first = mf_state(net, trainer)
        if s == watch:
            g = user.grad().asnumpy()
            seen = (np.nonzero(np.abs(g).reshape(len(g), -1).max(1))[0],
                    before, mf_state(net, trainer)[user.name])
    ms = (ends[-1] - ends[MF_FROM]) * 1e3 / (len(ends) - 1 - MF_FROM)
    return ms, step, first, seen


def close_state(got, want, grads):
    """Card against CPU after one Adam step, each tensor within MF_TOL x
    its own largest CPU magnitude (a tensor of exact zeros: within the
    least normal f32), so the moments, which carry the gradient's scale
    (m = 0.1 g, v = 0.001 g^2 after one step), are held to it; an
    element whose CPU gradient is rounding noise (below 1e-6 of its
    tensor's largest) may differ by 2 lr in the weight, as Adam moves
    such an element by about lr whatever its size.  Returns (largest
    |diff| / tol, noise-level elements apart, the tensors out of
    tolerance)."""
    worst, noisy, wrong = 0.0, 0, []
    for k, (w, m, v) in want.items():
        for a, b, tag in zip(got[k], (w, m, v), ("w", "m", "v")):
            d = np.abs(a.astype(np.float64) - b)
            tol = max(MF_TOL * float(np.abs(b).max()),
                      float(np.finfo(np.float32).tiny))
            bad = d > tol
            if bad.any() and tag == "w":
                g = np.abs(grads[k])
                noise = g < 1e-6 * g.max()
                noisy += int((bad & noise).sum())
                bad &= ~(noise & (d <= 2 * MF["lr"]))
            if bad.any():
                wrong.append("%s.%s" % (k, tag))
            worst = max(worst, float((d / tol).max()))
    return worst, noisy, wrong


def mf_path(mx, card, failures):
    """Matrix factorization with row-sparse gradients: lazy Adam
    (hybridized) for MF steps, one step held against the CPU, the rows
    outside a step's gradient held bit for bit; then dense Adam on the
    same net, the comparator."""
    from mxnet_tpu_torch.ndarray import sparse as SP
    ctx = mx.gpu(0)
    arrays = {k: v.data().asnumpy() for k, v in
              mf_net(mx, True, None)._collect_params_with_prefix().items()}
    batches = mf_batches(mx, ctx, MF["steps"])
    spy = {"reads": 0, "rows": 0, "steps": 0}
    orig = SP._host

    def counting(t):
        out = orig(t)
        spy["reads"] += 1
        if out.dtype == np.bool_:
            spy["rows"] += int(out.sum())
        return out

    SP._host = counting
    try:
        lazy = mf_net(mx, True, ctx, arrays)
        lazy.hybridize()
        ms_lazy, step_l, first, seen = mf_run(mx, lazy, batches, spy,
                                              watch=50)
    finally:
        SP._host = orig
    dense = mf_net(mx, False, ctx, arrays)
    dense.hybridize()
    ms_dense, step_d, _, seen_d = mf_run(mx, dense, batches, watch=50)
    profiles = {}
    for tag, stp in (("lazy", step_l), ("dense", step_d)):
        feed = itertools.cycle(batches)
        profiles[tag] = profile_window(lambda: stp(*next(feed)), MF_PROFILE,
                                       "MF %s Adam steps" % tag)
    # one step on the CPU from the same weights and batch; then, as the
    # check's own control, the CPU step with its gradient doubled (half
    # the batch size in ``step``, so twice ``rescale_grad``), which the
    # check must refuse
    u, i, r = (x.as_in_context(mx.cpu()) for x in batches[0])
    loss_fn = mx.gluon.loss.L2Loss()
    cpu_states = []
    for scale in (1, 2):
        cpu = mf_net(mx, True, mx.cpu(), arrays)
        trainer = mx.gluon.Trainer(cpu.collect_params(), "adam", {
            "learning_rate": MF["lr"], "wd": MF["wd"]})
        with mx.autograd.record():
            loss = loss_fn(cpu(u, i), r)
        loss.backward()
        grads = {p.name: p.grad().asnumpy()
                 for p in cpu.collect_params().values()}
        trainer.step(MF["batch"] / scale)
        cpu_states.append((mf_state(cpu, trainer), grads))
    err, noisy, wrong = close_state(first, *cpu_states[0])
    log("check MF lazy Adam, one step card vs CPU: largest |diff| / tol "
        "%.3f, noise-level elements apart %d, tensors out of tolerance %s"
        "  %s" % (err, noisy, wrong, "FAIL" if wrong else "ok"))
    if wrong:
        failures.append("MF lazy Adam card vs CPU: %s" % wrong)
    err2, _, caught = close_state(first, *cpu_states[1])
    log("check MF card vs CPU with the CPU's gradient x2, which the check "
        "must refuse: largest |diff| / tol %.3f, tensors out of tolerance "
        "%d of %d  %s" % (err2, len(caught), 3 * len(cpu_states[1][0]),
                          "ok" if caught else "FAIL"))
    if not caught:
        failures.append("MF card-vs-CPU check passed a gradient x2")
    # rows outside step 50's gradient rows: kept by lazy, moved by dense
    rows, before, after = seen
    rest = np.setdiff1d(np.arange(MF["users"]), rows)
    kept = all(np.array_equal(a[rest], b[rest])
               for a, b in zip(before, after))
    moved = all(np.array_equal(a[rows], b[rows]) is False
                for a, b in zip(before, after))
    _, bd, ad = seen_d
    dense_moved = int((bd[0][rest] != ad[0][rest]).any(1).sum())
    ok = kept and moved and dense_moved >= 0.99 * len(rest)
    log("check MF lazy Adam, step 51: %d gradient rows of %d users; the "
        "other %d rows' weights, means and variances bit for bit %s; "
        "dense Adam moved %d of them  %s"
        % (len(rows), MF["users"], len(rest), kept, dense_moved,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("MF lazy rows")
    out = {"lazy_ms": ms_lazy, "dense_ms": ms_dense,
           "rows_a_step": spy["rows"] / spy["steps"],
           "host_reads_a_step": spy["reads"] / spy["steps"],
           "card_vs_cpu": err, "card_vs_cpu_grad_x2": err2,
           "profiles": profiles}
    log("data: MF (MovieLens-10M ids, factor %d, hidden %d, bs %d), Adam, "
        "hybridized: lazy %.3f ms a step, dense %.3f ms a step; %.1f rows "
        "touched a step (user and item tables), %.1f host reads a step "
        "(%s)" % (MF["factor"], MF["hidden"], MF["batch"], ms_lazy,
                  ms_dense, out["rows_a_step"], out["host_reads_a_step"],
                  card))
    return out


def criteo_csr(rng):
    C = CRITEO
    n, span = C["rows"], (C["features"] - C["ints"]) // C["cats"]
    ints = np.log1p(rng.poisson(8.0, (n, C["ints"]))).astype(np.float32)
    cats = C["ints"] + np.arange(C["cats"]) * span + rng.randint(
        0, span, (n, C["cats"]))
    cols = np.concatenate([np.tile(np.arange(C["ints"]), (n, 1)), cats], 1)
    vals = np.concatenate([ints, np.ones((n, C["cats"]), np.float32)], 1)
    nnz = C["ints"] + C["cats"]
    return vals.ravel(), cols.ravel().astype(np.int32), \
        np.arange(0, n * nnz + 1, nnz, dtype=np.int32)


def host_ms(fn, calls=SPARSE_CALLS):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def sparse_path(mx, card, failures):
    """``dot(csr, w)``, ``dot(csr.T, g)`` and a lazy ``sgd_update`` at
    Criteo's shape on the card, against scipy and numpy on the host."""
    import scipy.sparse as sps
    from mxnet_tpu_torch.ndarray import sparse as SP
    ctx = mx.gpu(0)
    rng = np.random.RandomState(5)
    vals, cols, indptr = criteo_csr(rng)
    shape = (CRITEO["rows"], CRITEO["features"])
    A = sps.csr_matrix((vals, cols, indptr), shape=shape)
    csr = SP.csr_matrix((vals, cols, indptr), shape=shape, ctx=ctx)
    w_np = (0.01 * rng.randn(CRITEO["features"], 1)).astype(np.float32)
    g_np = rng.randn(CRITEO["rows"], 1).astype(np.float32)
    w = mx.nd.array(w_np, ctx=ctx)
    g = mx.nd.array(g_np, ctx=ctx)
    absA = abs(A).astype(np.float64)
    # dot(csr, w) against scipy in float64
    y = SP.dot(csr, w).asnumpy()
    want = A.astype(np.float64) @ w_np.astype(np.float64)
    lim = 2 * (CRITEO["ints"] + CRITEO["cats"]) * 2.0 ** -24 * (
        absA @ np.abs(w_np.astype(np.float64)))
    ok1 = y.shape == want.shape and bool((np.abs(y - want) <= lim).all())
    # dot(csr.T, g): row_sparse over the columns that occur
    gr = SP.dot(csr, g, transpose_a=True)
    ids = gr.indices.asnumpy().astype(np.int64)
    occur = np.unique(cols)
    want_t = (A.T.astype(np.float64) @ g_np.astype(np.float64))[occur]
    counts = np.bincount(cols, minlength=CRITEO["features"])[occur]
    lim_t = 2 * counts[:, None] * 2.0 ** -24 * (
        absA.T @ np.abs(g_np.astype(np.float64)))[occur]
    got_t = gr.data.asnumpy()
    ok2 = gr.stype == "row_sparse" and np.array_equal(ids, occur) and \
        bool((np.abs(got_t - want_t) <= lim_t).all())
    # the lazy SGD update of w with that gradient against numpy in f32
    lr, wd = 0.1, 1e-4
    w_ref = w_np.copy()
    wr = w_ref[occur]
    w_ref[occur] = wr - lr * (got_t + wd * wr)
    SP.sgd_update(w, gr, lr=lr, wd=wd)
    ok3 = np.array_equal(w.asnumpy(), w_ref)
    ms = {"dot": host_ms(lambda: SP.dot(csr, w)),
          "dot_t": host_ms(lambda: SP.dot(csr, g, transpose_a=True)),
          "sgd_update": host_ms(lambda: SP.sgd_update(w, gr, lr=lr,
                                                      wd=wd))}
    ok = ok1 and ok2 and ok3
    log("check sparse ops at Criteo's shape (csr %d x %d, %d entries; %d "
        "columns occur): dot(csr, w) within 2k ulp of scipy %s; "
        "dot(csr.T, g) row_sparse, its ids those of scipy and values "
        "within 2k ulp %s; lazy sgd_update = numpy bit for bit %s  %s"
        % (shape[0], shape[1], len(vals), len(occur), ok1, ok2, ok3,
           "ok" if ok else "FAIL"))
    if not ok:
        failures.append("sparse ops at Criteo's shape")
    log("data: sparse ops at Criteo's shape, ms a call (host clock, "
        "synchronised, mean of %d): dot(csr, w) %.3f, dot(csr.T, g) %.3f "
        "(its ids read to the host), lazy sgd_update over %d rows %.3f "
        "(%s)" % (SPARSE_CALLS, ms["dot"], ms["dot_t"], len(occur),
                  ms["sgd_update"], card))
    return ms


def data_path(mx, card, failures):
    """The ``data`` phase: every registered launch counter from 0, and
    still 0 after (no hand-written kernel is on these paths)."""
    from mxnet_tpu_torch.kernels._counters import registered
    t0 = time.perf_counter()
    for h, a in registered():
        setattr(h, a, 0)
    out = {"estimator": estimator_path(mx, card, failures)}
    gc.collect()
    torch.cuda.empty_cache()
    out["mf"] = mf_path(mx, card, failures)
    gc.collect()
    torch.cuda.empty_cache()
    out["sparse_ms"] = sparse_path(mx, card, failures)
    launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__), a):
                getattr(h, a) for h, a in registered()}
    others = {k: v for k, v in launches.items() if v}
    log("data path launches: %s" % (json.dumps(others) if others
                                    else "every counter 0"))
    if others:
        failures.append("data path launches: %s" % others)
    out["seconds"] = time.perf_counter() - t0
    log("data phase seconds: %.1f" % out["seconds"])
    return out


def synth_photo(i, dev):
    """Image ``i`` of the phase's data, (h, w, 3) uint8 on ``dev``: a
    smooth colour field with a disc, a bar (edges) and mild texture (a
    photo's statistics, not white noise), 480 x 640 or 640 x 480."""
    g = np.random.RandomState(1000 + i)
    h, w = (IMG_SHORT, IMG_LONG) if g.rand() < 0.5 else (IMG_LONG, IMG_SHORT)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    chans = []
    for _ in range(3):
        fy, fx = g.uniform(0.004, 0.04, 2).tolist()
        ph = float(g.uniform(0, 6))
        chans.append(128 + 80 * torch.sin(xx * fx + ph) * torch.cos(yy * fy))
    img = torch.stack(chans, -1)
    cy, cx = g.uniform(0.2, 0.8) * h, g.uniform(0.2, 0.8) * w
    disc = (yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) / 4) ** 2
    img[disc] = torch.tensor(g.uniform(150, 250, 3), device=dev,
                             dtype=torch.float32)
    x0 = int(g.randint(0, w // 2))
    img[:, x0:x0 + w // 12] = torch.tensor(g.uniform(0, 60, 3), device=dev,
                                           dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(i)
    img += torch.randn(img.shape, device=dev, generator=gen) * 3.0
    return img.clamp(0, 255).to(torch.uint8)


def image_records(mx, codec, dev, tmp):
    """Encode IMG_N images with nvJPEG (quality IMG_Q, 4:2:0) and pack
    them with the port's recordio: (rec, idx, jpeg bytes, seconds)."""
    t0 = time.perf_counter()
    rec, idx = os.path.join(tmp, "img.rec"), os.path.join(tmp, "img.idx")
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    nbytes = 0
    for i in range(IMG_N):
        blob = codec.encode(synth_photo(i, dev), IMG_Q, 420)
        nbytes += len(blob)
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(i % RESNET_CLASSES), i, 0), blob))
    w.close()
    return rec, idx, nbytes, time.perf_counter() - t0


def check_decode(mx, codec, failures):
    """The card's decode against libjpeg's pixels of the fixtures, in full
    and at 1/2 scale (the pipeline's DCT scaling: jpeg_color's plane box
    averages, for every layout).  Returns the largest mean and max
    differences of each."""
    ref = np.load(os.path.join(IMG_FIXTURES, "pixels.npz"))
    names = sorted(f[:-4] for f in os.listdir(IMG_FIXTURES)
                   if f.endswith(".jpg"))
    worst = {"full": [0.0, 0], "half": [0.0, 0]}
    for name in names:
        with open(os.path.join(IMG_FIXTURES, name + ".jpg"), "rb") as f:
            blob = f.read()
        got = codec.decode([blob])[0]
        buf, sizes = codec.decode_batch([blob], denoms=[2])
        half = buf.view(sizes[0][0], sizes[0][1], 3)
        for tag, a, b, lim in (
                ("full", got, ref["full_" + name], (DECODE_MEAN, DECODE_MAX)),
                ("half", half, ref["half_" + name], (HALF_MEAN, HALF_MAX))):
            a = a.cpu().numpy().astype(np.int64)
            if a.shape != b.shape:
                failures.append("card decode %s %s shape %s vs %s"
                                % (name, tag, a.shape, b.shape))
                continue
            d = np.abs(a - b)
            mean_c = [float((a[..., c] - b[..., c]).mean()) for c in range(3)]
            ok = d.mean() <= lim[0] and d.max() <= lim[1]
            log("check card decode %-15s %s vs libjpeg (OpenCV): mean |diff| "
                "%.3f (limit %.2f), max %d (limit %d), mean signed diff by "
                "channel %s  %s"
                % (name, tag, d.mean(), lim[0], d.max(), lim[1],
                   " ".join("%+.3f" % v for v in mean_c),
                   "ok" if ok else "FAIL"))
            if not ok:
                failures.append("card decode %s %s vs libjpeg" % (name, tag))
            w = worst[tag]
            w[0], w[1] = max(w[0], float(d.mean())), max(w[1], int(d.max()))
    return worst


def check_image_aug(mx, IA, rec, idx, blobs, failures):
    """image_aug against its plain version on the card, bit for bit, on
    two batches of ``blobs`` decoded and planned as ImageRecordIter's card
    route does them (``decode``: DCT-scaled on the random-crop path;
    ``table``: its crops and flips) under each case.  Returns (max
    |error|, the main path's first batch: buffer, sizes, table)."""
    cases = [("main: rand_crop, mirror, DCT", {}),
             ("centre crop, no mirror", dict(rand_crop=False,
                                             rand_mirror=False)),
             ("resize=256", dict(resize=256)),
             ("NHWC, no DCT scaling", dict(layout="NHWC", dct_scale=False))]
    F = {n: i for i, n in enumerate(IA.FIELDS)}
    err, main = 0.0, None
    for tag, kw in cases:
        impl = image_iter(mx, rec, idx, mx.gpu(0), **kw)._py
        for k in range(2):
            buf, sizes = impl.decode(blobs[k * IMG_B:(k + 1) * IMG_B])
            table = impl.table(sizes).to(buf.device)
            args = (IMG_SHAPE, impl.mean, impl.std, impl.scale, impl.layout)
            a = IA.image_aug(buf, table, *args)
            b = IA.image_aug_reference(buf, table, *args)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            e = float((a - b).abs().max())
            err = max(err, e)
            up = int((table[:, F["uh"]] != table[:, F["rh"]]).sum()
                     + (table[:, F["uw"]] != table[:, F["rw"]]).sum())
            log("check image_aug %-29s batch %d (%d images decoded at %s, "
                "%d resized up): bit for bit %s, max_abs_err %.3e  %s"
                % (tag, k, len(sizes), sorted(set(sizes))[:3], up, same, e,
                   "ok" if same else "FAIL"))
            if not same:
                failures.append("image_aug %s batch %d" % (tag, k))
            if main is None:
                main = (buf, sizes, table)
    return err, main


def check_jpeg_color(JC, codec, blobs, failures):
    """jpeg_color against its plain version on the card, bit for bit, on
    the planes nvJPEG decodes from ``blobs``.  Returns (max |error|, the
    planes, the table on the card, the output size, the largest image)."""
    infos = [codec.info(b) for b in blobs]
    err, main = 0.0, None
    for denom in (1, 2, 4):
        scratch, table = codec.decode_planes(blobs, infos,
                                             denoms=[denom] * len(blobs))
        outs = [JC.out_size(inf[0], inf[1], denom) for inf in infos]
        n_out = sum(h * w * 3 for h, w in outs)
        big = max(h * w for h, w in outs)
        table = table.to(scratch.device)
        a = JC.jpeg_color(scratch, table, torch.zeros(
            n_out, dtype=torch.uint8, device=scratch.device), max_pixels=big)
        b = JC.jpeg_color_reference(scratch, table, torch.zeros(
            n_out, dtype=torch.uint8, device=scratch.device))
        torch.cuda.synchronize()
        same = torch.equal(a, b)
        e = float((a.int() - b.int()).abs().max())
        err = max(err, e)
        kinds = sorted(set(table[:, 7].tolist()))
        log("check jpeg_color %d images (layouts %s, scale 1/%d, planes "
            "%.1f MB): bit for bit %s, max_abs_err %.0f  %s"
            % (len(blobs), kinds, denom, scratch.numel() / 1e6, same, e,
               "ok" if same else "FAIL"))
        if not same:
            failures.append("jpeg_color 1/%d" % denom)
        if denom == 2:          # the main path's: DCT scaling by 2
            main = (scratch, table, n_out, big)
    return (err,) + main


def time_jpeg_color(JC, scratch, table, n_out, big, flush):
    """jpeg_color's device time on a batch's planes, its plain version's
    and its bound (the planes read once, the RGB written once)."""
    out = torch.empty(n_out, dtype=torch.uint8, device=scratch.device)
    ms, _ = device_time(lambda: JC.jpeg_color(scratch, table, out,
                                              max_pixels=big),
                        flush, match="jpeg_color")
    plain = cuda_ms(lambda: JC.jpeg_color_reference(scratch, table, out),
                    iters=3)
    bound_ms, by = bound(scratch.numel() + table.numel() * 8 + n_out, 0,
                         torch.float32)
    log("jpeg_color at bs %d (planes %.1f MB, RGB %.1f MB): %.4f ms, plain "
        "%.2f ms, bound %.4f ms (%s)"
        % (table.shape[0], scratch.numel() / 1e6, n_out / 1e6, ms, plain,
           bound_ms, by))
    return {"name": "jpeg_color", "route": "cuda",
            "source": "mxnet_tpu_torch/kernels/csrc/jpeg_color.cu",
            "replaces": "none: the reference decodes with libjpeg on the "
                        "host (mxnet_tpu/image/image.py:32-48, "
                        "native/src/image_loader.cc:50-90), no pallas_call",
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None,
            "shape": "bs %d 4:2:0 JPEG planes at scale 1/2 (the main "
                     "path's DCT scaling) -> interleaved RGB"
                     % table.shape[0],
            "tolerance": "bit for bit"}


def image_iter(mx, rec, idx, ctx, **kw):
    """The main path's ImageRecordIter (``kw`` overrides its options)."""
    opts = dict(path_imgrec=rec, path_imgidx=idx, data_shape=IMG_SHAPE,
                batch_size=IMG_B, shuffle=True, rand_crop=True,
                rand_mirror=True, mean_r=IMG_MEAN[0], mean_g=IMG_MEAN[1],
                mean_b=IMG_MEAN[2], std_r=IMG_STD[0], std_g=IMG_STD[1],
                std_b=IMG_STD[2], ctx=ctx)
    opts.update(kw)
    return mx.io.ImageRecordIter(**opts)


def pipeline_alone(mx, rec, idx, codec):
    """ImageRecordIter on the card alone: images/s over IMG_ALONE
    batches after one warm batch, ms a batch of reading, decoding and
    augmenting apart (those calls made by hand, their launches not
    counted), and a profiled window's busy share."""
    from mxnet_tpu_torch._graphs import kept_launches
    from mxnet_tpu_torch.kernels import image_aug as IA
    it = image_iter(mx, rec, idx, mx.gpu(0))
    b = it.next()
    torch.cuda.synchronize()
    d = b.data[0]
    if tuple(d.shape) != (IMG_B,) + IMG_SHAPE or \
            not bool(torch.isfinite(d._data).all()):
        raise Failed("ImageRecordIter on the card gave %s" % (d.shape,))
    t0 = time.perf_counter()
    for _ in range(IMG_ALONE):
        b = it.next()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = {"images_per_s": IMG_B * IMG_ALONE / sec,
           "ms_per_batch": sec * 1e3 / IMG_ALONE}
    # the stages apart: host reads, then the decode (nvJPEG and
    # jpeg_color) and the augment timed by CUDA events around each (the
    # host's part of a decode, headers and nvJPEG's parsing, is inside its
    # events)
    impl = it._py
    impl.reset()
    t0 = time.perf_counter()
    got = [impl.read_batch() for _ in range(4)]
    out["read_ms"] = (time.perf_counter() - t0) * 1e3 / 4
    dec, aug = [], []
    with kept_launches():
        for blobs, _, _ in got:
            e0, e1, e2, e3 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(4))
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            e0.record()
            buf, sizes = impl.decode(blobs)
            e1.record()
            table = impl.table(sizes).to(codec.device)
            e2.record()
            IA.image_aug(buf, table, IMG_SHAPE, IMG_MEAN, IMG_STD)
            e3.record()
            e3.synchronize()
            dec.append((e0.elapsed_time(e1), time.perf_counter() - h0))
            aug.append(e2.elapsed_time(e3))
    out["decode_ms"] = float(np.mean([x for x, _ in dec]))
    out["augment_ms"] = float(np.mean(aug))
    out["decode_images_per_s"] = IMG_B * 1e3 / out["decode_ms"]
    out["profile"] = profile_window(it.next, IMG_PROFILE,
                                    "ImageRecordIter batches on the card")
    log("image pipeline alone (ImageRecordIter on the card, bs %d, %s, "
        "random crops and flips): %.1f images/s, %.2f ms a batch; stages: "
        "read %.2f ms, nvJPEG decode %.2f ms (%.1f images/s; %s backend, "
        "%s), image_aug %.3f ms; %s"
        % (IMG_B, IMG_SHAPE, out["images_per_s"], out["ms_per_batch"],
           out["read_ms"], out["decode_ms"], out["decode_images_per_s"],
           codec.backend, json.dumps(codec.stats), out["augment_ms"],
           card_line()))
    return out


def full_path(mx, rec, idx, tr, resident, failures):
    """DevicePrefetchIter(super_size=BENCH_STEPS) over ImageRecordIter on
    the card (a ResizeIter loops the 16-batch epoch) into the s2d
    trainer's run_steps: images/s over IMG_SUPERS superbatches, timed
    after a warm one and IMG_DRAIN more (the superbatches the worker
    filled ahead while the warm one trained), the consumer's wait a
    superbatch, a profiled superbatch, the loss."""
    n = (1 + IMG_DRAIN + IMG_SUPERS + 1) * BENCH_STEPS
    it = mx.io.DevicePrefetchIter(
        mx.io.ResizeIter(image_iter(mx, rec, idx, mx.gpu(0)), n),
        super_size=BENCH_STEPS, ctx=mx.gpu(0))
    losses, waits = [], []

    def one():
        t = time.perf_counter()
        b = it.next()
        waits.append(time.perf_counter() - t)
        losses.extend(tr.run_steps(b.data[0], b.label[0]).asnumpy().tolist())

    try:
        for _ in range(1 + IMG_DRAIN):  # warm, then the queue's credit
            one()
        torch.cuda.synchronize()
        waits.clear()
        t0 = time.perf_counter()
        for _ in range(IMG_SUPERS):
            one()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        prof = profile_window(one, 1, "the full image path, one superbatch "
                              "of %d run_steps steps" % BENCH_STEPS)
    finally:
        it.close()
    ips = IMG_SUPERS * BENCH_STEPS * IMG_B / sec
    out = {"images_per_s": ips, "resident_images_per_s": resident,
           "wait_ms_per_super": [w * 1e3 for w in waits[:IMG_SUPERS]],
           "superbatches_timed": IMG_SUPERS,
           "profile": prof, "losses": losses[::BENCH_STEPS] + losses[-1:]}
    log("image full path (ImageRecordIter -> DevicePrefetchIter(super_size="
        "%d) -> ResNet-50 s2d amp run_steps, bs %d; %d superbatches timed "
        "after %d untimed): %.1f images/s against %.1f resident-batch "
        "images/s in this call; the consumer waits %s ms a superbatch; "
        "losses %s; %s"
        % (BENCH_STEPS, IMG_B, IMG_SUPERS, 1 + IMG_DRAIN, ips, resident,
           " ".join("%.1f" % w for w in out["wait_ms_per_super"]),
           " ".join("%.4f" % v for v in out["losses"]), card_line()))
    first = float(np.mean(losses[:BENCH_STEPS]))
    last = float(np.mean(losses[-BENCH_STEPS:]))
    log("check image full path: loss finite %s, mean of the first "
        "superbatch %.4f, of the last %.4f (must fall)  %s"
        % (bool(np.isfinite(losses).all()), first, last,
           "ok" if np.isfinite(losses).all() and last < first else "FAIL"))
    if not (np.isfinite(losses).all() and last < first):
        failures.append("image full path losses %s" % out["losses"])
    return out


def host_route(mx, rec, idx):
    """Information: the CPU route's loader (the native copy) where the
    machine has libjpeg's and libpng's headers; else which are missing."""
    from mxnet_tpu_torch import native
    missing = [h for h in ("jpeglib.h", "png.h")
               if not os.path.exists(os.path.join("/usr/include", h))]
    if not native.available():
        log("info: host route (native libjpeg loader): not built here, "
            "missing headers %s" % (missing or "none (see native.build_log)"))
        return {"missing_headers": missing}
    it = image_iter(mx, rec, idx, mx.cpu(),
                    preprocess_threads=os.cpu_count() or 1)
    it.next()
    t0 = time.perf_counter()
    for _ in range(4):
        it.next()
    ips = 4 * IMG_B / (time.perf_counter() - t0)
    log("info: host route (native libjpeg loader, %d threads): %.1f "
        "images/s" % (os.cpu_count() or 1, ips))
    return {"images_per_s": ips}


def image_path(mx, tr, resident, failures, flush):
    """The ``image`` phase: the records, the decode and kernel checks
    (counters kept), then, every registered counter from 0, the pipeline
    alone and the full path; only ``image_aug`` and ``jpeg_color`` may
    launch, and both must.  Returns
    (numbers, the kernels-line rows of image_aug and jpeg_color)."""
    from mxnet_tpu_torch._graphs import kept_launches
    from mxnet_tpu_torch.image import _nvjpeg
    from mxnet_tpu_torch.kernels import image_aug as IA
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    from mxnet_tpu_torch.kernels._counters import registered
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    codec = _nvjpeg.decoder(dev)
    out = {"backend": codec.backend,
           "hardware_status": codec.hardware_status}
    log("info: nvJPEG batched backend %s (creating the hardware backend "
        "returned nvjpegStatus_t %d)" % (codec.backend,
                                         codec.hardware_status))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_image_")
    parts = {}
    try:
        rec, idx, nbytes, sec = image_records(mx, codec, dev, tmp)
        parts["records"] = sec
        out["records"] = {"n": IMG_N, "mean_bytes": nbytes / IMG_N,
                          "seconds": sec}
        log("image records: %d JPEGs (q %d, 4:2:0, short side %d), mean "
            "%.1f KB, encoded and packed in %.1f s"
            % (IMG_N, IMG_Q, IMG_SHORT, nbytes / IMG_N / 1e3, sec))
        with kept_launches():
            out["decode_check"] = check_decode(mx, codec, failures)
            # two batches' records; the second holds one image smaller
            # than the crop (a fixture), to take the resize-up
            R = mx.recordio.MXIndexedRecordIO(idx, rec, "r")
            blobs = [mx.recordio.unpack(R.read_idx(i))[1]
                     for i in range(2 * IMG_B)]
            R.close()
            with open(os.path.join(IMG_FIXTURES, "q95_420_96x80.jpg"),
                      "rb") as f:
                blobs[-1] = f.read()
            err, (buf, sizes, table) = check_image_aug(mx, IA, rec, idx,
                                                       blobs, failures)
            jc = check_jpeg_color(JC, codec, blobs[:IMG_B], failures)
            jc_row = time_jpeg_color(JC, *jc[1:], flush)
            jc_row["max_abs_err"] = jc[0]
            row = time_image_aug(IA, buf, table, sizes, flush)
        parts["checks"] = time.perf_counter() - t_start - sum(parts.values())
        for h, a in registered():
            setattr(h, a, 0)
        single = codec.stats["single"]
        out["alone"] = pipeline_alone(mx, rec, idx, codec)
        parts["alone"] = time.perf_counter() - t_start - sum(parts.values())
        tr._eager = False
        out["full"] = full_path(mx, rec, idx, tr, resident, failures)
        parts["full"] = time.perf_counter() - t_start - sum(parts.values())
        single = codec.stats["single"] - single
        log("check image path decodes batched: %d images decoded alone "
            "(outside a batched nvJPEG call) on the main path, %s  %s"
            % (single, json.dumps(codec.stats), "ok" if not single
               else "FAIL"))
        if single:
            failures.append("image path: %d images decoded alone" % single)
        launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__), a):
                    getattr(h, a) for h, a in registered()}
        others = {k: v for k, v in launches.items() if v and k not in (
            "image_aug.launches", "jpeg_color.launches")}
        log("image path launches: %s" % json.dumps(
            {k: v for k, v in launches.items() if v}))
        if others:
            failures.append("image path launches: %s" % others)
        for name, fn in (("image_aug", IA.image_aug),
                         ("jpeg_color", JC.jpeg_color)):
            if fn.launches <= 0:
                raise Failed("%s was never launched on the image path"
                             % name)
        out["host_route"] = host_route(mx, rec, idx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row.update(launches=IA.image_aug.launches, max_abs_err=err)
    jc_row["launches"] = JC.jpeg_color.launches
    out["seconds"] = time.perf_counter() - t_start
    log("image phase seconds: %.1f (%s)" % (out["seconds"], ", ".join(
        "%s %.1f" % kv for kv in parts.items())))
    return out, [row, jc_row]


def _taps(o, n, on):
    """The source rows (or columns) the native ResizeBilinear of ``n`` to
    ``on`` reads for outputs ``o``: both taps of each, as image_aug.cu's
    ``taps`` takes them."""
    f = (o.astype(np.float32) + np.float32(0.5)) \
        * (np.float32(n) / np.float32(on)) - np.float32(0.5)
    a = np.floor(f).astype(np.int64)
    return np.unique(np.concatenate([np.maximum(a, 0),
                                     np.minimum(a + 1, n - 1)]))


def crop_read_bytes(IA, table):
    """The bytes of the decoded batch that image_aug must read: for each
    image the pixels its crop window reaches through the resize stages
    the table plans (3 bytes each)."""
    _, H, W = IMG_SHAPE
    total = 0
    for r in table.tolist():
        t = dict(zip(IA.FIELDS, r))
        ys = np.arange(t["y0"], t["y0"] + H)
        xs = np.arange(t["x0"], t["x0"] + W)
        for (nh, nw), (oh, ow) in ((("rh", "rw"), ("uh", "uw")),
                                   (("h", "w"), ("rh", "rw"))):
            if (t[nh], t[nw]) != (t[oh], t[ow]):
                ys, xs = _taps(ys, t[nh], t[oh]), _taps(xs, t[nw], t[ow])
        total += len(ys) * len(xs) * 3
    return total


def time_image_aug(IA, buf, table, sizes, flush):
    """image_aug's device time on the main path's input (a batch of IMG_B
    decoded and DCT-scaled as ImageRecordIter's card route does, its
    random crops and flips), its plain version's, and its bound: the
    pixels the crop windows read and the f32 batch written once (the
    operations are a few per byte)."""
    fn = lambda: IA.image_aug(buf, table, IMG_SHAPE, IMG_MEAN, IMG_STD)
    ms, _ = device_time(fn, flush, match="image_aug")
    plain = cuda_ms(lambda: IA.image_aug_reference(
        buf, table, IMG_SHAPE, IMG_MEAN, IMG_STD), iters=3)
    n_out = IMG_B * 3 * IMG_SHAPE[1] * IMG_SHAPE[2] * 4
    n_read = crop_read_bytes(IA, table)
    bound_ms, by = bound(n_read + table.numel() * 8 + n_out, 0,
                         torch.float32)
    log("image_aug at bs %d (decoded %.1f MB, of which the crops read %.1f "
        "MB; out %.1f MB): %.4f ms, plain %.2f ms, bound %.4f ms (%s)"
        % (IMG_B, buf.numel() / 1e6, n_read / 1e6, n_out / 1e6, ms, plain,
           bound_ms, by))
    return {"name": "image_aug", "route": "cuda",
            "source": "mxnet_tpu_torch/kernels/csrc/image_aug.cu",
            "replaces": "none: the reference augments on the host "
                        "(native/src/image_loader.cc:405-460), no "
                        "pallas_call",
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None,
            "shape": "bs %d of %s decoded JPEGs (DCT-scaled as the main "
                     "path decodes them) -> %s f32"
                     % (IMG_B, sorted(set(sizes)), IMG_SHAPE),
            "tolerance": "bit for bit"}



# ------------------------------------------------------------- kvstore --
# the kvstore phase: two worker processes and one server on the card,
# started by the port's launcher (tests/_torch_dist_worker.py --resnet),
# held to a replay in this process; then the in-process stores
KV_STEPS, KV_COMPRESSED_STEPS = 4, 2
KV_TIMEOUT = 300                # seconds a launcher run may take
KV_SPLIT_BYTES = 512 << 10      # an ici bucket size that splits buckets


def kv_worker_module():
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import _torch_dist_worker as W
    return W


def kv_launch(out_dir, failures):
    """The launcher's ``-n 2 -s 1 --launcher local`` run of the ResNet
    worker; its process group is killed on a timeout.  Returns the two
    workers' reports and their weights after the plain steps and at the
    end, or None."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
           "-s", "1", "--launcher", "local", sys.executable,
           os.path.join(REPO, "tests", "_torch_dist_worker.py"),
           "--resnet", out_dir, "--steps", str(KV_STEPS),
           "--compressed-steps", str(KV_COMPRESSED_STEPS)]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=REPO, start_new_session=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        out, _ = p.communicate(timeout=KV_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        out, _ = p.communicate()
        failures.append("kvstore launcher run timed out")
        log(out[-4000:])
        return None
    finally:
        try:
            os.killpg(p.pid, 9)          # nothing of the job outlives it
        except ProcessLookupError:
            pass
    log("kvstore launcher: rc %d in %.1f s" % (p.returncode,
                                               time.perf_counter() - t0))
    if p.returncode != 0 or out.count("OK") != 2:
        failures.append("kvstore launcher run failed (rc %d)"
                        % p.returncode)
        log(out[-4000:])
        return None
    reports, weights = [], {"plain": [], "2-bit": []}
    for r in range(2):
        with open(os.path.join(out_dir, "worker%d.json" % r)) as f:
            reports.append(json.load(f))
        for name, f in (("plain", "worker%d_plain.npz"),
                        ("2-bit", "worker%d.npz")):
            with np.load(os.path.join(out_dir, f % r)) as z:
                weights[name].append([z["arr_%d" % i]
                                      for i in range(len(z.files))])
    return reports, weights


def kv_replay(mx, W):
    """The job in this process: each step both workers' gradients on the
    card, read to the host (2-bit coded through each worker's own
    compressor in the compressed steps), summed in f32 as the server
    sums them, and SGD applied on the card by the optimizer's updater.
    Returns the weights after the plain steps and at the end."""
    from mxnet_tpu_torch.parallel.compression import (TwoBitCompressor,
                                                      decompress)
    W.deterministic()
    ctx = mx.gpu(0)
    net, params = W.resnet_net(ctx)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    upd = mx.optimizer.get_updater(mx.optimizer.SGD(**W.RESNET_OPT))
    thr = W.RESNET_COMPRESSION["threshold"]
    comps = [TwoBitCompressor(thr) for _ in range(W.RESNET_WORKERS)]
    store = [p.data(ctx).asnumpy() for p in params]
    out = {}
    for step in range(KV_STEPS + KV_COMPRESSED_STEPS):
        if step == KV_STEPS:
            out["plain"] = list(store)
        per = []
        for r in range(W.RESNET_WORKERS):
            x, y = W.resnet_batch(r, step, ctx)
            grads = [g.asnumpy() for g in
                     W.resnet_grads(net, params, loss_fn, x, y, ctx)]
            if step >= KV_STEPS:
                grads = [decompress(*comps[r].compress(k, g)[:2], thr)
                         for k, g in enumerate(grads)]
            per.append(grads)
        for k, p in enumerate(params):
            agg = np.sum([g[k] for g in per], axis=0)
            w = mx.nd.array(store[k], ctx=ctx)
            upd(k, mx.nd.array(agg, ctx=ctx), w)
            store[k] = w.asnumpy()
            p.data(ctx)._set_data(torch.from_numpy(store[k])
                                  .to(ctx.torch_device))
    out["2-bit"] = store
    return out


def kv_diff(a, b):
    """(arrays that differ in any bit, largest |difference|)."""
    n = sum(not np.array_equal(x.view(np.uint32), y.view(np.uint32))
            for x, y in zip(a, b))
    return n, max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def kv_job(mx, W, failures):
    """The launcher's job against its replay; the per-step figures."""
    tmp = tempfile.mkdtemp(prefix="kvstore-")
    try:
        got = kv_launch(tmp, failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if got is None:
        return {}
    reports, weights = got
    want = kv_replay(mx, W)
    out = {"model_bytes": reports[0]["bytes"],
           "first_step_ms": [rep["steps"][0]["step_ms"] for rep in reports]}
    for name in ("plain", "2-bit"):
        n01, d01 = kv_diff(weights[name][0], weights[name][1])
        n0r, d0r = kv_diff(weights[name][0], want[name])
        log("kvstore dist_sync %s: %d weights a worker; worker 0 vs 1: %d "
            "differ (max %.3g); worker 0 vs replay: %d differ (max %.3g)"
            % (name, len(want[name]), n01, d01, n0r, d0r))
        if n01 or n0r or len(weights[name][0]) != len(want[name]):
            failures.append("kvstore %s: weights not bit for bit (%d, %d "
                            "of %d)" % (name, n01, n0r, len(want[name])))
        # past each worker's first step (start-up and graph capture)
        rows = [s for rep in reports for s in rep["steps"][1:]
                if s["compressed"] == (name == "2-bit")]
        med = {k: float(np.median([s[k] for s in rows]))
               for k in rows[0] if k != "compressed"}
        med["wait_share"] = float(np.median(
            [(s["push_ms"] + s["pull_ms"]) / s["step_ms"] for s in rows]))
        log("kvstore dist_sync %s per step (median of %d worker steps): %s"
            % (name, len(rows), json.dumps(med)))
        out[name] = {"median": med, "worker_vs_worker_differ": n01,
                     "worker_vs_replay_differ": n0r,
                     "max_abs_diff": max(d01, d0r)}
    for rep in reports:
        others = {k: v for k, v in rep["launches"].items() if v}
        if others:
            failures.append("kvstore worker %d launches: %s"
                            % (rep["rank"], others))
    return out


def kv_stores_on_card(mx, failures):
    """ResNet-50's 193 gradient shapes as two contributions, one on
    gpu(0) and one on cpu(0), through local, device, ici (bucketed, per
    key, split) and horovod; each sum pulled onto gpu(0) must equal the
    torch sum v0 + v1 bit for bit."""
    from mxnet_tpu_torch.kvstore.ici import ICIKVStore
    shapes = resnet50_shapes(mx)
    gpu, cpu = mx.gpu(0), mx.cpu(0)
    rng = np.random.RandomState(5)
    host = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
            for _ in range(2)]
    a = [mx.nd.array(h, ctx=gpu) for h in host[0]]
    b = [mx.nd.array(h, ctx=cpu) for h in host[1]]
    want = [x._data + y._data.to(x._data.device) for x, y in zip(a, b)]
    keys = list(range(len(shapes)))
    out = {}
    for name, make in [
            ("local", lambda: mx.kv.create("local")),
            ("device", lambda: mx.kv.create("device")),
            ("ici bucketed", lambda: ICIKVStore()),
            ("ici per key", lambda: ICIKVStore(0)),
            ("ici split", lambda: ICIKVStore(KV_SPLIT_BYTES)),
            ("horovod", lambda: mx.kv.create("horovod"))]:
        kv = make()
        outs = [mx.nd.zeros(s, ctx=gpu) for s in shapes]
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "horovod":
                for k in keys:
                    kv.pushpull(k, [a[k], b[k]], out=outs[k])
            else:
                kv.init(keys, [mx.nd.zeros(s, ctx=gpu) for s in shapes])
                kv.push(keys, [[x, y] for x, y in zip(a, b)])
                kv.pull(keys, out=outs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        bad = sum(not torch.equal(o._data, w) for o, w in zip(outs, want))
        row = {"ms": times[1:], "differ": bad}
        if isinstance(kv, ICIKVStore):
            row.update(kv.stats())
        out[name] = row
        if bad:
            failures.append("kvstore %s on the card: %d of %d sums not bit "
                            "for bit" % (name, bad, len(keys)))
    buckets = [out[n]["buckets"] // 3 for n in
               ("ici bucketed", "ici split", "ici per key")]
    if not buckets[0] < buckets[1] < buckets[2] == len(keys) or any(
            out[n]["collectives"] for n in out if n.startswith("ici")):
        failures.append("kvstore ici buckets %s (want bucketed < split < %d "
                        "per key, no collective)" % (buckets, len(keys)))
    log("kvstore stores on the card (gpu(0) + cpu(0), %d keys, %.1f MB; "
        "ms of a push and pull, 2 timed after 1; buckets a sync %s): %s"
        % (len(keys), sum(w.numel() * 4 for w in want) / 1e6, buckets,
           json.dumps(out)))
    return out


def kvstore_path(mx, card, failures):
    """The ``kvstore`` phase: every registered launch counter from 0, and
    still 0 after, in this process and in each worker (no hand-written
    kernel is on these paths)."""
    from mxnet_tpu_torch.kernels._counters import registered
    t0 = time.perf_counter()
    for h, a in registered():
        setattr(h, a, 0)
    W = kv_worker_module()
    log("kvstore: %s; ResNet-50 v1, 224x224, f32, hybridized; 2 workers x "
        "%d images (bench.py's 64), SGD %s on the server; %d steps, then "
        "%d with 2-bit compression %s"
        % (card, W.RESNET_BATCH, json.dumps(W.RESNET_OPT), KV_STEPS,
           KV_COMPRESSED_STEPS, json.dumps(W.RESNET_COMPRESSION)))
    out = {"dist_sync": kv_job(mx, W, failures)}
    gc.collect()
    torch.cuda.empty_cache()
    out["stores"] = kv_stores_on_card(mx, failures)
    launches = {"%s.%s" % (getattr(h, "__name__", type(h).__name__), a):
                getattr(h, a) for h, a in registered()}
    others = {k: v for k, v in launches.items() if v}
    log("kvstore path launches: %s" % (json.dumps(others) if others
                                       else "every counter 0"))
    if others:
        failures.append("kvstore path launches: %s" % others)
    out["seconds"] = time.perf_counter() - t0
    log("kvstore phase seconds: %.1f" % out["seconds"])
    return out



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
    card = card_line()
    log("card:", card)
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
    # ---- 4b. the serving options (prefix cache, speculation, overlap):
    # the small f32 gates, then the preset's runs, each path's paged
    # launches from 0
    report["serving_options"], options_launches = serving_options(
        G, PA, ServingEngine, params, cfg, dev, card, failures)
    gc.collect()
    torch.cuda.empty_cache()

    phase("serving options")
    # ---- 4c. telemetry (metrics, the profiler's request lanes) and the
    # host-DRAM KV tier, the phase's kernel counters from 0
    zero_counters(FA, PA, FO)
    report["telemetry_and_tier"] = telemetry_and_tier(
        G, ServingEngine, params, cfg, dev, card, failures)
    tier_launches = {"paged_attention": PA.paged_attention.launches,
                     "flash_fwd": FA.flash_fwd.launches}
    log("telemetry and tier path launches:", json.dumps(tier_launches))
    for name, n in tier_launches.items():
        if n <= 0:
            raise Failed("%s was never launched on the telemetry and tier "
                         "path" % name)
    gc.collect()
    torch.cuda.empty_cache()

    phase("telemetry and tier")
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
    check_remat(T_.make_train_step, bert_cfg, state[0], batch, dev,
                failures)
    check_remat(T_.make_train_step, bert_cfg, state[0], batch, dev,
                failures, policy="dots")
    report["remat"] = remat_costs(T_, FA, PA, FO, bert_cfg, state[0], batch,
                                  dev, failures)
    report["scan"], scan_launches = check_scan(T_, FA, PA, FO, bert_cfg,
                                               state[0], batch, dev,
                                               failures)
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
    g_trained, _, gpt_launches, gpt_s = train_path(
        "GPT causal train", g_init, g_step, gbatch, dev, GPT_STEPS,
        GPT_WARM, FA, PA, FO, LAYERS, seed=1)
    check_remat(G.make_train_step, gpt_train_cfg, g_trained[0], gbatch, dev,
                failures, policy="dots", name="GPT causal, bs %d x %d"
                % (GPT_B, MAX_LEN))
    del g_trained
    gc.collect()
    torch.cuda.empty_cache()
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
    # ---- 7a. the symbolic API: ResNet-50 through Module (every launch
    # counter from 0 around its main path), fit/checkpoint/score, the
    # export served by SymbolBlock, the NMT BucketingModule
    gc.collect()
    torch.cuda.empty_cache()
    report["module"] = module_path(mx, failures, resnet)
    check_small_module(mx, failures)

    phase("module")
    # ---- 7d. the op library, mx.random, the optimizer family and
    # SequentialModule, every launch counter from 0 (all stay 0)
    gc.collect()
    torch.cuda.empty_cache()
    report["library"] = library_path(mx, failures)

    phase("library")
    # ---- 7e. recurrent networks: the RNN op, gluon.rnn and the control
    # flow on the card against the CPU, MXNet's word language model at
    # full width, the LSTM beside cuDNN's; every launch counter from 0
    gc.collect()
    torch.cuda.empty_cache()
    report["rnn"] = rnn_path(mx, failures)

    phase("rnn")
    # ---- 7f. the vision zoo: the conv/pool layers on the card against
    # the CPU and six families at ImageNet width through gluon.Trainer;
    # every launch counter from 0
    gc.collect()
    torch.cuda.empty_cache()
    report["zoo"] = zoo_path(mx, failures)

    phase("zoo")
    # ---- 7g. the detection ops: examples/ssd_detection.py's SSD on the
    # card, the ops at SSD300 and RPN scale, an SSD symbol replayed, the
    # NMS kernel against its plain version; every launch counter from 0
    # (only nms_keep launches)
    gc.collect()
    torch.cuda.empty_cache()
    report["detection"], nms_row = detection_path(mx, failures, flush)

    phase("detection")
    # ---- 7h. Gluon data, the Estimator and nd.sparse: a thumbnail
    # ResNet-18 fed by a DataLoader through Estimator.fit, matrix
    # factorization with row-sparse gradients, the sparse ops at
    # Criteo's shape; every launch counter from 0 (all stay 0)
    gc.collect()
    torch.cuda.empty_cache()
    report["data"] = data_path(mx, card, failures)

    phase("data")
    # ---- 7c. bench.py's workload through DataParallelTrainer; the BERT and
    # GPT steps' graphs and pools are freed first (captured again for the
    # profiles below)
    for stp in (step, g_step):
        stp._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    kept = {}
    report["bench"] = bench_path(mx, failures, resnet, kept)
    check_small_bench(mx, failures)

    phase("bench")
    # ---- 7i. the image pipeline: JPEG records decoded by nvJPEG and
    # augmented by image_aug on the card, alone and feeding the s2d
    # trainer through DevicePrefetchIter; every launch counter from 0
    # (only image_aug launches)
    report["image"], image_rows = image_path(
        mx, kept.pop("s2d"), float(np.mean(report["bench"]["s2d"]
                                           ["images_per_s"])),
        failures, flush)
    gc.collect()
    torch.cuda.empty_cache()

    phase("image")
    # ---- 7j. the KVStore family: ResNet-50 trained by two worker
    # processes through one parameter server on the card, held to a
    # replay here, then the in-process stores; every launch counter from
    # 0 (all stay 0)
    report["kvstore"] = kvstore_path(mx, card, failures)
    gc.collect()
    torch.cuda.empty_cache()

    phase("kvstore")
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
        "launches_by_path": {
            "serving": launches["paged_attention"],
            "serving, all three options, shared-prefix mix":
                options_launches,
            "telemetry and tier": tier_launches["paged_attention"]},
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

    by_path = {"serving": launches, "telemetry and tier": tier_launches,
               "bert": bert_launches, "gpt": gpt_launches,
               "bert remat dots": report["remat"]["dots"]["flash_launches"],
               "bert scan_steps=%d" % SCAN_K: scan_launches}
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
    kernels.append({
        "name": "nms_keep", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/nms.cu",
        "replaces": "none: mxnet_tpu/ops/vision.py:108 _nms_keep is a "
                    "lax.scan that XLA compiles, no pallas_call",
        "device_symbols": ["nms_mask", "nms_sweep"],
        "launches_by_path": {"detection": nms_row["launches"]},
        "launches_note": "calls, two kernel launches each",
        "tolerance": "bit for bit (max_abs_err: keep flags that differ)",
        **nms_row})
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
    for row in image_rows:
        kernels.append(dict(row, launches_by_path={
            "image": row["launches"]}))

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
