"""Port parity: overlapped scheduling of ``mxnet_tpu_torch.serving``
(``overlap=True``, ``MXNET_SERVE_OVERLAP``: the device-carried
``tok_src`` select, two host buffer sets, the planner thread) against
the reference's, on the CPU at the config of tests/test_serving_overlap.py.

Twins of ``tests/test_serving_overlap.py:119-213`` and :295: the
overlapped engine is bit-identical to the serial one (and to the
reference engine run overlapped) through eos stops, a mid-pipeline
preemption and a cancel; it matches ``generate``; ``spec_K > 0`` fences
to serial steps; an eos commit invalidates the step already dispatched
without leaking; the environment variable and ``close()``.  Beyond the
reference: all three options together, a planner failure raised on the
engine thread, and a stress run of client threads submitting and
cancelling while the engine steps.

The ``cuda`` test holds the captured overlapped engine (with the prefix
cache and, fenced, speculation) against the same engine run op by op
and against the serial engine on the card (no JAX there)."""
import os
import sys
import threading

import numpy as np
import pytest

from _torch_port import (assert_no_leak, assert_same_engines, configs,
                         cuda_device, numpy_params, port_engine, ref_engine,
                         ref_generate, run_both, to_port)  # noqa: F401

LENS = (3, 11, 7, 19, 5, 13)
MAXNEW = [9, 4, 1, 7, 12, 6]


def _setup(seed=0):
    jcfg, tcfg = configs(vocab_size=97, max_len=96)
    return jcfg, tcfg, numpy_params(jcfg, seed)


def _prompts(rng, vocab, lens=LENS):
    return [rng.randint(1, vocab, size=n).astype(np.int32) for n in lens]


def _drain(eng, chaos=None, cancel_rid=None):
    """Step to the end, with chaos at a fixed step index (the same index
    whichever schedule runs, so both runs face the same script)."""
    steps = 0
    while eng.step() is not False:
        steps += 1
        if chaos == "preempt" and steps == 3:
            running = [r for r in eng._slots if r is not None]
            if running:
                eng.preempt(running[-1].rid)
        if chaos == "cancel" and steps == 4 and cancel_rid is not None:
            eng.cancel(cancel_rid)


def _run(make, tree, cfg, overlap, eos=None, chaos=None, spec_K=0):
    eng = make(tree, cfg, num_slots=3, page_size=8, prefill_chunk=6,
               prefix_cache=True, spec_K=spec_K, overlap=overlap)
    prompts = _prompts(np.random.RandomState(7), cfg.vocab_size)
    rids = [eng.submit(p, m, eos_id=eos) for p, m in zip(prompts, MAXNEW)]
    _drain(eng, chaos=chaos, cancel_rid=rids[1])
    eng.close()
    return eng


def _assert_equiv(a, b, name):
    """Serial ``a`` vs overlapped ``b``: the same states; the same tokens
    except for a cancelled request, whose transcripts must agree on
    their common prefix (the cancel lands one step earlier or later)."""
    assert set(a.requests) == set(b.requests)
    for rid in a.requests:
        ra, rb = a.requests[rid], b.requests[rid]
        assert ra.state == rb.state, (name, rid)
        n = min(len(ra.generated), len(rb.generated)) \
            if ra.state == "cancelled" else None
        assert ra.generated[:n] == rb.generated[:n], (name, rid)


@pytest.mark.parametrize("scenario", ["plain", "eos", "preempt", "cancel"])
def test_overlap_bit_identical_to_serial(scenario):
    """The overlapped engine against the serial one on a mixed-length
    burst whose dispatched step is invalidated by eos stops, a
    preemption or a cancel: identical outcomes, no leak, pipelined steps
    and hidden host time; and the reference engine, overlapped, in
    everything the schedule decides (with chaos: in outcomes)."""
    jcfg, tcfg, tree = _setup()
    kw = {"plain": {}, "eos": {"eos": 5}, "preempt": {"chaos": "preempt"},
          "cancel": {"chaos": "cancel"}}[scenario]
    serial = _run(port_engine, tree, tcfg, False, **kw)
    over = _run(port_engine, tree, tcfg, True, **kw)
    _assert_equiv(serial, over, scenario)
    for eng in (serial, over):
        eng.prefix.evict(10 ** 9)
        assert eng.cache.pages_in_use == 0 and eng.prefix.refs_total == 0
    assert over.stats["overlap_steps"] > 0
    assert over.stats["host_hidden_ms"] > 0.0
    ref = _run(ref_engine, tree, jcfg, True, **kw)
    ref.prefix.evict(10 ** 9)
    if "chaos" in kw:
        # the preempt or cancel races the planner thread in both engines,
        # so their schedules (and stats) may differ: outcomes may not
        _assert_equiv(ref, over, scenario)
    else:
        assert_same_engines(ref, over, list(ref.requests))


def test_overlap_matches_generate():
    """Single-request overlapped decode equals ``generate`` (the carried
    argmax is the argmax the host would have fed back)."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(11)
    for p, m in zip(_prompts(rng, tcfg.vocab_size, (3, 11, 7)), (8, 5, 6)):
        eng = port_engine(tree, tcfg, num_slots=2, page_size=8,
                          prefill_chunk=8, overlap=True)
        rid = eng.submit(p, m)
        out = eng.run()[rid]
        eng.close()
        np.testing.assert_array_equal(out, ref_generate(tree, jcfg, p, m))
        assert eng.stats["overlap_steps"] == eng.stats["steps"] > 0


def test_overlap_spec_engine_fences_to_serial():
    """spec_K > 0: every step with live samplers fences the pipeline, and
    the overlapped engine's output is the serial one's; the fence
    counter shows the fencing happened, as in the reference engine."""
    jcfg, tcfg, tree = _setup()
    prompts = _prompts(np.random.RandomState(7), tcfg.vocab_size)
    cases = list(zip(prompts, MAXNEW))
    outs = []
    for overlap in (False, True):
        eng = port_engine(tree, tcfg, num_slots=3, page_size=8,
                          prefill_chunk=6, spec_K=2, overlap=overlap)
        for p, m in cases:
            eng.submit(p, m)
        outs.append({k: v.tolist() for k, v in eng.run().items()})
        eng.close()
    assert outs[0] == outs[1]
    assert eng.stats["overlap_fences"] > 0
    ref, port, rids = run_both(tree, jcfg, tcfg, cases, num_slots=3,
                               page_size=8, prefill_chunk=6, spec_K=2,
                               overlap=True)
    assert_same_engines(ref, port, rids)


def test_overlap_eos_invalidates_speculative_step_no_leak():
    """An eos commits one step BEHIND a dispatched step: its junk row is
    never committed, the slot's pages come back, and a request reusing
    the slot is exact."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(3)
    p = rng.randint(1, tcfg.vocab_size, 6).astype(np.int32)
    full = ref_generate(tree, jcfg, p, 12)[p.size:]
    eos = int(full[2])                     # stop after 3 tokens
    eng = port_engine(tree, tcfg, num_slots=2, page_size=8,
                      prefill_chunk=8, overlap=True)
    rid = eng.submit(p, 12, eos_id=eos)
    eng.run()
    assert eng.requests[rid].generated == [int(t) for t in full[:3]]
    assert eng.cache.pages_in_use == 0
    q = rng.randint(1, tcfg.vocab_size, 9).astype(np.int32)
    rid2 = eng.submit(q, 5)
    np.testing.assert_array_equal(eng.run()[rid2],
                                  ref_generate(tree, jcfg, q, 5))
    eng.close()


def test_overlap_env_var_and_validation():
    """``MXNET_SERVE_OVERLAP`` sets the default, an explicit argument
    wins, and close() joins the planner thread and is idempotent; a plan
    the planner finished before close() is dispatched by the next step
    (its prefill rows are written: the output equals ``generate``)."""
    jcfg, tcfg, tree = _setup()

    def make(**kw):
        return port_engine(tree, tcfg, num_slots=2, page_size=8,
                           prefill_chunk=8, **kw)

    old = os.environ.get("MXNET_SERVE_OVERLAP")
    try:
        os.environ["MXNET_SERVE_OVERLAP"] = "1"
        assert make().overlap
        assert not make(overlap=False).overlap
        os.environ["MXNET_SERVE_OVERLAP"] = "0"
        assert not make().overlap
        eng = port_engine(tree, tcfg, num_slots=2, page_size=8,
                          prefill_chunk=4, overlap=True)
        assert eng.overlap
        prompt = np.arange(1, 12, dtype=np.int32)
        eng.submit(prompt, 8)
        eng.step()                         # rows 0-3; the planner builds 4-7
        planner = eng._planner
        assert planner is not None and planner.is_alive()
        assert eng._plan_ready.wait(30)
        eng.close()
        assert not planner.is_alive()
        assert eng._plan_pending           # the finished plan is kept
        eng.close()                        # idempotent
        eng.step()                         # a new planner; the kept plan
        kv = eng.cache.pools[0]["kv"][eng.requests[0].pages[0]]
        assert bool((kv[4:8].abs().sum(dim=(1, 2)) > 0).all())
        out = eng.run()[0]
        eng.close()
        np.testing.assert_array_equal(out, ref_generate(tree, jcfg, prompt,
                                                        8))
    finally:
        if old is None:
            os.environ.pop("MXNET_SERVE_OVERLAP", None)
        else:
            os.environ["MXNET_SERVE_OVERLAP"] = old


def test_all_three_options_with_preemption_and_adversarial_drafter():
    """prefix_cache + spec_K + overlap on a preempting pool, with the
    ngram drafter and with an adversarial callable: generate-identical,
    the reference engine's tokens and stats, no leak."""
    jcfg, tcfg, tree = _setup(4)
    rng = np.random.RandomState(5)
    shared = rng.randint(1, tcfg.vocab_size, 10).astype(np.int32)
    cases = [(np.concatenate([shared[:3 + 2 * i], rng.randint(
        1, tcfg.vocab_size, 3).astype(np.int32)]), n)
        for i, n in enumerate((18, 12, 20, 9, 15, 11))]
    for drafter in ("ngram", lambda t, K: np.full(K, 7, np.int32)):
        ref, eng, rids = run_both(
            tree, jcfg, tcfg, cases, num_slots=3, page_size=4,
            pages_per_slot=10, num_pages=16, prefill_chunk=5,
            prefix_cache=True, spec_K=2, spec_drafter=drafter,
            overlap=True)
        assert eng.stats["preemptions"] > 0
        assert eng.stats["prefix_hit_tokens"] > 0
        assert eng.stats["overlap_fences"] > 0
        assert_same_engines(ref, eng, rids)
        for rid, (p, n) in zip(rids, cases):
            np.testing.assert_array_equal(eng.requests[rid].output,
                                          ref_generate(tree, jcfg, p, n))


def test_planner_failure_raises_on_the_engine_thread():
    """An exception in the planner's build is raised by the next step()
    on the engine thread, not lost with the thread."""
    _, tcfg, tree = _setup()
    eng = port_engine(tree, tcfg, num_slots=2, page_size=8,
                      prefill_chunk=8, overlap=True)
    eng.submit(np.arange(1, 9, dtype=np.int32), 6)
    eng.step()                              # inline build; planner signalled

    def broken(overlap=False):
        raise RuntimeError("planner build failed")

    eng._plan_ready.wait(30)                # the planner's plan is ready
    eng._build_plan = broken
    eng.step()                              # takes it, signals the next
    with pytest.raises(RuntimeError, match="planner build failed"):
        eng.step()
    eng.close()


def test_overlap_client_threads_stress():
    """Client threads submit and cancel while the engine steps overlapped
    (a short switch interval to interleave them): every finished request
    equals ``generate``, a cancelled one is a prefix of it, and no page
    or ref is left."""
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree = _setup(2)
    eng = port_engine(tree, tcfg, num_slots=3, page_size=4,
                      num_pages=20, pages_per_slot=8, prefill_chunk=5,
                      prefix_cache=True, overlap=True)
    shared = np.arange(10, 22, dtype=np.int32)
    errors = []

    def client(seed):
        try:
            rng = np.random.RandomState(seed)
            for i in range(3):
                p = np.concatenate([shared[:rng.randint(0, 12)],
                                    rng.randint(1, 90, 3).astype(np.int32)])
                rid = eng.submit(p, int(rng.randint(4, 12)))
                if i == 1:
                    eng.cancel(rid)
        except Exception as e:     # reported by the test below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        while True:
            alive = any(t.is_alive() for t in threads)
            if eng.step() is False and not alive:
                break
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert not errors
    assert len(eng.requests) == 18
    ported = to_port(tree)
    for req in eng.requests.values():
        want = G.generate(ported, tcfg, req.prompt[None],
                          req.max_new_tokens, device="cpu")[0].numpy()
        got = req.output
        if req.state == "done":
            np.testing.assert_array_equal(got, want)
        else:
            assert req.state == "cancelled"
            np.testing.assert_array_equal(got, want[:got.size])
    assert_no_leak(eng)


# --------------------------------------------------------------- on card --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_overlap_captured_equals_eager(cuda_device, dtype):
    """On the card, the captured overlapped engine (prefix cache; then
    with spec_K = 2 too, fenced) gives the tokens and stats of the same
    engine run op by op and the tokens of the serial engine, bit for
    bit, and joins its planner at close()."""
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.serving import ServingEngine
    cfg = G.gpt_tiny(dtype=dtype, vocab_size=97, max_len=96, dropout=0.0)
    params = G.init_params(0, cfg, device="cpu")
    prompts = _prompts(np.random.RandomState(7), 97)
    for spec_K in (0, 2):
        runs = []
        for overlap, eager in ((True, True), (True, False), (False, False)):
            eng = ServingEngine(params, cfg, num_slots=3, page_size=8,
                                prefill_chunk=6, prefix_cache=True,
                                spec_K=spec_K, overlap=overlap,
                                device=cuda_device)
            eng._eager = eager
            rids = [eng.submit(p, m, eos_id=5)
                    for p, m in zip(prompts, MAXNEW)]
            outs = eng.run()
            planner = eng._planner
            eng.close()
            assert planner is None or not planner.is_alive()
            assert_no_leak(eng)
            stats = {k: v for k, v in eng.stats.items()
                     if k != "host_hidden_ms"}
            runs.append(([outs[r].tolist() for r in rids], stats))
        assert runs[0] == runs[1]
        assert runs[1][0] == runs[2][0]
        assert runs[1][1]["overlap_steps"] > 0
