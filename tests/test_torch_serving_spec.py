"""Port parity: in-engine speculative decode of ``mxnet_tpu_torch.serving``
(``spec_K``, ``spec_drafter``, ``serving/drafters.py``) against the
reference's, on the CPU at the tiny config of tests/test_serving.py.

Twins of ``tests/test_serving_spec.py``: whatever the drafter proposes
(ngram, adversarial, oracle) and however many tokens a verify step
commits, f32 greedy outputs equal the reference ``generate`` and the
reference engine with the same options, through admission waves,
preemption, eos inside an accepted run and forced rejections; the
schedule-determined stats (``spec_drafted``, ``spec_accepted`` and the
row counts) equal the reference engine's.  ``ngram_draft`` equals the
reference's on random rows.

The ``cuda`` test holds the captured engine with speculation against the
same engine run op by op on the card (no JAX there: it imports none)."""
import numpy as np
import pytest

from _torch_port import (assert_no_leak, assert_same_engines, configs,
                         cuda_device, numpy_params, port_engine, ref_engine,
                         ref_generate, run_both)  # noqa: F401


def _setup(seed, **kw):
    jcfg, tcfg = configs(**kw)
    return jcfg, tcfg, numpy_params(jcfg, seed)


def _oracle(full):
    """A drafter that replays ``full`` (the reference continuation)."""
    def draft(tokens, K):
        n = tokens.size
        out = np.ones(K, np.int32)
        avail = full[n:n + K]
        out[:avail.size] = avail
        return out
    return draft


def test_spec_token_identical_mixed_lengths():
    """ngram drafting on a mixed prompt/output-length batch with
    admission waves: generate-identical, the reference engine's tokens
    and drafted/accepted ledger."""
    jcfg, tcfg, tree = _setup(3)
    rng = np.random.RandomState(0)
    cases = [(rng.randint(1, 90, P).astype(np.int32), N)
             for P, N in [(5, 8), (3, 12), (9, 4), (2, 6)]]
    ref, eng, rids = run_both(tree, jcfg, tcfg, cases, num_slots=3,
                              page_size=4, prefill_chunk=6, spec_K=3)
    assert_same_engines(ref, eng, rids)
    for rid, (p, n) in zip(rids, cases):
        np.testing.assert_array_equal(eng.requests[rid].output,
                                      ref_generate(tree, jcfg, p, n))
    assert eng.stats["spec_drafted"] > 0
    assert eng.n_rows == 3 * (1 + 3) + 6


def test_spec_forced_rejection_rollback():
    """An ADVERSARIAL drafter (constant proposals) degrades to plain
    decode, never corrupts it; an ORACLE drafter accepts everything and
    cuts the step count.  Both as the reference engine."""
    jcfg, tcfg, tree = _setup(7)
    rng = np.random.RandomState(2)
    prompt = rng.randint(1, 90, 6).astype(np.int32)
    N = 20
    full = ref_generate(tree, jcfg, prompt, N)
    steps = []
    for drafter in (lambda toks, K: np.ones(K, np.int32), _oracle(full)):
        ref, eng, rids = run_both(tree, jcfg, tcfg, [(prompt, N)],
                                  num_slots=2, page_size=4, spec_K=4,
                                  spec_drafter=drafter)
        assert_same_engines(ref, eng, rids)
        np.testing.assert_array_equal(eng.requests[rids[0]].output, full)
        assert eng.stats["spec_drafted"] > 0
        steps.append(eng.stats)
    assert steps[0]["spec_accepted"] < steps[0]["spec_drafted"]
    assert steps[1]["spec_accepted"] == steps[1]["spec_drafted"]
    assert steps[1]["steps"] < steps[0]["steps"]


def test_spec_preemption_recompute_exact():
    """Draft rows deepen page demand on an over-committed pool, so
    preemptions fire; every output stays exact."""
    jcfg, tcfg, tree = _setup(9)
    rng = np.random.RandomState(3)
    cases = [(rng.randint(1, 90, P).astype(np.int32), N)
             for P, N in [(6, 20), (4, 24), (8, 16), (3, 22), (5, 18)]]
    ref, eng, rids = run_both(tree, jcfg, tcfg, cases, num_slots=4,
                              page_size=4, pages_per_slot=8, num_pages=12,
                              prefill_chunk=4, spec_K=2)
    assert eng.stats["preemptions"] > 0
    assert_same_engines(ref, eng, rids)
    for rid, (p, n) in zip(rids, cases):
        np.testing.assert_array_equal(eng.requests[rid].output,
                                      ref_generate(tree, jcfg, p, n))


def test_spec_eos_mid_commit():
    """eos inside an accepted draft run truncates the commit where plain
    decode stops; tokens past it in the same verify step are dropped."""
    jcfg, tcfg, tree = _setup(13)
    prompt = np.arange(1, 6, dtype=np.int32)
    full = ref_generate(tree, jcfg, prompt, 12)
    eos = int(full[8])                    # a token greedy WILL emit
    ref, eng, rids = run_both(tree, jcfg, tcfg, [(prompt, 12, eos)],
                              num_slots=1, page_size=4, spec_K=4,
                              spec_drafter=_oracle(full))
    assert_same_engines(ref, eng, rids)
    out = eng.requests[rids[0]].output
    assert out[-1] == eos and out.size <= full.size
    np.testing.assert_array_equal(out, full[:out.size])


def test_spec_int8_kv_agreement():
    """Speculation over int8 KV pages: greedy agreement >= 0.9 with
    ``generate(kv_int8=True)`` and with the reference engine (the
    reference's bar: gathers reduce in another order), equal stats."""
    jcfg, tcfg, tree = _setup(11, vocab_size=512, d_model=128, n_heads=4,
                              n_layers=3, d_ff=256)
    rng = np.random.RandomState(4)
    cases = [(rng.randint(1, 500, P).astype(np.int32), 12) for P in (5, 7)]
    ref, eng, rids = run_both(tree, jcfg, tcfg, cases, num_slots=2,
                              page_size=4, kv_int8=True, prefill_chunk=8,
                              spec_K=2)
    assert_same_engines(ref, eng, rids, agreement=0.9)
    for rid, (p, n) in zip(rids, cases):
        want = ref_generate(tree, jcfg, p, n, kv_int8=True)
        assert (eng.requests[rid].output == want).mean() >= 0.9


def test_spec_counters_and_validation():
    """spec_K=0 is the plain engine (no draft rows, zero counters); bad
    spec arguments raise; a drafter returning the wrong count raises
    when the step is planned."""
    _, tcfg, tree = _setup(1)
    eng = port_engine(tree, tcfg, num_slots=2, page_size=4)
    assert eng.n_rows == 2 + 8
    rid = eng.submit(np.arange(1, 6, dtype=np.int32), 6)
    eng.run()
    assert eng.stats["spec_drafted"] == 0
    assert eng.requests[rid].state == "done"
    with pytest.raises(ValueError):
        port_engine(tree, tcfg, num_slots=1, page_size=4, spec_K=-1)
    with pytest.raises(ValueError):
        port_engine(tree, tcfg, num_slots=1, page_size=4, spec_drafter=3)
    bad = port_engine(tree, tcfg, num_slots=1, page_size=4, spec_K=2,
                      spec_drafter=lambda t, K: np.ones(K + 1, np.int32))
    bad.submit(np.arange(1, 6, dtype=np.int32), 6)
    with pytest.raises(ValueError):
        bad.run()


def test_spec_out_of_vocab_drafts_clamped():
    """Proposals outside the vocabulary are clamped into it (as the
    reference does), never looked up out of range; output exact."""
    jcfg, tcfg, tree = _setup(5)
    prompt = np.arange(3, 10, dtype=np.int32)
    ref, eng, rids = run_both(
        tree, jcfg, tcfg, [(prompt, 10)], num_slots=1, page_size=4,
        spec_K=3, spec_drafter=lambda t, K: np.full(K, 10 ** 6, np.int64))
    assert_same_engines(ref, eng, rids)
    np.testing.assert_array_equal(eng.requests[rids[0]].output,
                                  ref_generate(tree, jcfg, prompt, 10))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("g", [1, 2, 3])
def test_ngram_draft_equals_reference(seed, g):
    from mxnet_tpu.serving.drafters import ngram_draft as ref_draft
    from mxnet_tpu_torch.serving.drafters import ngram_draft
    rng = np.random.RandomState(seed)
    for n in (1, 2, 3, 7, 25):
        toks = rng.randint(1, 5, n)       # a small alphabet: many matches
        for K in (1, 4):
            np.testing.assert_array_equal(ngram_draft(toks, K, g),
                                          ref_draft(toks, K, g))
    with pytest.raises(ValueError):
        ngram_draft(np.zeros(0, np.int32), 2)
    with pytest.raises(ValueError):
        ngram_draft(np.ones(3, np.int32), 0)


# --------------------------------------------------------------- on card --
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_spec_captured_equals_eager(cuda_device, dtype):
    """On the card, the captured engine with spec_K = 3 (ngram and an
    adversarial drafter, a preempting pool) gives the tokens and stats
    of the same engine run op by op, bit for bit."""
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.serving import ServingEngine
    cfg = G.gpt_tiny(dtype=dtype, vocab_size=128, max_len=64, dropout=0.0)
    params = G.init_params(9, cfg, device="cpu")
    rng = np.random.RandomState(3)
    cases = [(rng.randint(1, 90, P), N)
             for P, N in [(6, 20), (4, 24), (8, 16), (3, 22), (5, 18)]]
    for drafter in ("ngram", lambda t, K: np.ones(K, np.int32)):
        runs = []
        for eager in (True, False):
            eng = ServingEngine(params, cfg, num_slots=4, page_size=4,
                                pages_per_slot=8, num_pages=12,
                                prefill_chunk=4, spec_K=3,
                                spec_drafter=drafter, device=cuda_device)
            eng._eager = eager
            rids = [eng.submit(p, n) for p, n in cases]
            outs = eng.run()
            assert_no_leak(eng)
            runs.append(([outs[r].tolist() for r in rids], dict(eng.stats)))
        assert runs[0] == runs[1]
        assert runs[1][1]["spec_drafted"] > 0
