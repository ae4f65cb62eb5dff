"""Port parity: ``mxnet_tpu_torch.serving.ServingEngine`` on the CPU
against the REFERENCE ``mxnet_tpu.models.gpt.generate``, on the tiny
config of tests/test_serving.py and one numpy parameter tree.

Under f32 greedy decode every request must be token-identical to
``generate`` — through admission waves, chunked prefill, page reuse,
preemption, eos and cancel, for float and weight-only-int8 params.
int8 KV is held to greedy agreement >= 0.9, as the reference engine
is.  (P, N) pairs repeat across requests so the reference compiles few
``generate`` programs."""
import numpy as np
import pytest

import jax.numpy as jnp

import mxnet_tpu as mx  # noqa: F401  (conftest device setup)
from _torch_port import configs, numpy_params, quantized, to_port


def _setup(seed, w8=False):
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, seed)
    if w8:
        tree = quantized(tree)
    return jcfg, tcfg, tree


def _ref(tree, jcfg, prompt, n, **kw):
    from mxnet_tpu.models import gpt
    return np.asarray(gpt.generate(tree, jcfg, jnp.asarray(prompt)[None],
                                   n, **kw))[0]


def _engine(tree, tcfg, **kw):
    from mxnet_tpu_torch.serving import ServingEngine
    return ServingEngine(to_port(tree), tcfg, device="cpu", **kw)


@pytest.mark.parametrize("w8", [False, True])
def test_mixed_lengths_token_identical(w8):
    """Six requests on three slots: two admission waves, chunked
    prefill across steps, and recycled pages."""
    jcfg, tcfg, tree = _setup(3, w8)
    rng = np.random.RandomState(0)
    shapes = [(5, 8), (3, 12), (9, 4), (5, 8), (3, 12), (9, 4)]
    eng = _engine(tree, tcfg, num_slots=3, page_size=4, prefill_chunk=6)
    reqs = [(eng.submit(rng.randint(1, 90, P), N), N) for P, N in shapes]
    outs = eng.run()
    assert eng.stats["admitted"] == len(shapes)
    for rid, N in reqs:
        np.testing.assert_array_equal(
            outs[rid], _ref(tree, jcfg, eng.requests[rid].prompt, N))
    assert eng.cache.pages_in_use == 0


def test_preemption_recompute_exact():
    """An over-committed pool preempts the youngest running request;
    every output stays token-identical and no page leaks."""
    jcfg, tcfg, tree = _setup(9)
    rng = np.random.RandomState(3)
    eng = _engine(tree, tcfg, num_slots=4, page_size=4, pages_per_slot=8,
                  num_pages=12, prefill_chunk=4)
    reqs = [(eng.submit(rng.randint(1, 90, P), N), N)
            for P, N in [(6, 20), (4, 24), (6, 20), (4, 24), (6, 20)]]
    outs = eng.run()
    assert eng.stats["preemptions"] > 0, "pool was sized to preempt"
    for rid, N in reqs:
        np.testing.assert_array_equal(
            outs[rid], _ref(tree, jcfg, eng.requests[rid].prompt, N))
    assert eng.cache.pages_in_use == 0


def test_int8_kv_agreement():
    jcfg, tcfg, tree = _setup(11)
    rng = np.random.RandomState(4)
    eng = _engine(tree, tcfg, num_slots=2, page_size=4, kv_int8=True,
                  prefill_chunk=8)
    reqs = [eng.submit(rng.randint(1, 120, 5), 8) for _ in range(2)]
    outs = eng.run()
    for rid in reqs:
        ref = _ref(tree, jcfg, eng.requests[rid].prompt, 8, kv_int8=True)
        assert (outs[rid] == ref).mean() >= 0.9, (outs[rid], ref)
    assert eng.cache.pages_in_use == 0


def test_eos_stops_early():
    jcfg, tcfg, tree = _setup(13)
    prompt = np.arange(1, 4, dtype=np.int32)
    ref = _ref(tree, jcfg, prompt, 12)
    eos = int(ref[8])                     # a token greedy WILL emit
    eng = _engine(tree, tcfg, num_slots=1, page_size=4)
    rid = eng.submit(prompt, 12, eos_id=eos)
    out = eng.run()[rid]
    assert out[-1] == eos and out.size <= ref.size
    np.testing.assert_array_equal(out, ref[:out.size])
    assert eng.cache.pages_in_use == 0


def test_cancel_and_page_reuse():
    """Cancel a request mid-flight and one still queued; a new request
    in a one-request pool must reuse the freed pages and still match
    the reference (no leakage through stale page contents).  A cancel
    after completion is a no-op."""
    jcfg, tcfg, tree = _setup(7)
    rng = np.random.RandomState(2)
    eng = _engine(tree, tcfg, num_slots=1, page_size=4, pages_per_slot=5,
                  num_pages=6, prefill_chunk=8)
    ra = eng.submit(rng.randint(1, 90, 8), 12)
    rq = eng.submit(rng.randint(1, 90, 4), 4)
    for _ in range(4):
        eng.step()
    req_a = eng.requests[ra]
    assert req_a.state == "running" and req_a.generated
    pages_a = set(req_a.pages)
    eng.cancel(ra)
    eng.cancel(rq)
    assert req_a.state == "cancelled" and eng.requests[rq].state == \
        "cancelled"
    assert eng.cache.pages_in_use == 0
    rb = eng.submit(rng.randint(1, 90, 3), 12)
    req_b = eng.requests[rb]
    seen = set()
    while eng.step() is not False:
        seen |= set(req_b.pages)
    assert seen & pages_a
    np.testing.assert_array_equal(req_b.output,
                                  _ref(tree, jcfg, req_b.prompt, 12))
    eng.cancel(rb)
    assert req_b.state == "done"
    assert set(eng.run()) == {rb}


def test_forced_preempt_resumes_exact():
    jcfg, tcfg, tree = _setup(5)
    rng = np.random.RandomState(6)
    eng = _engine(tree, tcfg, num_slots=2, page_size=4, prefill_chunk=6)
    r1 = eng.submit(rng.randint(1, 90, 5), 8)
    r2 = eng.submit(rng.randint(1, 90, 5), 8)
    for _ in range(3):
        eng.step()
    assert eng.preempt(r2) is False
    assert eng.requests[r2].state == "queued"
    with pytest.raises(ValueError):
        eng.preempt(r2)
    outs = eng.run()
    assert eng.stats["preemptions"] == 1
    for rid in (r1, r2):
        np.testing.assert_array_equal(
            outs[rid], _ref(tree, jcfg, eng.requests[rid].prompt, 8))


@pytest.mark.parametrize("opt", [dict(tier_bytes=1 << 20), dict(tp=2),
                                 dict(mesh={"tp": 2}), dict(metrics=True),
                                 dict(kernel="pallas")])
def test_unported_options_raise(opt):
    """The options not ported yet raise (a mesh with a live ``tp`` axis;
    a one-device mesh is ported, tests/test_torch_mesh_one_device.py);
    ``tier_bytes`` and ``metrics`` are ported
    (tests/test_torch_serving_tier.py and
    tests/test_torch_serving_metrics.py) and must be honoured."""
    _, tcfg, tree = _setup(0)
    if "mesh" in opt:
        from mxnet_tpu_torch.parallel import make_mesh
        opt = dict(mesh=make_mesh(opt["mesh"], devices=["cpu", "cpu"]))
    if "tier_bytes" in opt or "metrics" in opt:
        eng = _engine(tree, tcfg, num_slots=1, page_size=4, **opt)
        assert eng.tier is not None if "tier_bytes" in opt \
            else eng.metrics_enabled
        return
    with pytest.raises(NotImplementedError):
        _engine(tree, tcfg, num_slots=1, page_size=4, **opt)


def test_validation():
    from mxnet_tpu_torch.serving import PagedKVCache
    _, tcfg, tree = _setup(0)
    eng = _engine(tree, tcfg, num_slots=1, page_size=4)
    with pytest.raises(ValueError):
        eng.submit(np.ones(40, np.int32), 30)     # 70 > max_len 64
    with pytest.raises(ValueError):
        eng.submit(np.ones(0, np.int32), 4)
    with pytest.raises(ValueError):
        eng.submit(np.ones(4, np.int32), 0)
    with pytest.raises(ValueError):
        _engine(tree, tcfg, num_slots=1, page_size=4, num_pages=3)
    with pytest.raises(ValueError):
        PagedKVCache(tcfg, num_pages=1, page_size=4, device="cpu")
    assert eng.step() is False                    # idle engine
