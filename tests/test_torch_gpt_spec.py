"""Port parity: ``mxnet_tpu_torch.models.gpt`` speculative decoding
(``_attend_block``, ``_decode_block``, ``draft_slice_params``,
``_draft_ngram``, ``generate_speculative``) against the reference's, on
the CPU at the tiny config of tests/test_serving.py.

* ``_draft_ngram`` equals the reference's on random token buffers, and
  the host drafter ``serving/drafters.py ngram_draft`` on each row's
  committed region (the twin of the reference's parity pin);
* ``_decode_block`` logits within 1e-5 of the reference's (f32
  summation order) from one prefill, cache writes included;
* greedy ``generate_speculative`` with both drafters equals the
  reference's, its stats, and ``generate`` (f32 token identity);
  int8 KV agrees with the reference's ``generate`` >= 0.9;
* ``temperature > 0`` draws from an explicit ``torch.Generator``: the
  same generator seed gives the same tokens; validation errors."""
import numpy as np
import pytest
import torch

from _torch_port import configs, numpy_params, quantized, to_port


def _setup(seed=3, **kw):
    jcfg, tcfg = configs(**kw)
    return jcfg, tcfg, numpy_params(jcfg, seed)


def _ref_spec(tree, jcfg, prompt, n, **kw):
    import jax.numpy as jnp
    from mxnet_tpu.models import gpt
    out, st = gpt.generate_speculative(tree, jcfg, jnp.asarray(prompt), n,
                                       return_stats=True, **kw)
    return np.asarray(out), {k: int(v) for k, v in st.items()}


def _ref_generate(tree, jcfg, prompt, n, **kw):
    import jax.numpy as jnp
    from mxnet_tpu.models import gpt
    return np.asarray(gpt.generate(tree, jcfg, jnp.asarray(prompt), n, **kw))


@pytest.mark.parametrize("g", [1, 2, 3])
def test_draft_ngram_equals_reference(g):
    import jax.numpy as jnp
    from mxnet_tpu.models import gpt as RG
    from mxnet_tpu_torch.models.gpt import _draft_ngram
    from mxnet_tpu_torch.serving.drafters import ngram_draft
    rng = np.random.RandomState(g)
    buf = rng.randint(1, 5, (4, 30)).astype(np.int32)  # many matches
    for n_next in (g, g + 1, 9, 17, 29):
        for K in (1, 4):
            want = np.asarray(RG._draft_ngram(jnp.asarray(buf), n_next, K, g))
            got = _draft_ngram(torch.from_numpy(buf).long(), n_next, K, g)
            np.testing.assert_array_equal(got.numpy(), want)
            for b in range(buf.shape[0]):
                np.testing.assert_array_equal(
                    ngram_draft(buf[b, :n_next], K, g), want[b])


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_block_logits_match_reference(kv_int8):
    """One prefill, then a 4-token block at the committed position: the
    block's logits within 1e-5 of the reference's, and the written cache
    rows within 1e-5 (int8: the same quantized values)."""
    import jax.numpy as jnp
    from mxnet_tpu.models import gpt as RG
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree = _setup(5)
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, 90, (2, 7)).astype(np.int32)
    block = rng.randint(1, 90, (2, 4)).astype(np.int32)
    total = 16
    _, rc = RG._prefill_full(tree, jcfg, jnp.asarray(prompt), total,
                             kv_int8=kv_int8)
    rlog, rc = RG._decode_block(tree, jcfg, jnp.asarray(block), 7, rc)
    with torch.inference_mode():
        params = G.prepare_params(to_port(tree), tcfg, "cpu")
        _, tc = G._prefill_full(params, tcfg, torch.from_numpy(prompt).long(),
                                total, kv_int8=kv_int8)
        tlog, tc = G._decode_block(params, tcfg,
                                   torch.from_numpy(block).long(), 7, tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(tc, rc):
        got, want = a["kv"][:, 7:11].float().numpy(), \
            np.asarray(b["kv"][:, 7:11], np.float32)
        if kv_int8:
            assert np.mean(got == want) >= 0.99
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("drafter", ["ngram", "self"])
@pytest.mark.parametrize("w8", [False, True])
def test_greedy_equals_reference_and_generate(drafter, w8):
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree = _setup(3)
    if w8:
        tree = quantized(tree)
    rng = np.random.RandomState(1)
    # a repetitive prompt, so the ngram drafter's proposals get accepted
    prompt = np.tile(rng.randint(1, 90, (2, 4)), 3).astype(np.int32)
    kw, tkw = {}, {}
    if drafter == "self":
        from mxnet_tpu.models import gpt as RG
        dp, dc = RG.draft_slice_params(tree, jcfg, 1)
        tdp, tdc = G.draft_slice_params(to_port(tree), tcfg, 1)
        assert dc.n_layers == tdc.n_layers == 1
        assert len(tdp["layers"]) == 1
        kw = dict(draft_params=dp, draft_cfg=dc)
        tkw = dict(draft_params=tdp, draft_cfg=tdc)
    N, K = 20, 3
    want, rstats = _ref_spec(tree, jcfg, prompt, N, K=K, drafter=drafter,
                             **kw)
    got, stats = G.generate_speculative(to_port(tree), tcfg, prompt, N, K=K,
                                        drafter=drafter, return_stats=True,
                                        device="cpu", **tkw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == rstats
    assert stats["tokens"] >= N and stats["drafted"] == stats["iters"] * K
    np.testing.assert_array_equal(got.numpy(),
                                  _ref_generate(tree, jcfg, prompt, N))


def test_int8_kv_agreement():
    from mxnet_tpu_torch.models import gpt as G
    jcfg, tcfg, tree = _setup(11)
    prompt = np.random.RandomState(2).randint(1, 90, (1, 9)).astype(np.int32)
    got = G.generate_speculative(to_port(tree), tcfg, prompt, 16, K=2,
                                 kv_int8=True, device="cpu").numpy()
    want = _ref_generate(tree, jcfg, prompt, 16, kv_int8=True)
    assert (got == want).mean() >= 0.9


@pytest.mark.parametrize("drafter", ["ngram", "self"])
def test_sampling_uses_the_generator(drafter):
    """temperature > 0: tokens in the vocabulary, the prompt kept, the
    same generator seed giving the same tokens (the rejection rule draws
    only from the generator)."""
    from mxnet_tpu_torch.models import gpt as G
    _, tcfg, tree = _setup(3)
    params = to_port(tree)
    kw = {}
    if drafter == "self":
        dp, dc = G.draft_slice_params(params, tcfg, 1)
        kw = dict(draft_params=dp, draft_cfg=dc)
    prompt = np.arange(1, 8)[None].repeat(2, 0)
    outs = [G.generate_speculative(
        params, tcfg, prompt, 12, K=3, drafter=drafter, temperature=0.9,
        generator=torch.Generator().manual_seed(s), device="cpu", **kw)
        for s in (4, 4, 5)]
    assert torch.equal(outs[0], outs[1])
    for o in outs:
        assert o.shape == (2, 19) and torch.equal(o[:, :7],
                                                 torch.from_numpy(prompt))
        assert int(o.min()) >= 0 and int(o.max()) < tcfg.vocab_size


def test_validation():
    from mxnet_tpu_torch.models import gpt as G
    _, tcfg, tree = _setup(3)
    params = to_port(tree)
    prompt = np.ones((1, 5), np.int64)
    with pytest.raises(ValueError):
        G.generate_speculative(params, tcfg, prompt, 4, K=0, device="cpu")
    with pytest.raises(ValueError):
        G.generate_speculative(params, tcfg, prompt, 4, drafter="bad",
                               device="cpu")
    with pytest.raises(ValueError):
        G.generate_speculative(params, tcfg, prompt, 4, drafter="self",
                               device="cpu")
    with pytest.raises(ValueError):          # 5 + 58 + 4 > max_len 64
        G.generate_speculative(params, tcfg, prompt, 58, K=4, device="cpu")
    out, st = G.generate_speculative(params, tcfg, prompt, 0,
                                     return_stats=True, device="cpu")
    assert out.shape == (1, 5) and st["tokens"] == 0
