"""Shared inputs for the ``tests/test_torch_*.py`` parity tests: one
numpy parameter tree that goes both through ``mxnet_tpu`` and, via
``mxnet_tpu_torch.convert.from_jax``, through the port."""
import copy
import dataclasses

import numpy as np
import pytest
import torch


def configs(**kw):
    """(JAX config, port config) with identical fields: the tiny GPT of
    tests/test_serving.py unless overridden."""
    from mxnet_tpu.models import gpt
    from mxnet_tpu_torch.models.transformer import TransformerConfig
    base = dict(use_flash=False, remat=False, dropout=0.0,
                dtype="float32", vocab_size=128, max_len=64)
    base.update(kw)
    jcfg = gpt.gpt_tiny(**base)
    return jcfg, TransformerConfig(**dataclasses.asdict(jcfg))


def numpy_params(jcfg, seed):
    """The reference ``init_params`` tree as numpy, with every bias and
    layer-norm gain/bias re-drawn (the reference initialises them to
    0 and 1, which would hide a missing bias)."""
    import jax
    from mxnet_tpu.models import transformer as T
    tree = jax.device_get(T.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed + 1000)

    def bias(n):
        return (0.05 * rng.randn(n)).astype(np.float32)

    def ln(d):
        return {"g": (1.0 + 0.1 * rng.randn(d["g"].size)).astype(np.float32),
                "b": bias(d["b"].size)}

    tree["emb_ln"] = ln(tree["emb_ln"])
    tree["mlm_ln"] = ln(tree["mlm_ln"])
    tree["mlm_bias"] = bias(tree["mlm_bias"].size)
    for layer in tree["layers"]:
        for k in ("bq", "bk", "bv", "bo", "b1", "b2"):
            if k in layer:                # an MoE layer has no b1/b2
                layer[k] = bias(layer[k].size)
        for k in ("b1", "b2"):            # its experts' (E, n) biases
            if "moe" in layer:
                m = layer["moe"]
                m[k] = bias(m[k].size).reshape(m[k].shape)
        layer["ln1"] = ln(layer["ln1"])
        layer["ln2"] = ln(layer["ln2"])
    return tree


def quantized(tree):
    """The reference ``quantize_decode_params`` of a numpy tree, as
    numpy."""
    import jax
    from mxnet_tpu.models import gpt
    return jax.device_get(gpt.quantize_decode_params(tree))


def to_port(tree):
    from mxnet_tpu_torch.convert import from_jax
    return from_jax(tree, "cpu")


class _Reference:
    """``mxnet_tpu``, imported at its first use: test files whose
    ``cuda`` tests run on the card (which has no JAX) with
    ``--noconftest`` bind ``R = reference`` at the top and reach the
    reference only inside their CPU tests."""

    def __getattr__(self, name):
        import mxnet_tpu
        return getattr(mxnet_tpu, name)


reference = _Reference()


@pytest.fixture
def cuda_device():
    """The CUDA device, or skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_flash_on_card(dev, dtype, T, dh, causal, use_mask, dropout, seed,
                        backward=True, B=2, H=3):
    """The flash forward (and, with ``backward``, dQ and dK/dV) kernels
    launched once each on the card at (B, T, H, dh) and held against
    their plain versions: f32 within 1e-5 (O) and 1e-4 (lse, the
    gradients) of 1 + |plain|; bf16 within the limits ``chip_smoke.py``
    derives (``fwd_limit``, ``bwd_limits``; run from the repository
    root), lse within the f32 1e-4.  With ``use_mask`` and not causal,
    the last batch row has all its keys masked; with causal, key 0 is
    kept in every row (a query whose keys up to the diagonal are all
    masked has no common answer: the plain version spreads it over all
    T keys, the kernels over the tiles up to the diagonal)."""
    from chip_smoke import LSE_TOL, bwd_limits, fwd_limit
    from mxnet_tpu_torch.kernels import flash_attention as FA
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(B, T, H, dh).astype(np.float32))
                  .to(dev, dtype) for _ in range(4))
    mask = None
    if use_mask:
        m = rng.rand(B, T) > 0.3
        m[:, 0] = True
        if not causal:
            m[-1] = False
        mask = torch.from_numpy(m).to(dev)
    kw = dict(mask=mask, causal=causal, dropout=dropout,
              seed=torch.tensor([seed], dtype=torch.int32, device=dev))
    before = (FA.flash_fwd.launches, FA.flash_bwd_dq.launches,
              FA.flash_bwd_dkv.launches)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    got, refs, limits = [o], [], []
    if dtype == torch.float32:
        o_r, lse_r = FA.flash_fwd_reference(q, k, v, **kw)
        limits.append(1e-5 * (1 + o_r.abs()))
    else:
        o_r, lse_r, lim = fwd_limit(FA, q, k, v, kw)
        limits.append(lim)
    refs.append(o_r)
    got.append(lse)
    refs.append(lse_r)
    limits.append(LSE_TOL["float32"] * (1 + lse_r.abs()))
    if backward:
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = FA.flash_bwd_dq(q, k, v, g, lse, delta, **kw)
        dk, dv = FA.flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
        grads = (FA.flash_bwd_dq_reference(q, k, v, g, lse, delta, **kw),
                 *FA.flash_bwd_dkv_reference(q, k, v, g, lse, delta, **kw))
        got += [dq, dk, dv]
        refs += list(grads)
        limits += ([1e-4 * (1 + r.float().abs()) for r in grads]
                   if dtype == torch.float32 else
                   bwd_limits(FA, q, k, v, g, lse, delta, grads, kw))
    torch.cuda.synchronize()
    n = 3 if backward else 1
    assert (FA.flash_fwd.launches, FA.flash_bwd_dq.launches,
            FA.flash_bwd_dkv.launches)[:n] == tuple(x + 1 for x in before)[:n]
    for name, x, r, lim in zip(("O", "lse", "dQ", "dK", "dV"), got, refs,
                               limits):
        x, r = x.float(), r.float()
        assert bool(torch.isfinite(x).all()), name
        err = (x - r).abs()
        assert bool((err <= lim).all()), (name, float((err / lim).max()))


# ---------------------------------------------------------------- serving --
# the engine stats that depend on the schedule alone (not on the clock)
ENGINE_STATS = ("steps", "preemptions", "admitted", "decode_rows",
                "prefill_rows", "dead_rows", "peak_pages",
                "prefix_hit_tokens", "cow_copies", "spec_drafted",
                "spec_accepted", "overlap_steps", "overlap_fences")


def ref_generate(tree, jcfg, prompt, n, **kw):
    """The reference ``generate`` of one prompt, as numpy (P + n,)."""
    import jax.numpy as jnp
    from mxnet_tpu.models import gpt
    return np.asarray(gpt.generate(tree, jcfg, jnp.asarray(prompt)[None],
                                   n, **kw))[0]


def port_engine(tree, tcfg, **kw):
    """The port's ``ServingEngine`` on the CPU over a numpy tree."""
    from mxnet_tpu_torch.serving import ServingEngine
    return ServingEngine(to_port(tree), tcfg, device="cpu", **kw)


def ref_engine(tree, jcfg, **kw):
    from mxnet_tpu.serving import ServingEngine
    return ServingEngine(tree, jcfg, **kw)


def run_both(tree, jcfg, tcfg, cases, **kw):
    """The same requests, ``[(prompt, n_new[, eos_id])]``, through the
    reference engine and the port's with the same options ``kw``, each
    run to the end and closed.  Returns (reference engine, port engine,
    rids) — the two engines number requests alike."""
    engines = []
    for make, cfg in ((ref_engine, jcfg), (port_engine, tcfg)):
        eng = make(tree, cfg, **kw)
        rids = [eng.submit(c[0], c[1], *c[2:]) for c in cases]
        eng.run()
        eng.close()
        engines.append(eng)
    return engines[0], engines[1], rids


def assert_same_engines(ref, eng, rids, agreement=None):
    """Token for token and state for state equal requests (with
    ``agreement``, at least that share of equal tokens a request: the
    int8-KV bar), equal schedule-determined stats, and no page or prefix
    ref left over."""
    for rid in rids:
        a, b = ref.requests[rid], eng.requests[rid]
        assert a.state == b.state, (rid, a.state, b.state)
        if agreement is None:
            assert list(a.generated) == list(b.generated), rid
        else:
            assert len(a.generated) == len(b.generated), rid
            assert np.mean(np.equal(a.generated, b.generated)) >= \
                agreement, (rid, a.generated, b.generated)
        assert a.prefix_hit_tokens == b.prefix_hit_tokens, rid
    assert {k: ref.stats[k] for k in ENGINE_STATS} == \
        {k: eng.stats[k] for k in ENGINE_STATS}
    assert_no_leak(eng)


def assert_no_leak(eng):
    """Every page in use is a cached prefix page, and no ref is held."""
    cached = 0 if eng.prefix is None else eng.prefix.cached_pages
    assert eng.cache.pages_in_use == cached
    if eng.prefix is not None:
        assert eng.prefix.refs_total == 0


# ------------------------------------------------------------- op library --
# One spec per case of each op of the NDArray op library: its inputs
# (made with numpy from a seed), its attributes, its tolerance family and
# whether it is differentiated.  The CPU parity tests run each case
# through both packages; chip_smoke.py runs each through the port on the
# card and on the CPU.  An input kind: "n" normal, "u" uniform in
# (-0.9, 0.9), "p" in (0.5, 2), "g" in (1.1, 3), "s" distinct values
# (no ties, for sorting), "i" integer indices below ``k`` (as float32),
# "b" 0/1 floats, "c" a given array; "spd", "tril" matrices for linalg.

def nms_case(B, N, seed, classes=3, device="cpu"):
    """Score-sorted boxes in three clusters an image (so that many
    overlap), 10% invalid rows and class ids."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0.2, 0.8, (B, 3, 2))
    c = centres[np.arange(B)[:, None], rng.randint(0, 3, (B, N))] \
        + rng.normal(0, 0.08, (B, N, 2))
    wh = rng.uniform(0.05, 0.3, (B, N, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 2).astype(np.float32)
    valid = rng.rand(B, N) > 0.1
    ids = rng.randint(0, classes, (B, N)).astype(np.float32)
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(ids).to(device))


# (rtol, atol) of each family, port against reference on the CPU (f32):
#   exact   - data movement, indexing, comparisons: nothing to round
#   arith   - one or two roundings (+, *, /, casts): 1 ulp either way
#   transc  - XLA's and torch's own exp/log/tanh/pow approximations
#             differ by a few ulp
#   special - lgamma, digamma, erfinv: different series, ~1e-5
#   reduce  - sums in another order (prod/norm of 8-64 terms)
#   linalg  - LAPACK paths in another blocking (f32, n <= 6)
TOL = {"exact": (0.0, 0.0), "arith": (2e-6, 1e-6), "transc": (1e-5, 1e-6),
       "special": (1e-4, 1e-5), "reduce": (1e-5, 1e-5),
       "linalg": (1e-4, 1e-5)}
# the same families, the card against the CPU (TF32 off): CUDA's libm
# and reductions round differently from the CPU's
CARD_TOL = {"exact": (0.0, 0.0), "arith": (2e-6, 1e-6),
            "transc": (1e-5, 1e-6), "special": (1e-4, 1e-5),
            "reduce": (1e-5, 1e-5), "linalg": (1e-4, 1e-4)}
# gradients get the family's limit times this (one more chain rule)
GRAD_FACTOR = 4.0


class Spec:
    """One case of op ``name``.  ``grad``: differentiate (the first
    output, or ``grad_out``) through autograd in both packages; ``fd``:
    also hold the port's gradient against float64 finite differences.
    ``variadic``: the inputs go as one list.  ``ref``: the reference
    runs the case (False where its op cannot, see ROADMAP.md §C; then
    ``expect`` computes the answer in numpy).  ``fd_sym``: the finite
    differences perturb a symmetric input symmetrically (a gradient
    defined for symmetric matrices, as Cholesky's)."""

    def __init__(self, name, inputs=(), attrs=None, fam="arith", grad=True,
                 fd=True, variadic=False, grad_out=0, cmp=None, ref=True,
                 expect=None, fd_sym=False):
        self.name, self.inputs = name, list(inputs)
        self.attrs = dict(attrs or {})
        self.fam, self.grad, self.fd = fam, grad, fd
        self.variadic, self.grad_out, self.cmp = variadic, grad_out, cmp
        self.ref, self.expect, self.fd_sym = ref, expect, fd_sym

    def __repr__(self):
        return "%s%s" % (self.name, "" if not self.attrs else
                         "(%s)" % ",".join("%s=%s" % kv for kv in
                                           sorted(self.attrs.items())))


_DIFF_KINDS = ("n", "u", "p", "g", "s", "spd", "tril")


def _n(*s): return ("n", s)
def _u(*s): return ("u", s)
def _p(*s): return ("p", s)
def _g(*s): return ("g", s)
def _s(*s): return ("s", s)
def _i(k, *s): return ("i", s, k)
def _ii(k, *s, lo=0): return ("ii", s, k, lo)
def _q8(*s): return ("q8", s)
def _u8(*s): return ("u8", s)
def _b(*s): return ("b", s)
def _c(a, dtype="float32"): return ("c", np.asarray(a, dtype=dtype))
def _h(*s): return ("n16", s)
def _box(*s): return ("box", s)
def _roi(R, N, H, W): return ("roi", (R, 5), (N, H, W))
def _rroi(R, N, H, W): return ("rroi", (R, 6), (N, H, W))
def _det(B, N, C): return ("det", (B, N, 6), C)
def _lab(B, M, C, pad): return ("lab", (B, M, 5), (C, pad))


def _boxes(rng, shape, lo=0.0, hi=1.0):
    """Corner boxes (..., 4) inside [lo, hi], each side 10-50% of it."""
    n = int(np.prod(shape[:-1]))
    span = hi - lo
    wh = rng.uniform(0.1, 0.5, (n, 2)) * span
    xy = lo + rng.uniform(0, 1, (n, 2)) * (span - wh)
    return np.concatenate([xy, xy + wh], 1).reshape(shape)


def _detection_input(kind, rng):
    """The detection ops' structured inputs: rois of images, SSD label
    rows (the last ``pad`` rows padded with class -1) and NMS rows
    [id, score, x0, y0, x1, y1] clustered so that boxes overlap."""
    k, shape = kind[0], kind[1]
    if k == "box":
        return _boxes(rng, shape).astype(np.float32)
    if k in ("roi", "rroi"):
        N, H, W = kind[2]
        R = shape[0]
        b = rng.randint(0, N, (R, 1))
        if k == "roi":
            return np.concatenate([b, _boxes(rng, (R, 4), 0, W - 1)],
                                  1).astype(np.float32)
        c = rng.uniform(0.25, 0.75, (R, 2)) * [W, H]
        wh = rng.uniform(0.2, 0.6, (R, 2)) * [W, H]
        ang = rng.uniform(-90, 90, (R, 1))
        return np.concatenate([b, c, wh, ang], 1).astype(np.float32)
    if k == "lab":
        C, pad = kind[2]
        B, M, _ = shape
        lab = np.concatenate([rng.randint(0, C, (B, M, 1)),
                              _boxes(rng, (B, M, 4))], 2)
        lab[:, M - pad:, 0] = -1
        return lab.astype(np.float32)
    if k == "det":
        B, N, _ = shape
        C = kind[2]
        centres = rng.uniform(0.2, 0.8, (B, 3, 2))
        c = centres[np.arange(B)[:, None], rng.randint(0, 3, (B, N))] \
            + rng.normal(0, 0.04, (B, N, 2))
        wh = rng.uniform(0.15, 0.3, (B, N, 2))
        return np.concatenate([
            rng.randint(0, C, (B, N, 1)), rng.uniform(-0.2, 1.0, (B, N, 1)),
            c - wh / 2, c + wh / 2], 2).astype(np.float32)
    raise ValueError(kind)


def make_input(kind, rng):
    k = kind[0]
    if k == "c":
        return kind[1].copy()
    shape = kind[1]
    if k == "n":
        return rng.randn(*shape).astype(np.float32)
    if k == "n16":
        return rng.randn(*shape).astype(np.float16)
    if k == "u":
        return rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    if k == "p":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if k == "g":
        return rng.uniform(1.1, 3.0, shape).astype(np.float32)
    if k == "s":
        n = int(np.prod(shape))
        return ((rng.permutation(n) - n / 2) * 0.25
                + rng.uniform(0, 0.1, n)).reshape(shape).astype(np.float32)
    if k == "i":
        return rng.randint(0, kind[2], shape).astype(np.float32)
    if k == "ii":
        return rng.randint(kind[3], kind[2], shape).astype(np.int32)
    if k == "q8":
        return rng.randint(-127, 128, shape).astype(np.int8)
    if k == "u8":
        return rng.randint(0, 256, shape).astype(np.uint8)
    if k == "b":
        return (rng.rand(*shape) > 0.5).astype(np.float32)
    if k == "spd":
        a = rng.randn(*shape).astype(np.float64)
        m = a @ np.swapaxes(a, -1, -2) + shape[-1] * np.eye(shape[-1])
        return m.astype(np.float32)
    if k in ("box", "roi", "rroi", "lab", "det"):
        return _detection_input(kind, rng)
    if k == "tril":
        a = np.tril(rng.randn(*shape)) + 3 * np.eye(shape[-1])
        return a.astype(np.float32)
    raise ValueError(kind)


def op_inputs(spec, seed):
    rng = np.random.RandomState(seed)
    return [make_input(k, rng) for k in spec.inputs]


def diff_inputs(spec, arrays):
    """Indices of the inputs a case differentiates."""
    return [j for j, (k, a) in enumerate(zip(spec.inputs, arrays))
            if k[0] in _DIFF_KINDS and a.dtype == np.float32]


def _outs(res):
    return list(res) if isinstance(res, (list, tuple)) else [res]


def run_case(mx, spec, arrays, ctx=None, name=None, head_seed=7):
    """``spec`` through package ``mx`` (either one) on ``arrays``:
    (outputs, the inputs after the call, gradients of the
    differentiated inputs or None), all numpy."""
    fn = op_function(mx, name or spec.name)
    kw = {} if ctx is None else {"ctx": ctx}
    creation = not arrays
    if creation and ctx is not None:
        def call(xs):
            return fn(**spec.attrs, **kw)
    else:
        def call(xs):
            return fn(xs, **spec.attrs) if spec.variadic \
                else fn(*xs, **spec.attrs)
    xs = [mx.nd.array(a, dtype=a.dtype, **kw) for a in arrays]
    outs = [o.asnumpy() for o in _outs(call(xs))]
    after = [x.asnumpy() for x in xs]
    grads = None
    wrt = diff_inputs(spec, arrays)
    if spec.grad and wrt and not op_no_grad(spec):
        xs = [mx.nd.array(a, dtype=a.dtype, **kw) for a in arrays]
        for j in wrt:
            xs[j].attach_grad()
        with mx.autograd.record():
            y = _outs(call(xs))[spec.grad_out]
        head = np.asarray(np.random.RandomState(head_seed).randn(*y.shape),
                          np.float32)
        y.backward(mx.nd.array(head, **kw))
        grads = [xs[j].grad.asnumpy() for j in wrt]
    return outs, after, grads


def op_function(mx, name):
    """``mx.nd.<name>``; an ``_np_*`` op, which neither package puts in
    ``nd``, through its registry's ``invoke`` (as ``mx.np`` calls it)."""
    if not name.startswith("_np_"):
        return getattr(mx.nd, name)
    reg = __import__(mx.__name__ + ".ops.registry", fromlist=["registry"])
    op = reg.get_op(name)

    def fn(*xs, ctx=None, **attrs):
        arrays = list(xs[0]) if op.variadic and xs else list(xs)
        return reg.invoke(op, arrays, (), attrs, ctx=ctx)
    return fn


def op_no_grad(spec):
    """The port's ``no_grad`` of the case's op (its outputs never enter
    autograd, in either package)."""
    from mxnet_tpu_torch.ops import registry as reg
    ng = reg.get_op(spec.name).no_grad
    return ng(spec.attrs) if callable(ng) else ng


def grad_tol(fam, table):
    """A gradient's limit: its family's times GRAD_FACTOR; an exact
    op's gradient sums broadcast or gathered cotangents in some order,
    so it gets ``arith``'s."""
    rtol, atol = table["arith" if fam == "exact" else fam]
    return rtol * GRAD_FACTOR, atol * GRAD_FACTOR


def ref_dtype(dt):
    """The dtype the reference gives where the port gives ``dt``: JAX
    runs without x64, so 64-bit results come back 32-bit."""
    dt = np.dtype(dt)
    return {np.dtype(np.int64): np.dtype(np.int32),
            np.dtype(np.float64): np.dtype(np.float32)}.get(dt, dt)


def canon(spec, outs):
    """Outputs in a comparable form: ``eig`` (syevd) and ``lq`` (gelqf)
    fix the sign of each eigenvector / each row of Q."""
    if spec.cmp == "eig":
        u, w = outs
        sgn = np.sign(np.take_along_axis(
            u, np.abs(u).argmax(-1)[..., None], -1))
        return [u * sgn, w]
    if spec.cmp == "lq":
        l, q = outs
        sgn = np.sign(np.diagonal(l, axis1=-2, axis2=-1))[..., None]
        return [l * np.swapaxes(sgn, -1, -2), q * sgn]
    if spec.cmp == "npeig":             # (w, v), v's columns the vectors
        w, v = outs
        sgn = np.sign(np.take_along_axis(
            v, np.abs(v).argmax(-2)[..., None, :], -2))
        return [w, v * sgn]
    if spec.cmp == "svd":               # (u, s, vh): u's columns, vh's rows
        u, sv, vh = outs
        sgn = np.sign(np.take_along_axis(
            u, np.abs(u).argmax(-2)[..., None, :], -2))
        return [u * sgn, sv, vh * np.swapaxes(sgn, -1, -2)]
    return outs


def assert_close(got, want, tol, what):
    rtol, atol = tol
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if rtol == 0 and atol == 0:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=what)


def check_against_reference(spec, seed=0, name=None, unjitted=False):
    """The case through the reference and the port (CPU): outputs,
    output dtypes, mutated inputs and gradients within the family's
    limit; with ``unjitted``, against the reference's ops run under
    ``jax.disable_jit()`` bit for bit (XLA:CPU's jit contracts
    multiply-adds into FMAs, which torch's CPU kernels do not)."""
    import mxnet_tpu_torch as P
    if unjitted:
        import jax
        with jax.disable_jit():
            spec = copy.copy(spec)
            if spec.fam != "reduce":    # a sum's order still differs
                spec.fam = "exact"
            return check_against_reference(spec, seed, name)
    arrays = op_inputs(spec, seed)
    p_outs, p_after, p_grads = run_case(P, spec, arrays, ctx=P.cpu(),
                                        name=name)
    if spec.expect is not None:
        want = spec.expect(*arrays)
        for o, w in zip(p_outs, _outs(want)):
            assert_close(o, np.asarray(w, o.dtype), TOL[spec.fam],
                         "%r expected" % spec)
        return
    r_outs, r_after, r_grads = run_case(reference, spec, arrays, name=name)
    tol = TOL[spec.fam]
    assert len(p_outs) == len(r_outs), spec
    for k, (p, r) in enumerate(zip(canon(spec, p_outs),
                                   canon(spec, r_outs))):
        assert ref_dtype(p.dtype) == r.dtype, (spec, k, p.dtype, r.dtype)
        assert_close(p, r.astype(p.dtype), tol, "%r output %d" % (spec, k))
    for k, (p, r) in enumerate(zip(p_after, r_after)):
        assert_close(p, r.astype(p.dtype), tol, "%r input %d" % (spec, k))
    if p_grads is not None:
        gtol = grad_tol(spec.fam, TOL)
        for k, (p, r) in enumerate(zip(p_grads, r_grads)):
            assert_close(p, r, gtol, "%r grad %d" % (spec, k))


def check_finite_differences(spec, seed=0):
    """The port's op (its plain torch impl) differentiated in float64
    against central differences (``torch.autograd.gradcheck``, fast
    mode)."""
    from mxnet_tpu_torch.ops import registry as reg
    op = reg.get_op(spec.name)
    arrays = op_inputs(spec, seed)
    wrt = diff_inputs(spec, arrays)
    ts = [torch.from_numpy(a.astype(np.float64) if j in wrt else a)
          .requires_grad_(j in wrt) for j, a in enumerate(arrays)]
    attrs = dict(spec.attrs)
    if op.training_aware:
        attrs.setdefault("_training", False)

    def fn(*xs):
        if spec.fd_sym:
            xs = [(x + x.transpose(-1, -2)) / 2 for x in xs]
        res = reg.invoke_impl(op, list(xs), (), attrs)
        return _outs(res)[spec.grad_out]

    # fast mode: the finite differences of random projections u^T J v
    # against the same projections of autograd's Jacobian (a full
    # Jacobian is one backward per output element, minutes for pad's)
    assert torch.autograd.gradcheck(fn, ts, eps=1e-6, atol=1e-5,
                                     rtol=1e-4, fast_mode=True)


def _unary_specs():
    plain = ["negative", "abs", "square", "degrees", "radians", "relu",
             "softsign", "hard_sigmoid", "identity", "sign", "floor",
             "ceil", "trunc", "rint", "round", "fix", "logical_not"]
    transc = {"exp": _n, "expm1": _n, "sin": _n, "cos": _n, "tan": _u,
              "arcsin": _u, "arccos": _u, "arctan": _n, "sinh": _n,
              "cosh": _n, "tanh": _n, "arcsinh": _n, "arccosh": _g,
              "arctanh": _u, "sigmoid": _n, "erf": _n, "erfc": _n,
              "sqrt": _p, "rsqrt": _p, "cbrt": _p, "rcbrt": _p, "log": _p,
              "log2": _p, "log10": _p, "log1p": _p, "reciprocal": _p}
    special = {"erfinv": _u, "gamma": _p, "gammaln": _p, "digamma": _p}
    out = [Spec(n, [_n(3, 4)]) for n in plain]
    out += [Spec(n, [k(3, 4)], fam="transc") for n, k in transc.items()]
    out += [Spec(n, [k(3, 4)], fam="special") for n, k in special.items()]
    return out


def _binary_specs():
    out = [Spec(n, [_n(3, 4), _n(1, 4)]) for n in
           ("broadcast_add", "broadcast_sub", "broadcast_mul",
            "broadcast_maximum", "broadcast_minimum")]
    out += [Spec("broadcast_div", [_n(3, 4), _p(3, 1)]),
            Spec("broadcast_mod", [_n(3, 4), _p(1, 4)]),
            Spec("_broadcast_floordiv", [_n(3, 4), _p(1, 4)]),
            Spec("broadcast_power", [_p(3, 4), _n(3, 4)], fam="transc"),
            Spec("broadcast_hypot", [_n(3, 4), _n(3, 4)], fam="transc"),
            Spec("arctan2", [_n(3, 4), _n(3, 4)], fam="transc"),
            Spec("_npi_matmul", [_n(2, 3, 4), _n(4, 5)])]
    cmp_in = [_i(3, 3, 4), _i(3, 3, 4)]
    out += [Spec(n, cmp_in, fam="exact") for n in
            ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
             "broadcast_greater_equal", "broadcast_lesser",
             "broadcast_lesser_equal", "broadcast_logical_and",
             "broadcast_logical_or", "broadcast_logical_xor")]
    return out


def _scalar_specs():
    out = [Spec(n, [_n(3, 4)], {"scalar": 1.5}) for n in
           ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
            "_mul_scalar", "_div_scalar", "_mod_scalar",
            "_floordiv_scalar", "_maximum_scalar", "_minimum_scalar")]
    out += [Spec("_rdiv_scalar", [_p(3, 4)], {"scalar": 1.5}),
            Spec("_rmod_scalar", [_p(3, 4)], {"scalar": 2.5}),
            Spec("_power_scalar", [_p(3, 4)], {"scalar": 1.5},
                 fam="transc"),
            Spec("_rpower_scalar", [_n(3, 4)], {"scalar": 1.5},
                 fam="transc"),
            Spec("_plus_scalar", [_c([[1, 2], [3, 4]], "int32")],
                 {"scalar": 2.0}, fam="exact")]
    out += [Spec(n, [_i(3, 3, 4)], {"scalar": 1.0}, fam="exact") for n in
            ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
             "_greater_equal_scalar", "_lesser_scalar",
             "_lesser_equal_scalar")]
    return out


def _elemwise_specs():
    nan = [[1.0, np.nan, 2.0], [np.inf, -np.inf, 0.5]]
    return _unary_specs() + _binary_specs() + _scalar_specs() + [
        Spec("BlockGrad", [_n(3, 4)], grad=False),
        Spec("make_loss", [_n(3, 4)], {"grad_scale": 0.5}),
        Spec("clip", [_n(3, 4)], {"a_min": -0.5, "a_max": 0.7}),
        Spec("smooth_l1", [_n(3, 4)], {"scalar": 1.5}),
        Spec("Cast", [_n(3, 4)], {"dtype": "float16"}, grad=False),
        Spec("Cast", [_n(3, 4)], {"dtype": "int32"}, fam="exact",
             grad=False),
        Spec("amp_cast", [_h(3, 4)], {"dtype": "float32"}),
        Spec("amp_multicast", [_h(3, 4), _n(3, 4)], {"num_outputs": 2},
             variadic=True, grad=False),
        Spec("amp_multicast", [_h(3, 4), _n(3, 4)],
             {"num_outputs": 2, "cast_narrow": True}, variadic=True,
             grad=False),
        Spec("add_n", [_n(3, 4), _n(3, 4), _n(3, 4)], variadic=True),
        Spec("where", [_b(3, 4), _n(3, 4), _n(3, 4)]),
        Spec("all_finite", [_c(nan)], fam="exact"),
        Spec("all_finite", [_n(3, 4)], fam="exact", grad=False),
        Spec("multi_all_finite", [_n(3, 4), _n(2)], {"num_arrays": 2},
             variadic=True, fam="exact", grad=False),
        Spec("multi_all_finite", [_n(3, 4), _c(nan)], {"num_arrays": 2},
             variadic=True, fam="exact", grad=False),
        Spec("isnan", [_c(nan)], fam="exact"),
        Spec("isinf", [_c(nan)], fam="exact"),
        Spec("isfinite", [_c(nan)], fam="exact"),
    ]


def _topk(ret, **kw):
    return Spec("topk", [_s(3, 5)], dict(k=2, ret_typ=ret, **kw),
                fam="exact", fd=ret != "mask")


def _reduce_specs():
    nan = [[1.0, np.nan, 2.0], [0.5, 3.0, np.nan]]
    return [
        Spec("sum", [_n(3, 4, 2)], {"axis": (0, 2)}, fam="reduce"),
        Spec("sum", [_n(3, 4)], {"axis": 1, "exclude": True,
                                 "keepdims": True}, fam="reduce"),
        Spec("mean", [_n(3, 4)], fam="reduce"),
        Spec("prod", [_p(3, 4, 2)], {"axis": (0, 2)}, fam="reduce"),
        Spec("prod", [_p(3, 4)], fam="reduce"),
        Spec("max", [_s(3, 4, 2)], {"axis": 1, "keepdims": True}),
        Spec("max", [_s(3, 4)], {"axis": 1, "exclude": True}),
        Spec("min", [_s(3, 4, 2)], {"axis": (0, 1)}),
        Spec("nansum", [_c(nan)], {"axis": 1}, fam="reduce"),
        Spec("nanprod", [_c(nan)], {"axis": 1}, fam="reduce"),
        Spec("argmax", [_s(3, 4)], {"axis": 1}, fam="exact"),
        Spec("argmax", [_s(3, 4)], {"axis": 0, "keepdims": True},
             fam="exact"),
        Spec("argmax", [_s(3, 4)], fam="exact"),
        Spec("argmin", [_s(3, 4)], {"axis": 1}, fam="exact"),
        Spec("argmax_channel", [_s(3, 4)], fam="exact"),
        Spec("norm", [_n(3, 4)], fam="reduce"),
        Spec("norm", [_n(3, 4)], {"ord": 1, "axis": 1}, fam="reduce"),
        Spec("norm", [_n(3, 4, 2)], {"axis": (1, 2), "keepdims": True},
             fam="reduce"),
        Spec("L2Normalization", [_n(2, 3, 4)], fam="reduce"),
        Spec("L2Normalization", [_n(2, 3, 4)], {"mode": "channel"},
             fam="reduce"),
        Spec("L2Normalization", [_n(2, 3, 4)], {"mode": "spatial"},
             fam="reduce"),
        Spec("sort", [_s(3, 5)], fam="exact"),
        Spec("sort", [_s(3, 5)], {"axis": 0, "is_ascend": False},
             fam="exact"),
        Spec("sort", [_s(3, 5)], {"axis": None}, fam="exact"),
        Spec("argsort", [_s(3, 5)], fam="exact"),
        Spec("argsort", [_s(3, 5)], {"is_ascend": False,
                                     "dtype": "int32"}, fam="exact"),
        _topk("indices"), _topk("value"), _topk("both"), _topk("mask"),
        _topk("value", is_ascend=True, axis=0),
        _topk("both", dtype="int32", axis=None),
        Spec("cumsum", [_n(3, 4)], {"axis": 1}, fam="reduce"),
        Spec("cumsum", [_n(3, 4)], fam="reduce"),
        Spec("cumsum", [_c([[1, 2], [3, 4]], "int32")], {"axis": 0},
             fam="exact"),
    ]


def _shape_specs():
    F = "exact"
    return [
        Spec("reshape", [_n(2, 3, 4)], {"shape": (0, -1)}, fam=F),
        Spec("reshape", [_n(2, 3, 4)], {"shape": (-3, 0)}, fam=F),
        Spec("reshape", [_n(2, 3, 4)], {"shape": (2, -2)}, fam=F),
        Spec("reshape", [_n(2, 6, 4)], {"shape": (0, -4, 2, -1, 0)},
             fam=F),
        Spec("reshape", [_n(2, 3, 4)], {"shape": (-1, 4),
                                        "reverse": True}, fam=F),
        Spec("reshape_like", [_n(2, 6), _n(3, 4)], fam=F),
        Spec("Flatten", [_n(2, 3, 4)], fam=F),
        Spec("pick", [_n(3, 4), _c([0, 3, 5])], {"axis": 1}, fam=F),
        Spec("pick", [_n(3, 4), _c([0, 2, 1, 1])],
             {"axis": 0, "keepdims": True}, fam=F),
        Spec("shape_array", [_n(2, 3, 4)], fam=F),
        Spec("size_array", [_n(2, 3, 4)], fam=F),
        Spec("transpose", [_n(2, 3, 4)], fam=F),
        Spec("transpose", [_n(2, 3, 4)], {"axes": (1, 0, 2)}, fam=F),
        Spec("swapaxes", [_n(2, 3, 4)], {"dim1": 0, "dim2": 2}, fam=F),
        Spec("expand_dims", [_n(2, 3)], {"axis": 1}, fam=F),
        Spec("expand_dims", [_n(2, 3)], {"axis": -1}, fam=F),
        Spec("squeeze", [_n(2, 1, 3, 1)], fam=F),
        Spec("squeeze", [_n(2, 1, 3, 1)], {"axis": 1}, fam=F),
        Spec("flip", [_n(2, 3, 4)], {"axis": 1}, fam=F),
        Spec("flip", [_n(2, 3, 4)], {"axis": (0, 2)}, fam=F),
        Spec("tile", [_n(2, 3)], {"reps": (2, 1, 2)}, fam=F),
        Spec("repeat", [_n(2, 3)], {"repeats": 2, "axis": 1}, fam=F),
        Spec("repeat", [_n(2, 3)], {"repeats": 3}, fam=F),
        Spec("broadcast_to", [_n(1, 3)], {"shape": (2, 4, 0)}, fam=F),
        Spec("_onnx_expand", [_n(3, 1)], {"shape": (2, 1, 4)}, fam=F),
        Spec("broadcast_like", [_n(1, 3), _n(4, 3)], fam=F),
        Spec("broadcast_axis", [_n(1, 3, 1)], {"axis": (0, 2),
                                               "size": (2, 4)}, fam=F),
        Spec("Concat", [_n(2, 3), _n(2, 2)], {"dim": 1}, variadic=True,
             fam=F),
        Spec("stack", [_n(2, 3), _n(2, 3)], {"axis": 1}, variadic=True,
             fam=F),
        Spec("split", [_n(2, 6)], {"num_outputs": 3, "axis": 1}, fam=F),
        Spec("split", [_n(3, 2)], {"num_outputs": 3, "axis": 0,
                                   "squeeze_axis": True}, fam=F),
        Spec("split_v2", [_n(2, 7)], {"indices_or_sections": (2, 5),
                                      "axis": 1}, fam=F),
        Spec("split_v2", [_n(4, 2)], {"sections": 2}, fam=F),
        Spec("slice", [_n(4, 5)], {"begin": (1, None), "end": (3, None)},
             fam=F),
        Spec("slice", [_n(4, 5)], {"begin": (None, 4), "end": (None, 0),
                                   "step": (2, -2)}, fam=F),
        Spec("slice_axis", [_n(4, 5)], {"axis": 1, "begin": 1, "end": -1},
             fam=F),
        Spec("slice_like", [_n(4, 5), _n(2, 3)], fam=F),
        Spec("slice_like", [_n(4, 5), _n(2, 3)], {"axes": (1,)}, fam=F),
        Spec("take", [_n(5, 3), _c([[0, 4], [6, -1]])], fam=F),
        Spec("take", [_n(3, 5), _c([0, 6, -1, 2])], {"axis": 1,
                                                    "mode": "wrap"}, fam=F),
        Spec("gather_nd", [_n(3, 4), _c([[0, 2], [1, 3]])], fam=F),
        Spec("scatter_nd", [_n(3), _c([[0, 2, 0], [1, 3, 1]])],
             {"shape": (3, 4)}, fam=F),
        Spec("one_hot", [_c([0, 2, 5, -1])], {"depth": 4}, fam=F),
        Spec("one_hot", [_c([[0, 1], [2, 3]])],
             {"depth": 3, "on_value": 2.0, "off_value": -1.0,
              "dtype": "int32"}, fam=F),
        Spec("SequenceMask", [_n(4, 3, 2), _c([1, 4, 2])],
             {"use_sequence_length": True, "value": -1.0}, fam=F),
        Spec("SequenceMask", [_n(3, 4, 2), _c([1, 4, 2])],
             {"use_sequence_length": True, "axis": 1}, fam=F),
        Spec("SequenceLast", [_n(4, 3, 2), _c([1, 4, 2])],
             {"use_sequence_length": True}, fam=F),
        Spec("SequenceLast", [_n(4, 3, 2)], fam=F),
        Spec("SequenceReverse", [_n(4, 3, 2), _c([1, 4, 2])],
             {"use_sequence_length": True}, fam=F),
        Spec("SequenceReverse", [_n(4, 3, 2)], fam=F),
        Spec("pad", [_n(2, 2, 3, 4)], {"mode": "constant",
                                        "pad_width": (0, 0, 1, 0, 1, 2, 2, 1),
                                        "constant_value": 0.5}, fam=F),
        Spec("pad", [_n(2, 2, 3, 4)], {"mode": "edge",
                                        "pad_width": (1, 0, 0, 1, 1, 2, 2, 1)},
             fam=F),
        Spec("pad", [_n(2, 3, 3, 4)], {"mode": "reflect",
                                        "pad_width": (1, 1, 2, 0, 1, 2, 2, 3)},
             fam=F),
        Spec("diag", [_n(4)], {"k": 1}, fam=F),
        Spec("diag", [_n(3, 4)], {"k": -1}, fam=F),
        Spec("diag", [_n(2, 3, 4)], {"axis1": 1, "axis2": 2}, fam=F),
        Spec("zeros_like", [_n(2, 3)], fam=F, grad=False),
        Spec("ones_like", [_n(2, 3)], fam=F, grad=False),
        Spec("_full_like", [_n(2, 3)], {"fill_value": 2.5}, fam=F,
             grad=False),
        Spec("_zeros", [], {"shape": (2, 3)}, fam=F),
        Spec("_ones", [], {"shape": (2, 3), "dtype": "int32"}, fam=F),
        Spec("_arange", [], {"start": 2, "stop": 9, "step": 1.5}, fam=F),
        Spec("_arange", [], {"start": 5, "repeat": 2, "dtype": "int32"},
             fam=F),
        Spec("_eye", [], {"N": 3, "M": 4, "k": 1}, fam=F),
        Spec("_linspace", [], {"start": -1.0, "stop": 2.0, "num": 7},
             fam="arith"),
        Spec("_linspace", [], {"start": 0.0, "stop": 1.0, "num": 4,
                               "endpoint": False}, fam="arith"),
        Spec("batch_take", [_n(4, 3), _c([0, 2, 1, 2])], fam=F),
        Spec("unravel_index", [_c([3, 5, 0])], {"shape": (2, 3)}, fam=F),
        Spec("ravel_multi_index", [_c([[1, 0, 1], [0, 2, 1]])],
             {"shape": (2, 3)}, fam=F),
        Spec("_contrib_arange_like", [_n(2, 3)], {"start": 1.0,
                                                  "step": 0.5}, fam=F),
        Spec("_contrib_arange_like", [_n(2, 5)], {"axis": 1, "repeat": 2},
             fam=F),
        Spec("_contrib_index_copy", [_n(4, 3), _c([2, 0]), _n(2, 3)],
             fam=F),
        Spec("_contrib_index_array", [_n(2, 3)], fam=F),
        Spec("_contrib_index_array", [_n(2, 3, 2)], {"axes": (2, 0)},
             fam=F),
        Spec("_contrib_boolean_mask", [_n(4, 3), _c([1, 0, 1, 1])],
             fam=F),
        Spec("fill_element_0index", [_n(3, 4), _n(3), _c([1, 3, 0])],
             fam=F),
        Spec("space_to_depth", [_n(1, 2, 4, 4)], {"block_size": 2}, fam=F),
        Spec("depth_to_space", [_n(1, 8, 2, 2)], {"block_size": 2}, fam=F),
    ]


def _creation_specs():
    return [Spec("_full", [], {"shape": (2, 3), "value": 1.5},
                 fam="exact"),
            Spec("_full", [], {"shape": 4, "value": 7, "dtype": "int32"},
                 fam="exact")]


def _softmax_length(x, length):
    x = np.asarray(x, np.float64)
    mask = np.arange(x.shape[-1])[None, :] < np.asarray(length)[:, None]
    e = np.where(mask, np.exp(x - x.max(-1, keepdims=True)), 0.0)
    return e / e.sum(-1, keepdims=True)


def _nn_specs():
    ctc_lab = [[1, 2, 2, 0], [3, 1, 0, 0]]
    return [
        Spec("dot", [_n(3, 4), _n(4, 5)], fam="reduce"),
        Spec("dot", [_n(4, 3), _n(2, 5, 4)], {"transpose_a": True,
                                               "transpose_b": True},
             fam="reduce"),
        Spec("FullyConnected", [_n(2, 3, 4), _n(5, 12), _n(5)],
             {"num_hidden": 5}, fam="reduce"),
        Spec("Convolution", [_n(2, 3, 6, 6), _n(4, 3, 3, 3), _n(4)],
             {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1),
              "stride": (2, 2)}, fam="reduce"),
        Spec("Pooling", [_s(2, 3, 6, 6)], {"kernel": (3, 3),
                                            "stride": (2, 2),
                                            "pool_type": "max"}),
        Spec("Pooling", [_n(2, 3, 7, 7)], {"kernel": (3, 3),
                                            "stride": (2, 2), "pad": (1, 1),
                                            "pool_type": "avg",
                                            "count_include_pad": False},
             fam="reduce"),
        Spec("Activation", [_n(3, 4)], {"act_type": "softrelu"},
             fam="transc"),
        Spec("softmax", [_n(3, 4)], {"axis": 0, "temperature": 2.0},
             fam="transc"),
        Spec("log_softmax", [_n(3, 4)], fam="transc"),
        Spec("SoftmaxOutput", [_n(4, 5), _c([0, 3, 4, 1])],
             {"normalization": "batch"}, fam="transc", fd=False),
        Spec("Dropout", [_n(3, 4)], {"p": 0.5}, grad=False),
        Spec("Embedding", [_c([[0, 2], [3, 1]]), _n(4, 5)],
             {"input_dim": 4, "output_dim": 5}, fam="exact"),
        Spec("batch_dot", [_n(2, 3, 4), _n(2, 4, 5)]),
        Spec("batch_dot", [_n(2, 4, 3), _n(2, 5, 4)],
             {"transpose_a": True, "transpose_b": True}),
        Spec("khatri_rao", [_n(2, 3), _n(4, 3)], variadic=True),
        Spec("Deconvolution", [_n(2, 3, 5, 5), _n(3, 4, 3, 3)],
             {"kernel": (3, 3), "num_filter": 4, "stride": (2, 2),
              "pad": (1, 1), "adj": (1, 1)}, fam="reduce"),
        Spec("Deconvolution", [_n(2, 3, 6), _n(3, 2, 3), _n(2)],
             {"kernel": (3,), "num_filter": 2, "no_bias": False,
              "dilate": (2,)}, fam="reduce"),
        Spec("Pooling", [_n(2, 3, 6, 6)], {"kernel": (3, 3),
                                            "stride": (2, 2), "pad": (1, 1),
                                            "pool_type": "sum"},
             fam="reduce"),
        Spec("Pooling", [_n(2, 3, 7)], {"kernel": (3,), "stride": (2,),
                                         "pool_type": "lp", "p_value": 2,
                                         "pooling_convention": "full"},
             fam="transc"),
        Spec("Pooling", [_n(2, 3, 4, 4)], {"global_pool": True,
                                            "pool_type": "lp",
                                            "p_value": 3}, fam="transc"),
        Spec("Pooling", [_n(2, 3, 4, 4)], {"global_pool": True,
                                            "pool_type": "sum"},
             fam="reduce"),
        Spec("UpSampling", [_n(2, 3, 2, 2)], {"scale": 2}, variadic=True,
             fam="exact"),
        Spec("UpSampling", [_n(2, 3, 2, 2), _n(2, 3, 2, 2)],
             {"scale": 2, "num_args": 2, "multi_input_mode": "sum"},
             variadic=True),
        Spec("UpSampling", [_n(2, 3, 2, 2), _n(2, 1, 2, 2)],
             {"scale": 3, "num_args": 2}, variadic=True, fam="exact"),
        Spec("LeakyReLU", [_n(3, 4)], {"slope": 0.1}),
        Spec("LeakyReLU", [_n(2, 3, 4), _p(3)], {"act_type": "prelu"}),
        Spec("LeakyReLU", [_n(3, 4)], {"act_type": "elu", "slope": 0.5},
             fam="transc"),
        Spec("LeakyReLU", [_n(3, 4)], {"act_type": "selu"}, fam="transc"),
        Spec("LeakyReLU", [_n(3, 4)], {"act_type": "gelu"}, fam="transc"),
        Spec("LeakyReLU", [_n(3, 4)], {"act_type": "rrelu"}),
        Spec("softmax", [_n(2, 5), _c([2, 5])], {"use_length": True},
             fam="transc", ref=False, expect=_softmax_length, fd=True),
        Spec("softmin", [_n(3, 4)], {"axis": 0}, fam="transc"),
        Spec("softmax_cross_entropy", [_n(4, 5), _c([0, 3, 4, 1])],
             fam="transc"),
        Spec("LinearRegressionOutput", [_n(4, 3), _n(4, 3)],
             {"grad_scale": 2.0}, fd=False),
        Spec("LogisticRegressionOutput", [_n(4, 3), _b(4, 3)],
             fam="transc", fd=False),
        Spec("MAERegressionOutput", [_n(4, 3), _n(4, 3)], fd=False),
        Spec("BatchNorm", [_n(4, 3, 2), _p(3), _n(3), _n(3), _p(3)],
             {"output_mean_var": True, "fix_gamma": False},
             fam="reduce", fd=False),
        Spec("LayerNorm", [_n(3, 4, 5), _p(5), _n(5)], fam="reduce"),
        Spec("LayerNorm", [_n(3, 4, 5), _p(4), _n(4)], {"axis": 1},
             fam="reduce"),
        Spec("InstanceNorm", [_n(2, 3, 4, 2), _p(3), _n(3)], fam="reduce"),
        Spec("GroupNorm", [_n(2, 4, 3, 2), _p(4), _n(4)],
             {"num_groups": 2}, fam="reduce"),
        Spec("CTCLoss", [_n(6, 2, 5), _c(ctc_lab)], fam="transc"),
        Spec("CTCLoss", [_n(6, 2, 5), _c([[0, 1, 1], [2, -1, -1]])],
             {"blank_label": "last"}, fam="transc"),
        Spec("CTCLoss", [_n(6, 2, 5), _c(ctc_lab), _c([6, 4]),
                         _c([3, 2])],
             {"use_data_lengths": True, "use_label_lengths": True},
             fam="transc"),
        # no alignment fits: the loss is optax's -1e5 "log 0" sentinel
        # arithmetic, its f32 gradient rounding noise in both packages
        Spec("CTCLoss", [_n(2, 2, 5), _c([[1, 1, 1], [2, 3, 4]])],
             fam="transc", grad=False),
        Spec("LRN", [_n(2, 6, 3, 3)], {"nsize": 3}, fam="transc",
             fd=False),
        Spec("log_sigmoid", [_n(3, 4)], fam="transc"),
        Spec("mish", [_n(3, 4)], fam="transc"),
        Spec("masked_softmax", [_n(3, 4), _c([[1, 0, 1, 1], [1, 1, 1, 1],
                                             [0, 1, 0, 0]])],
             {"temperature": 2.0}, fam="transc"),
        Spec("softmax_activation", [_n(2, 3, 4)], fam="transc"),
        Spec("softmax_activation", [_n(2, 3, 4)], {"mode": "channel"},
             fam="transc"),
        Spec("im2col", [_n(2, 3, 5, 5)], {"kernel": (3, 3),
                                           "stride": (2, 2),
                                           "pad": (1, 1)}, fam="exact"),
        Spec("im2col", [_n(1, 2, 6, 5)], {"kernel": (2, 2),
                                           "dilate": (2, 1)}, fam="exact"),
        Spec("col2im", [_n(2, 27, 9)], {"output_size": (5, 5),
                                         "kernel": (3, 3),
                                         "stride": (2, 2), "pad": (1, 1)}),
        Spec("Crop", [_n(1, 2, 5, 6)], {"h_w": (3, 4),
                                         "offset": (1, 2)}, fam="exact"),
        Spec("Crop", [_n(1, 2, 5, 6), _n(1, 2, 3, 3)],
             {"center_crop": True, "num_args": 2}, fam="exact"),
        Spec("IdentityAttachKLSparseReg", [_c(
            np.random.RandomState(3).uniform(0.1, 0.9, (4, 3)))],
            {"sparseness_target": 0.2, "penalty": 0.01}, fd=False),
    ]


def _linalg_specs():
    L = "linalg"
    return [
        Spec("_linalg_gemm", [_n(2, 3, 4), _n(2, 4, 5), _n(2, 3, 5)],
             {"alpha": 0.5, "beta": 2.0}, fam=L),
        Spec("_linalg_gemm", [_n(4, 3), _n(5, 4), _n(3, 5)],
             {"transpose_a": True, "transpose_b": True}, fam=L),
        Spec("_linalg_gemm2", [_n(2, 3, 4), _n(2, 5, 4)],
             {"transpose_b": True, "alpha": 2.0}, fam=L),
        Spec("_linalg_potrf", [("spd", (2, 4, 4))], fam=L, fd_sym=True),
        Spec("_linalg_potri", [("tril", (2, 4, 4))], fam=L),
        Spec("_linalg_trsm", [("tril", (4, 4)), _n(4, 3)],
             {"alpha": 2.0}, fam=L),
        Spec("_linalg_trsm", [("tril", (4, 4)), _n(4, 3)],
             {"transpose": True}, fam=L),
        Spec("_linalg_trsm", [("tril", (4, 4)), _n(3, 4)],
             {"rightside": True}, fam=L),
        Spec("_linalg_trsm", [("tril", (4, 4)), _n(3, 4)],
             {"rightside": True, "transpose": True}, fam=L),
        Spec("_linalg_trmm", [_n(4, 4), _n(4, 3)], {"alpha": 0.5}, fam=L),
        Spec("_linalg_trmm", [_n(4, 4), _n(3, 4)],
             {"rightside": True, "transpose": True, "lower": False},
             fam=L),
        Spec("_linalg_syrk", [_n(2, 3, 4)], {"alpha": 2.0}, fam=L),
        Spec("_linalg_syrk", [_n(3, 4)], {"transpose": True}, fam=L),
        Spec("_linalg_syevd", [("spd", (4, 4))], fam=L, grad=False,
             cmp="eig"),
        Spec("_linalg_gelqf", [_n(3, 5)], fam=L, grad=False, cmp="lq"),
        Spec("_linalg_sumlogdiag", [("spd", (2, 4, 4))], fam=L),
        Spec("_linalg_extractdiag", [_n(2, 4, 4)], {"offset": 1},
             fam="exact"),
        Spec("_linalg_makediag", [_n(2, 3)], {"offset": -1},
             fam="exact"),
        Spec("_linalg_extracttrian", [_n(2, 4, 4)], {"offset": 1,
                                                     "lower": False},
             fam="exact"),
        Spec("_linalg_extracttrian", [_n(4, 4)], fam="exact"),
        Spec("_linalg_inverse", [("spd", (2, 3, 3))], fam=L),
        Spec("_linalg_det", [("spd", (2, 3, 3))], fam=L),
        Spec("_linalg_slogdet", [_n(2, 3, 3)], fam=L, grad_out=1),
        Spec("moments", [_n(3, 4, 2)], {"axes": (0, 2)}, fam="reduce"),
        Spec("moments", [_n(3, 4)], {"keepdims": True}, fam="reduce"),
        Spec("_contrib_fft", [_n(2, 8)], fam=L, fd=False),
        Spec("_contrib_ifft", [_n(2, 16)], fam=L, fd=False),
    ]


def _contrib_specs():
    qkv = _n(4, 2, 2 * 3 * 3)
    return [
        Spec("_contrib_interleaved_matmul_selfatt_qk", [qkv], {"heads": 2},
             fam="reduce"),
        Spec("_contrib_interleaved_matmul_selfatt_valatt",
             [qkv, _n(4, 4, 4)], {"heads": 2}, fam="reduce"),
        Spec("_contrib_interleaved_matmul_encdec_qk",
             [_n(3, 2, 6), _n(4, 2, 12)], {"heads": 2}, fam="reduce"),
        Spec("_contrib_interleaved_matmul_encdec_valatt",
             [_n(4, 2, 12), _n(4, 3, 4)], {"heads": 2}, fam="reduce"),
        Spec("_contrib_div_sqrt_dim", [_n(2, 3, 4)]),
        Spec("masked_log_softmax", [_n(3, 4), _c([[1, 0, 1, 1],
                                                  [1, 1, 1, 1],
                                                  [0, 1, 0, 0]])],
             {"temperature": 0.5}, fam="transc", grad=False),
        Spec("_contrib_quadratic", [_n(3, 4)], {"a": 0.5, "b": -1.0,
                                               "c": 2.0}),
        Spec("_contrib_gradientmultiplier", [_n(3, 4)], {"scalar": -0.5},
             fd=False),
        Spec("_contrib_allclose", [_n(3, 4), _n(3, 4)], fam="exact"),
        Spec("_contrib_allclose", [_c([1.0, 2.0]), _c([1.0, 2.0 + 1e-6])],
             fam="exact"),
        Spec("_contrib_getnnz", [_b(3, 4)], fam="exact"),
        Spec("_contrib_getnnz", [_b(3, 4)], {"axis": 1}, fam="exact"),
        Spec("_contrib_count_sketch", [_n(3, 5), _c([0, 2, 1, 2, 0]),
                                       _c([1, -1, 1, 1, -1])],
             {"out_dim": 3}, fam="arith", grad=False),
        Spec("_contrib_SyncBatchNorm",
             [_n(4, 3, 2), _p(3), _n(3), _n(3), _p(3)],
             {"fix_gamma": False}, fam="reduce", fd=False),
    ]


RNN_SHAPE = (5, 3, 4, 6)          # T, N, input width I, hidden H


def rnn_param_size(mode, num_layers, input_size, H, bidirectional=False):
    """The fused op's packed parameter count (both packages')."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size as size
    return size(mode, num_layers, input_size, H, bidirectional)


def _rnn_specs():
    """The fused ``RNN`` (with initial states) and ``_rnn_nostate``, one
    case for each mode; the recurrence's matmuls, tanh and sigmoid give
    them the ``transc`` limits (measured worst over 5 steps: 0.30 of the
    limit, 4.8e-6 absolute in a gradient)."""
    T, N, I, H = RNN_SHAPE
    specs = []
    for mode, L, bi in (("lstm", 2, True), ("gru", 2, True),
                        ("rnn_tanh", 1, False), ("rnn_relu", 2, True)):
        D = 2 if bi else 1
        attrs = {"state_size": H, "num_layers": L, "mode": mode,
                 "bidirectional": bi}
        params = _u(rnn_param_size(mode, L, I, H, bi))
        states = [_n(L * D, N, H)] * (2 if mode == "lstm" else 1)
        specs.append(Spec("RNN", [_n(T, N, I), params] + states,
                          dict(attrs, state_outputs=True), fam="transc"))
        specs.append(Spec("_rnn_nostate", [_n(T, N, I), params], attrs,
                          fam="transc"))
    return specs


def _vision_specs():
    """``ops/vision.py``.  NMS keep decisions, class ids and ranks are
    exact; the box decode and the targets' logs are ``transc`` (XLA's
    exp/log and its contracted multiply-adds); the samplers' blends
    ``arith``; the integral image and the correlation's channel sums
    ``reduce``."""
    X = "exact"
    dets = _det(2, 12, 3)
    return [
        Spec("_contrib_box_iou", [_box(3, 4), _box(2, 5, 4)]),
        Spec("_contrib_box_iou", [_box(4, 4), _box(3, 4)],
             {"format": "center"}),
        Spec("_contrib_box_nms", [dets], fam=X, grad=False),
        Spec("_contrib_box_nms", [dets], {"overlap_thresh": 0.3, "topk": 5,
                                          "id_index": 0,
                                          "background_id": 1}, fam=X,
             grad=False),
        Spec("_contrib_box_nms", [dets], {"id_index": 0,
                                          "force_suppress": True,
                                          "valid_thresh": 0.3}, fam=X,
             grad=False),
        Spec("_contrib_box_nms", [_det(3, 8, 2)],
             {"in_format": "center", "out_format": "corner",
              "overlap_thresh": 0.2}, grad=False),
        Spec("MultiBoxPrior", [_n(1, 3, 4, 5)],
             {"sizes": (0.5, 0.25), "ratios": (1.0, 2.0, 0.5)}, grad=False),
        Spec("MultiBoxPrior", [_n(2, 1, 3, 3)],
             {"sizes": (0.55, 0.4, 0.3), "ratios": (1.0, 1.6), "clip": True,
              "steps": (0.3, 0.3), "offsets": (0.4, 0.6)}, grad=False),
        Spec("MultiBoxTarget", [_box(1, 20, 4), _lab(2, 4, 3, 1),
                                _n(2, 4, 20)],
             {"overlap_threshold": 0.3}, fam="transc"),
        Spec("MultiBoxTarget", [_box(1, 30, 4), _lab(3, 5, 2, 2),
                                _n(3, 3, 30)],
             {"overlap_threshold": 0.4, "negative_mining_ratio": 2.0,
              "negative_mining_thresh": 0.3,
              "minimum_negative_samples": 2}, fam="transc"),
        Spec("MultiBoxDetection", [_u(2, 4, 30), _u(2, 120), _box(1, 30, 4)],
             {"threshold": 0.2, "nms_threshold": 0.3}, fam="transc"),
        Spec("MultiBoxDetection", [_u(2, 4, 30), _u(2, 120), _box(1, 30, 4)],
             {"threshold": 0.1, "nms_threshold": 0.3, "nms_topk": 6,
              "force_suppress": True, "clip": False}, fam="transc"),
        Spec("ROIPooling", [_n(2, 3, 8, 9), _roi(4, 2, 8, 9)],
             {"pooled_size": (2, 3)}, fam=X),
        Spec("ROIPooling", [_n(1, 2, 6, 6), _roi(3, 1, 12, 12)],
             {"pooled_size": (3, 3), "spatial_scale": 0.5}, fam=X),
        Spec("_contrib_ROIAlign", [_n(2, 3, 8, 9), _roi(4, 2, 8, 9)],
             {"pooled_size": (2, 3), "sample_ratio": 2}),
        Spec("_contrib_ROIAlign", [_n(1, 2, 6, 6), _roi(3, 1, 12, 12)],
             {"pooled_size": (3, 2), "spatial_scale": 0.5, "aligned": True,
              "sample_ratio": 3}),
        Spec("_contrib_mrcnn_mask_target",
             [_box(2, 3, 4), _b(2, 2, 8, 8), _i(2, 2, 3), _i(3, 2, 3)],
             {"num_classes": 2, "mask_size": (4, 4)}),
        Spec("BilinearSampler", [_n(2, 3, 5, 6), _u(2, 2, 4, 5)]),
        Spec("BilinearSampler", [_n(1, 2, 4, 4), _n(1, 2, 3, 3)]),
        Spec("GridGenerator", [_n(2, 6)], {"transform_type": "affine",
                                           "target_shape": (3, 4)}),
        Spec("GridGenerator", [_n(2, 2, 3, 4)], {"transform_type": "warp"}),
        Spec("SpatialTransformer", [_n(2, 3, 5, 6), _u(2, 6)],
             {"target_shape": (4, 5)}),
        Spec("_contrib_BilinearResize2D", [_n(2, 3, 4, 5)],
             {"height": 7, "width": 3}),
        Spec("_contrib_BilinearResize2D", [_n(1, 2, 3, 4)],
             {"scale_height": 2.0, "scale_width": 1.5, "mode": "scale"}),
        Spec("_contrib_AdaptiveAvgPooling2D", [_n(2, 3, 7, 5)],
             {"output_size": (3, 2)}, fam="reduce"),
        Spec("_contrib_AdaptiveAvgPooling2D", [_n(1, 2, 4, 4)],
             {"output_size": 1}, fam="reduce"),
        Spec("Correlation", [_n(1, 3, 6, 6), _n(1, 3, 6, 6)], fam="reduce"),
        Spec("Correlation", [_n(2, 2, 7, 7), _n(2, 2, 7, 7)],
             {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
              "pad_size": 2, "is_multiply": False}, fam="reduce"),
        Spec("SVMOutput", [_n(4, 5), _i(5, 4)], fd=False),
        Spec("SVMOutput", [_n(4, 5), _i(5, 4)],
             {"margin": 0.5, "regularization_coefficient": 2.0,
              "use_linear": True}, fd=False),
    ]


def _vision_ext_specs():
    """``ops/vision_ext.py``: the deformable convolutions' tap sums and
    the proposals' decode (``reduce``/``transc``), the samplers'
    blends (``arith``), matching exact."""
    return [
        Spec("_contrib_DeformableConvolution",
             [_n(2, 4, 5, 5), _n(2, 2 * 2 * 9, 5, 5), _n(6, 2, 3, 3),
              _n(6)],
             {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
              "num_group": 2, "num_deformable_group": 2}, fam="reduce"),
        Spec("_contrib_DeformableConvolution",
             [_n(1, 3, 6, 6), _u(1, 2 * 4, 3, 3), _n(4, 3, 2, 2)],
             {"kernel": (2, 2), "stride": (2, 2), "num_filter": 4,
              "no_bias": True}, fam="reduce"),
        Spec("_contrib_ModulatedDeformableConvolution",
             [_n(2, 4, 5, 5), _n(2, 2 * 9, 5, 5), _u(2, 9, 5, 5),
              _n(3, 4, 3, 3), _n(3)],
             {"kernel": (3, 3), "pad": (1, 1), "num_filter": 3},
             fam="reduce"),
        Spec("_contrib_PSROIPooling", [_n(2, 8, 8, 8), _roi(3, 2, 16, 16)],
             {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 2}),
        Spec("_contrib_DeformablePSROIPooling",
             [_n(2, 8, 8, 8), _roi(3, 2, 16, 16), _n(3, 4, 2, 2)],
             {"spatial_scale": 0.5, "output_dim": 2, "group_size": 2,
              "pooled_size": 2, "part_size": 2, "sample_per_part": 2,
              "trans_std": 0.1}),
        Spec("_contrib_Proposal",
             [_u(1, 12, 4, 5), _u(1, 24, 4, 5), _c([[64.0, 80.0, 1.0]])],
             {"rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 10,
              "rpn_min_size": 4, "scales": (2, 4), "ratios": (0.5, 1, 2)},
             fam="transc"),
        Spec("_contrib_MultiProposal",
             [_u(2, 12, 4, 5), _u(2, 24, 4, 5),
              _c([[64.0, 80.0, 1.0], [48.0, 60.0, 0.5]])],
             {"rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 12,
              "threshold": 0.5, "rpn_min_size": 8, "scales": (2, 4),
              "ratios": (0.5, 1, 2), "output_score": True}, fam="transc"),
        Spec("_contrib_RROIAlign", [_n(2, 3, 8, 8), _rroi(3, 2, 8, 8)],
             {"pooled_size": (2, 3), "sampling_ratio": 2}, fam="transc"),
        Spec("_contrib_box_encode",
             [_b(2, 5), _i(3, 2, 5), _box(2, 5, 4), _box(2, 3, 4)],
             {"means": (0.0, 0.1, 0.0, -0.1), "stds": (0.1, 0.1, 0.2, 0.2)},
             fam="transc"),
        Spec("_contrib_box_decode", [_u(2, 5, 4), _box(1, 5, 4)],
             {"std0": 0.1, "std1": 0.1, "std2": 0.2, "std3": 0.2},
             fam="transc"),
        Spec("_contrib_box_decode", [_u(2, 5, 4), _box(1, 5, 4)],
             {"clip": 0.5, "format": "center"}, fam="transc"),
        Spec("_contrib_bipartite_matching", [_u(2, 4, 5)],
             {"threshold": 0.1}, fam="exact"),
        Spec("_contrib_bipartite_matching", [_u(3, 4)],
             {"is_ascend": True, "threshold": 0.5, "topk": 2},
             fam="exact"),
    ]


def _srt(*vals):
    return _c(np.sort(np.asarray(vals, dtype=np.float32)))


def _np_specs():
    """``mx.np``'s ``_np_*`` ops (``numpy/_np_ops.py``): every name, with
    integer, bool and float inputs where the reference's dtypes differ
    from torch's (sums of integers and bools are int32, means float32,
    index outputs int32)."""
    S = Spec
    x34, x234 = _n(3, 4), _n(2, 3, 4)
    specs = [
        S("_np_reshape", [x234], {"newshape": (4, -1)}),
        S("_np_reshape", [x234], {"newshape": (3, 8), "order": "F"}),
        S("_np_transpose", [x234]),
        S("_np_transpose", [x234], {"axes": (1, 2, 0)}),
        S("_np_concatenate", [_n(2, 3), _n(1, 3)], variadic=True),
        S("_np_concatenate", [_n(2, 3), _n(2, 1)], {"axis": 1},
          variadic=True),
        S("_np_concatenate", [_n(2, 3), _n(4)], {"axis": None},
          variadic=True),
        S("_np_stack", [x34, x34], {"axis": 1}, variadic=True),
        S("_np_column_stack", [_n(3), _n(3, 2)], variadic=True),
        S("_np_split", [_n(4, 3)], {"indices_or_sections": 2}),
        S("_np_split", [_n(3, 5)], {"indices_or_sections": [1, 3],
                                    "axis": 1}),
        S("_np_pad", [x34], {"pad_width": ((1, 2), (0, 1))}),
        S("_np_pad", [x34], {"pad_width": 1, "constant_values": 2.5}),
        S("_np_pad", [x34], {"pad_width": ((1, 1), (2, 0)),
                             "mode": "reflect"}),
        S("_np_pad", [x34], {"pad_width": 2, "mode": "edge"}),
        S("_np_pad", [x34], {"pad_width": ((0, 2), (1, 1)),
                             "mode": "wrap"}),
        S("_np_pad", [x34], {"pad_width": 1, "mode": "symmetric"}),
        S("_np_moveaxis", [x234], {"source": 0, "destination": 2}),
        S("_np_rollaxis", [x234], {"axis": 2, "start": 0}),
        S("_np_rollaxis", [x234], {"axis": 0, "start": 3}),
        S("_np_roll", [x34], {"shift": 2, "axis": 1}),
        S("_np_roll", [x34], {"shift": -3}),
        S("_np_rot90", [x234], {"k": 1, "axes": (1, 2)}),
        S("_np_rot90", [x34], {"k": 3}),
        S("_np_flip", [x234], {"axis": 1}),
        S("_np_flip", [x34]),
        S("_np_fliplr", [x34]),
        S("_np_flipud", [x34]),
        S("_np_trace", [_n(4, 4)], {"offset": 1}),
        S("_np_trace", [_ii(9, 3, 4, 2)], {"axis1": 1, "axis2": 2},
          fam="exact"),
        S("_np_tril", [_n(4, 5)], {"k": -1}),
        S("_np_triu", [_n(4, 5)], {"k": 1}),
        S("_np_diag", [_n(4)], {"k": 1}),
        S("_np_diag", [_n(4, 4)], {"k": -1}),
        S("_np_diagonal", [x234], {"offset": 1, "axis1": 1, "axis2": 2}),
        S("_np_broadcast_to", [_n(3, 1)], {"shape": (2, 3, 4)}),
        S("_np_expand_dims", [x34], {"axis": 1}),
        S("_np_expand_dims", [x34], {"axis": (0, 3)}),
        S("_np_squeeze", [_n(3, 1, 4, 1)]),
        S("_np_squeeze", [_n(3, 1, 4, 1)], {"axis": 1}),
        S("_np_swapaxes", [x234], {"axis1": 0, "axis2": 2}),
        S("_np_flatten", [x234]),
        S("_np_repeat", [x34], {"repeats": 2, "axis": 1}),
        S("_np_repeat", [x34], {"repeats": 3}),
        S("_np_tile", [x34], {"reps": (2, 1, 2)}),
        S("_np_tile", [_n(3)], {"reps": 2}),
        S("_np_sort", [x34], {"axis": 0}),
        S("_np_sort", [x34], {"axis": None}),
        S("_np_argsort", [x34], fam="exact"),
        S("_np_take", [_n(5, 3), _ii(8, 4, lo=-2)], {"axis": 0}),
        S("_np_take", [_n(5, 3), _ii(20, 2, 2, lo=-3)],
          {"mode": "wrap"}),
        S("_np_take_along_axis", [x34, _ii(4, 3, 2)], {"axis": 1}),
        S("_np_where", [_b(3, 4), x34, _n(4)]),
        S("_np_meshgrid", [_n(3), _n(4)], variadic=True),
        S("_np_meshgrid", [_n(3), _n(2)], {"indexing": "ij"},
          variadic=True),
        # products and linear algebra
        S("_np_matmul", [x234, _n(4, 5)]),
        S("_np_tensordot", [x234, _n(4, 3)], {"axes": ((1, 2), (1, 0))}),
        S("_np_tensordot", [x34, _n(4, 2)], {"axes": 1}),
        S("_np_einsum", [x34, _n(4, 5)], {"subscripts": "ij,jk->ik"},
          variadic=True),
        S("_np_einsum", [x234], {"subscripts": "bij->ji"},
          variadic=True),
        S("_np_outer", [_n(3), _n(2, 2)]),
        S("_np_inner", [x34, _n(2, 4)]),
        S("_np_kron", [_n(2, 3), _n(2, 2)]),
        S("_np_vdot", [x34, x34]),
        S("_np_cross", [_n(4, 3), _n(4, 3)]),
        S("_np_linalg_norm", [x34], fam="linalg"),
        S("_np_linalg_norm", [x34], {"ord": "fro", "axis": (0, 1)},
          fam="linalg"),
        S("_np_linalg_norm", [x234], {"ord": 1, "axis": 2,
                                      "keepdims": True}, fam="linalg"),
        S("_np_linalg_inv", [("spd", (4, 4))], fam="linalg"),
        S("_np_linalg_det", [("spd", (2, 3, 3))], fam="linalg"),
        S("_np_linalg_slogdet", [("spd", (4, 4))], fam="linalg",
          grad_out=1),
        S("_np_linalg_cholesky", [("spd", (4, 4))], fam="linalg",
          fd_sym=True),
        S("_np_linalg_qr", [_n(4, 3)], fam="linalg", grad_out=1),
        S("_np_linalg_svd", [_n(4, 3)], fam="linalg", grad_out=1,
          cmp="svd"),
        S("_np_linalg_eigh", [("spd", (4, 4))], fam="linalg",
          cmp="npeig", fd_sym=True),
        S("_np_linalg_eigvalsh", [("spd", (4, 4))], fam="linalg",
          fd_sym=True),
        S("_np_linalg_solve", [("spd", (4, 4)), _n(4, 2)], fam="linalg"),
        S("_np_linalg_lstsq", [_n(6, 3), _n(6, 2)], fam="linalg"),
        S("_np_linalg_pinv", [_n(4, 3)], fam="linalg"),
        S("_np_linalg_matrix_rank", [("spd", (4, 4))], fam="exact"),
        S("_np_linalg_matrix_power", [_n(3, 3)], {"n": 3},
          fam="linalg"),
        # reductions
        S("_np_sum", [x234], {"axis": (0, 2)}, fam="reduce"),
        S("_np_sum", [_ii(9, 3, 4)], {"axis": 1}, fam="exact"),
        S("_np_sum", [_c(np.array([[True, False], [True, True]]),
                         dtype=bool)], fam="exact"),
        S("_np_sum", [x34], {"dtype": "float32", "keepdims": True},
          fam="reduce"),
        S("_np_mean", [x234], {"axis": [1]}, fam="reduce"),
        S("_np_mean", [_ii(9, 3, 4)], fam="reduce"),
        S("_np_prod", [_p(3, 4)], {"axis": 1}, fam="reduce"),
        S("_np_prod", [_ii(4, 2, 3, lo=1)], fam="exact"),
        S("_np_max", [x234], {"axis": 0, "keepdims": True}),
        S("_np_min", [x234], {"axis": (1, 2)}),
        S("_np_std", [x234], {"axis": 2}, fam="reduce"),
        S("_np_var", [x34], {"ddof": 1}, fam="reduce"),
        S("_np_median", [x234], {"axis": 2}, fam="reduce"),
        S("_np_median", [_n(3, 5)], fam="reduce"),
        S("_np_all", [_b(3, 4)], {"axis": 1}, fam="exact"),
        S("_np_any", [_b(3, 4)], {"axis": (0, 1)}, fam="exact"),
        S("_np_nanmean", [x34], {"axis": 0}, fam="reduce"),
        S("_np_nanmean", [_c([[1.0, np.nan, 3.0], [np.nan, 2.0, 4.0]])],
          {"axis": 1}, fam="reduce", grad=False),
        S("_np_average", [x34], {"axis": 1}, fam="reduce"),
        S("_np_average", [x34, _p(4)], {"axis": 1}, fam="reduce"),
        S("_np_cumsum", [x34], {"axis": 1}, fam="reduce"),
        S("_np_cumsum", [_ii(9, 3, 4)], fam="exact"),
        S("_np_cumprod", [_p(3, 4)], {"axis": 0}, fam="reduce"),
        S("_np_ptp", [x34], {"axis": 1}),
        # search and logic
        S("_np_unique", [_i(4, 3, 5)], fam="exact"),
        S("_np_nonzero", [_b(3, 4)], fam="exact"),
        S("_np_bincount", [_ii(5, 10)], {"minlength": 7}, fam="exact"),
        S("_np_searchsorted", [_srt(-1.0, 0.0, 0.5, 2.0), _n(3, 2)],
          fam="exact"),
        S("_np_searchsorted", [_srt(-1.0, 0.0, 0.5, 2.0),
                               _c([0.0, 0.5, 3.0])], {"side": "right"},
          fam="exact"),
        S("_np_isclose", [x34, x34], fam="exact"),
        S("_np_isclose", [_c([1.0, 1.0, np.nan]), _c([1.0 + 1e-6, 1.1,
                                                     np.nan])],
          {"equal_nan": True}, fam="exact"),
        S("_np_allclose", [x34, x34], fam="exact"),
        S("_np_array_equal", [x34, x34], fam="exact"),
        S("_np_array_equal", [_n(3), _n(3)], fam="exact"),
        # binary elementwise
        S("_np_floor_divide", [_n(3, 4), _p(4)]),
        S("_np_floor_divide", [_ii(20, 3, 4, lo=-20), _ii(5, 4, lo=1)],
          fam="exact"),
        S("_np_fmod", [_n(3, 4), _p(3, 4)]),
        S("_np_arctan2", [x34, _n(4)], fam="transc"),
        S("_np_hypot", [x34, _n(3, 1)], fam="transc"),
        S("_np_copysign", [x34, _n(4)]),
        S("_np_logaddexp", [x34, _n(3, 4)], fam="transc"),
        S("_np_logaddexp2", [x34, _n(3, 4)], fam="transc"),
        S("_np_heaviside", [_c([-1.5, 0.0, 2.0, 0.0]), _u(4)]),
        S("_np_bitwise_and", [_ii(64, 3, 4), _ii(64, 4)], fam="exact"),
        S("_np_bitwise_or", [_ii(64, 3, 4), _ii(64, 4)], fam="exact"),
        S("_np_bitwise_xor", [_ii(64, 3, 4), _ii(64, 4)], fam="exact"),
        S("_np_left_shift", [_ii(64, 3, 4), _ii(5, 4)], fam="exact"),
        S("_np_right_shift", [_ii(64, 3, 4), _ii(5, 4)], fam="exact"),
        S("_np_gcd", [_ii(40, 3, 4), _ii(40, 4)], fam="exact"),
        S("_np_lcm", [_ii(12, 3, 4), _ii(12, 4)], fam="exact"),
        S("_np_fmax", [x34, _n(4)]),
        S("_np_fmin", [x34, _c([0.1, np.nan, -0.2, 0.3])], grad=False),
        S("_np_float_power", [_p(3, 4), _n(4)], fam="transc"),
        S("_np_ldexp", [x34, _ii(4, 4, lo=-3)], fam="exact"),
        S("_np_nextafter", [x34, _n(3, 4)], fam="exact", grad=False),
        S("_np_divmod", [_n(3, 4), _p(4)], grad_out=1),
        S("_np_interp", [_n(6), _srt(-1.5, -0.5, 0.0, 1.0, 2.0),
                         _n(5)]),
        S("_np_polyval", [_n(4), _n(3, 2)]),
        S("_np_convolve", [_n(5), _n(3)]),
        S("_np_convolve", [_n(3), _n(6)], {"mode": "same"}),
        S("_np_correlate", [_n(6), _n(3)]),
        S("_np_correlate", [_n(3), _n(5)], {"mode": "full"}),
        S("_np_isin", [_i(6, 3, 4), _c([1.0, 3.0])], fam="exact"),
        S("_np_in1d", [_i(6, 3, 4), _c([0.0, 2.0, 5.0])], fam="exact"),
        # unary and the rest of the generated long tail
        S("_np_clip", [x34], {"a_min": -0.5, "a_max": 0.7}),
        S("_np_clip", [x34], {"a_max": 0.2}),
        S("_np_round", [_n(3, 4)], {"decimals": 0}),
        S("_np_round", [_ii(50, 4, lo=-50)], fam="exact"),
        S("_np_nan_to_num", [_c([1.0, np.nan, np.inf, -np.inf, -2.0])],
          fam="exact"),
        S("_np_nan_to_num", [_c([1.0, np.nan, np.inf, -np.inf])],
          {"nan": 5.0, "posinf": 9.0, "neginf": -9.0}, fam="exact"),
        S("_np_real", [x34]),
        S("_np_imag", [x34]),
        S("_np_conj", [x34]),
        S("_np_angle", [_c([-1.0, 2.0, 0.0, -0.5])], fam="transc"),
        S("_np_sinc", [x34], fam="transc"),
        S("_np_i0", [x34], fam="special"),
        S("_np_deg2rad", [x34], fam="transc"),
        S("_np_rad2deg", [x34], fam="transc"),
        S("_np_deg2rad", [_ii(360, 5)], fam="transc"),
        S("_np_positive", [x34]),
        S("_np_signbit", [_c([-1.0, 0.0, -0.0, 2.0])], fam="exact"),
        S("_np_spacing", [_c([1.0, -2.0, 1e-3, 0.5])], fam="exact"),
        S("_np_frexp", [_c([1.5, -2.25, 3.0, 0.0, 1e-3])], fam="exact"),
        S("_np_modf", [_n(3, 4)]),
        S("_np_nanmax", [x34], {"axis": 1}),
        S("_np_nanmin", [_c([[1.0, np.nan], [np.nan, np.nan]])],
          {"axis": 1}, grad=False),
        S("_np_nanstd", [x34], {"axis": 0}, fam="reduce"),
        S("_np_nanvar", [_c([[1.0, np.nan, 3.0], [np.nan, 2.0, 4.5]])],
          {"axis": 1, "ddof": 1}, fam="reduce", grad=False),
        S("_np_nanargmax", [_c([[1.0, np.nan, 3.0], [0.5, 2.0, 1.0]])],
          {"axis": 1}, fam="exact"),
        S("_np_nanargmin", [x34], fam="exact"),
        S("_np_count_nonzero", [_b(3, 4)], {"axis": 0}, fam="exact"),
        S("_np_count_nonzero", [_b(3, 4)], fam="exact"),
        S("_np_argwhere", [_b(3, 4)], fam="exact"),
        S("_np_flatnonzero", [_b(3, 4)], fam="exact"),
        S("_np_unwrap", [_c([0.0, 3.0, 6.5, 1.0, -3.5, 0.5])],
          fam="transc"),
        S("_np_vander", [_n(4)], {"N": 3}),
        S("_np_vander", [_n(3)], {"increasing": True}),
        S("_np_gradient", [_n(4, 5)]),
        S("_np_gradient", [_n(6)]),
        S("_np_percentile", [x34], {"q": 30.0, "axis": 1}, fam="reduce"),
        S("_np_quantile", [_n(10)], {"q": np.array([0.1, 0.5, 0.9])},
          fam="reduce"),
        S("_np_cov", [_n(3, 6)], fam="reduce"),
        S("_np_cov", [_n(6, 3)], {"rowvar": False, "bias": True},
          fam="reduce"),
        S("_np_histogram", [_n(20)], {"bins": 5}, fam="reduce"),
        S("_np_histogram", [_n(20)], {"bins": 4, "range": (-1.0, 1.0)},
          fam="reduce"),
        S("_np_digitize", [_n(3, 4), _srt(-1.0, 0.0, 0.5)], fam="exact"),
        S("_np_digitize", [_c([0.0, 0.5, 0.7]), _srt(-1.0, 0.0, 0.5)],
          {"right": True}, fam="exact"),
        S("_np_diff", [x34], {"n": 2, "axis": 1}),
        S("_np_trapz", [x34], {"dx": 0.5}, fam="reduce"),
        S("_np_ediff1d", [x34]),
        # creation ops of the long tail (no array input)
        S("_np_bartlett", [], {"M": 7}, fam="transc"),
        S("_np_blackman", [], {"M": 8}, fam="transc"),
        S("_np_hamming", [], {"M": 6}, fam="transc"),
        S("_np_hanning", [], {"M": 9}, fam="transc"),
        S("_np_kaiser", [], {"M": 7, "beta": 4.0}, fam="special"),
        S("_np_tri", [], {"N": 3, "M": 5, "k": 1}, fam="exact"),
        S("_np_indices", [], {"dimensions": (2, 3)}, fam="exact"),
    ]
    return specs


def _qrange(lo, hi):
    return [_c(np.float32(lo)), _c(np.float32(hi))]


def _quant_specs():
    """The INT8 ops (``ops/quantization.py``): integer outputs, and the
    float ranges and dequantized values, bit for bit (the tests run the
    reference unjitted: its jit contracts a multiply-add into an FMA)."""
    S = Spec

    def q(name, inputs, attrs=None):
        return S(name, inputs, attrs, fam="exact", grad=False)

    fc_w, fc_b = _q8(5, 16), _q8(5)
    conv = {"kernel": (3, 3), "num_filter": 6, "no_bias": True}
    return [
        q("_contrib_quantize", [_n(4, 7)] + _qrange(-1.5, 2.5),
          {"out_type": "int8"}),
        q("_contrib_quantize", [_p(4, 7)] + _qrange(0.4, 2.1),
          {"out_type": "uint8"}),
        q("_contrib_quantize_v2", [_n(4, 7)], {"out_type": "int8"}),
        q("_contrib_quantize_v2", [_n(3, 5)],
          {"out_type": "int8", "min_calib_range": -1.0,
           "max_calib_range": 0.75}),
        q("_contrib_quantize_v2", [_p(3, 5)],
          {"out_type": "auto", "min_calib_range": 0.5,
           "max_calib_range": 1.7}),
        q("_contrib_quantize_v2", [_p(3, 5)], {"out_type": "uint8"}),
        q("_contrib_dequantize", [_q8(4, 6)] + _qrange(-0.7, 1.3)),
        q("_contrib_dequantize", [_u8(4, 6)] + _qrange(0.2, 3.1)),
        q("_contrib_dequantize", [_ii(2 ** 24, 4, 6, lo=-2 ** 24)]
          + _qrange(-3.0e4, 2.5e4)),
        q("_contrib_requantize", [_ii(2 ** 28, 4, 6, lo=-2 ** 28)]
          + _qrange(-812.5, 812.5)),
        q("_contrib_requantize", [_ii(2 ** 28, 4, 6, lo=-2 ** 28)]
          + _qrange(-812.5, 812.5),
          {"min_calib_range": -60.0, "max_calib_range": 45.0}),
        q("_contrib_quantized_fully_connected",
          [_q8(8, 16), fc_w, fc_b] + _qrange(-1, 1) + _qrange(-0.5, 0.5)
          + _qrange(-0.2, 0.2), {"num_hidden": 5}),
        q("_contrib_quantized_fully_connected",
          [_q8(19, 16), fc_w] + _qrange(-1, 1) + _qrange(-0.5, 0.5),
          {"num_hidden": 5, "no_bias": True}),
        q("_contrib_quantized_fully_connected",
          [_u8(6, 2, 5, 3), _q8(7, 30)] + _qrange(0, 2.0)
          + _qrange(-0.5, 0.4), {"num_hidden": 7, "no_bias": True}),
        q("_contrib_quantized_fully_connected",
          [_q8(2, 3, 12), _q8(4, 12), _q8(4)] + _qrange(-1, 1)
          + _qrange(-0.5, 0.5) + _qrange(-0.1, 0.3),
          {"num_hidden": 4, "flatten": False}),
        q("_contrib_quantized_conv",
          [_q8(2, 3, 7, 7), _q8(6, 3, 3, 3)] + _qrange(-1, 1)
          + _qrange(-0.3, 0.3), conv),
        q("_contrib_quantized_conv",
          [_q8(2, 3, 9, 8), _q8(6, 3, 3, 3), _q8(6)] + _qrange(-1, 1)
          + _qrange(-0.3, 0.3) + _qrange(-0.05, 0.05),
          {"kernel": (3, 3), "num_filter": 6, "pad": (1, 1),
           "stride": (2, 2)}),
        q("_contrib_quantized_conv",
          [_u8(2, 3, 8, 8), _q8(6, 3, 3, 3)] + _qrange(0, 4.0)
          + _qrange(-0.3, 0.3), dict(conv, pad=(1, 1))),
        q("_contrib_quantized_conv",
          [_q8(1, 4, 9, 9), _q8(6, 2, 3, 3)] + _qrange(-1, 1)
          + _qrange(-0.3, 0.3),
          {"kernel": (3, 3), "num_filter": 6, "no_bias": True,
           "num_group": 2, "dilate": (2, 2), "pad": (2, 1)}),
        q("_contrib_quantized_conv",
          [_q8(2, 3, 11, 11), _q8(4, 3, 7, 7)] + _qrange(-1, 1)
          + _qrange(-0.3, 0.3),
          {"kernel": (7, 7), "num_filter": 4, "no_bias": True,
           "pad": (3, 3), "stride": (2, 2)}),
        q("_contrib_quantized_pooling", [_q8(2, 3, 6, 6)]
          + _qrange(-1, 1), {"kernel": (2, 2), "stride": (2, 2)}),
        q("_contrib_quantized_pooling", [_q8(2, 3, 7, 7)]
          + _qrange(-1, 1), {"kernel": (3, 3), "stride": (2, 2),
                             "pad": (1, 1)}),
        q("_contrib_quantized_pooling", [_u8(1, 2, 6, 6)]
          + _qrange(0, 1), {"kernel": (3, 3), "stride": (1, 1),
                            "pad": (1, 1)}),
        q("_contrib_quantized_pooling", [_q8(2, 3, 6, 6)]
          + _qrange(-1, 1), {"kernel": (2, 2), "stride": (2, 2),
                             "pool_type": "avg"}),
        q("_contrib_quantized_pooling", [_q8(2, 3, 5, 4)]
          + _qrange(-1, 1), {"pool_type": "avg", "global_pool": True}),
        q("_contrib_quantized_flatten", [_q8(2, 3, 4)] + _qrange(-1, 1)),
        q("_contrib_quantized_act", [_q8(3, 5)] + _qrange(-1, 1),
          {"act_type": "relu"}),
    ]


# the op library's specs by the reference module that registers the op
OP_SPECS = {"elemwise": _elemwise_specs(), "reduce": _reduce_specs(),
            "shape_ops": _shape_specs(), "creation_ops": _creation_specs(),
            "nn": _nn_specs(), "linalg": _linalg_specs(),
            "contrib_misc": _contrib_specs(), "rnn_op": _rnn_specs(),
            "vision": _vision_specs(), "vision_ext": _vision_ext_specs(),
            "_np_ops": _np_specs(), "quantization": _quant_specs()}

# reference op modules the port does not register yet, each with its
# reason (none: quantization and _np_ops were the last, ROADMAP.md A.9)
DEFERRED_MODULES = {}


def op_names_of(spec_name):
    """The op's name and every alias it is registered under."""
    from mxnet_tpu_torch.ops import registry as reg
    op = reg.get_op(spec_name)
    return [op.name] + list(op.aliases)


def _opt(name, inputs, **attrs):
    return Spec(name, inputs, attrs, grad=False)


def _optimizer_specs():
    """The update ops: weight, gradient and states, every option on."""
    w, g = _n(3, 4), _n(3, 4)
    w16, g16 = _h(3, 4), _h(3, 4)
    clip = dict(rescale_grad=0.5, clip_gradient=0.3)
    return [
        Spec("multi_sgd_update", [w, g, _n(5), _n(5)],
             dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), num_weights=2, **clip),
             variadic=True, grad=False),
        Spec("multi_sgd_mom_update", [w, g, _n(3, 4), _n(5), _n(5), _n(5)],
             dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), momentum=0.9,
                  num_weights=2, **clip), variadic=True, grad=False),
        Spec("preloaded_multi_sgd_update",
             [w, g, _n(5), _n(5), _c([0.1, 0.2]), _c([0.0, 0.01])],
             dict(num_weights=2, **clip), variadic=True, grad=False),
        Spec("preloaded_multi_sgd_mom_update",
             [w, g, _n(3, 4), _n(5), _n(5), _n(5), _c([0.1, 0.2]),
              _c([0.0, 0.01])],
             dict(momentum=0.9, num_weights=2, **clip), variadic=True,
             grad=False),
        _opt("sgd_update", [w, g], lr=0.1, wd=0.01, **clip),
        _opt("sgd_mom_update", [w, g, _n(3, 4)], lr=0.1, momentum=0.9,
             wd=0.01, **clip),
        _opt("mp_sgd_update", [w16, g16, w], lr=0.1, wd=0.01, **clip),
        _opt("mp_sgd_mom_update", [w16, g16, _n(3, 4), w], lr=0.1,
             momentum=0.9, wd=0.01, **clip),
        _opt("nag_mom_update", [w, g, _n(3, 4)], lr=0.1, momentum=0.9,
             wd=0.01, **clip),
        _opt("mp_nag_mom_update", [w16, g16, _n(3, 4), w], lr=0.1,
             momentum=0.9, wd=0.01, **clip),
        _opt("adam_update", [w, g, _n(3, 4), _p(3, 4)], lr=0.01, wd=0.01,
             beta1=0.8, beta2=0.99, epsilon=1e-6, **clip),
        _opt("adam_update", [w, g, _n(3, 4), _p(3, 4)], lr=0.01),
        _opt("mp_adam_update", [w16, g16, _n(3, 4), _p(3, 4), w], lr=0.01,
             wd=0.01, **clip),
        _opt("adamw_update", [w, g, _n(3, 4), _p(3, 4)], lr=0.01, wd=0.1,
             eta=0.5, **clip),
        _opt("ftrl_update", [w, g, _n(3, 4), _p(3, 4)], lr=0.1,
             lamda1=0.5, beta=1.5, wd=0.01, **clip),
        _opt("rmsprop_update", [w, g, _p(3, 4)], lr=0.01, gamma1=0.9,
             wd=0.01, clip_weights=0.5, **clip),
        _opt("rmspropalex_update", [w, g, _g(3, 4), _u(3, 4), _n(3, 4)],
             lr=0.01, gamma1=0.9, gamma2=0.8, wd=0.01, clip_weights=0.9,
             **clip),
        _opt("signsgd_update", [w, g], lr=0.1, wd=0.01, **clip),
        _opt("signum_update", [w, g, _n(3, 4)], lr=0.1, momentum=0.9,
             wd=0.01, wd_lh=0.01, **clip),
        _opt("lamb_update_phase1", [w, g, _n(3, 4), _p(3, 4)], t=3,
             wd=0.01, **clip),
        _opt("lamb_update_phase1", [w, g, _n(3, 4), _p(3, 4)], t=2,
             bias_correction=False),
        _opt("lamb_update_phase2", [w, g, _p(1), _p(1)], lr=0.1,
             lower_bound=0.8, upper_bound=1.5),
        _opt("lamb_update_phase2", [w, g, _c([0.0]), _p(1)], lr=0.1),
        _opt("mp_lamb_update_phase1", [w16, g16, _n(3, 4), _p(3, 4), w],
             t=3, wd=0.01, **clip),
        _opt("mp_lamb_update_phase2", [w16, g, _p(1), _p(1), w], lr=0.1),
        _opt("multi_lars", [_p(4), _p(4), _c([1.0, 0.0, 2.0, 3.0]),
                            _c([0.0, 0.01, 0.1, 0.001])],
             eta=0.01, eps=1e-6, rescale_grad=0.5),
        Spec("multi_sum_sq", [_n(3, 4), _n(5)], {"num_arrays": 2},
             variadic=True, fam="reduce", grad=False),
        Spec("reset_arrays", [_n(3), _n(2, 2)], {"num_arrays": 2},
             variadic=True, fam="exact", grad=False),
        Spec("multi_mp_sgd_update", [w16, g16, w, _h(5), _h(5), _n(5)],
             dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), num_weights=2, **clip),
             variadic=True, grad=False),
        Spec("multi_mp_sgd_mom_update",
             [w16, g16, _n(3, 4), w, _h(5), _h(5), _n(5), _n(5)],
             dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), momentum=0.9,
                  num_weights=2, **clip), variadic=True, grad=False),
        _opt("_contrib_group_adagrad_update", [_n(4, 3), _n(4, 3),
                                               _p(4, 1)],
             lr=0.1, rescale_grad=0.5, clip_gradient=0.3),
        _opt("_contrib_group_adagrad_update", [_n(4), _n(4), _p(4)],
             lr=0.1),
    ]


OP_SPECS["optimizer_ops"] = _optimizer_specs()


class RandomSpec:
    """A sampler case: its inputs and attributes, and what the draws
    must show: per-row ``mean``/``var`` (numbers or per-row lists) of the
    distribution, ``support`` ("int": integers, or (lo, hi): within),
    and the output ``dtype``."""

    def __init__(self, name, inputs=(), attrs=None, mean=None, var=None,
                 support=None, dtype="float32"):
        self.name, self.inputs = name, list(inputs)
        self.attrs = dict(attrs or {})
        self.mean, self.var, self.support = mean, var, support
        self.dtype = dtype

    def __repr__(self):
        return self.name


N_DRAWS = 20000


def _random_specs():
    S = {"shape": (N_DRAWS,)}
    lo, hi = np.array([-1.0, 0.5, 2.0]), np.array([1.0, 3.0, 2.5])
    mu, sig = np.array([0.0, 1.0, -2.0]), np.array([1.0, 0.5, 2.0])
    al, be = np.array([1.0, 2.5, 0.7]), np.array([1.0, 0.5, 2.0])
    lam = np.array([0.5, 2.0, 7.0])
    kk, pp = np.array([1.0, 3.0, 6.0]), np.array([0.3, 0.5, 0.8])
    gm, ga = np.array([1.0, 4.0, 0.5]), np.array([0.5, 0.2, 1.0])
    f = lambda a: _c(a)
    P = {"shape": N_DRAWS}
    return [
        RandomSpec("_random_uniform", [], dict(low=-1.0, high=3.0, **S),
                   1.0, 16.0 / 12, (-1.0, 3.0)),
        RandomSpec("_random_normal", [], dict(loc=1.0, scale=2.0, **S),
                   1.0, 4.0),
        RandomSpec("_random_gamma", [], dict(alpha=2.0, beta=1.5, **S),
                   3.0, 4.5, (0.0, np.inf)),
        RandomSpec("_random_exponential", [], dict(lam=2.0, **S), 0.5,
                   0.25, (0.0, np.inf)),
        RandomSpec("_random_poisson", [], dict(lam=3.0, **S), 3.0, 3.0,
                   "int"),
        RandomSpec("_random_negative_binomial", [], dict(k=3, p=0.4, **S),
                   4.5, 11.25, "int"),
        RandomSpec("_random_generalized_negative_binomial", [],
                   dict(mu=2.0, alpha=0.5, **S), 2.0, 4.0, "int"),
        RandomSpec("_random_randint", [], dict(low=-2, high=5, **S), 1.0,
                   4.0, (-2, 4), dtype="int32"),
        RandomSpec("_sample_uniform", [f(lo), f(hi)], P, (lo + hi) / 2,
                   (hi - lo) ** 2 / 12),
        RandomSpec("_sample_normal", [f(mu), f(sig)], P, mu, sig ** 2),
        RandomSpec("_sample_gamma", [f(al), f(be)], P, al * be,
                   al * be ** 2, (0.0, np.inf)),
        RandomSpec("_sample_exponential", [f(lam)], P, 1 / lam,
                   1 / lam ** 2, (0.0, np.inf)),
        RandomSpec("_sample_poisson", [f(lam)], P, lam, lam, "int"),
        RandomSpec("_sample_negative_binomial", [f(kk), f(pp)], P,
                   kk * (1 - pp) / pp, kk * (1 - pp) / pp ** 2, "int"),
        RandomSpec("_sample_generalized_negative_binomial", [f(gm), f(ga)],
                   P, gm, gm + ga * gm ** 2, "int"),
        RandomSpec("_sample_unique_zipfian", [],
                   dict(range_max=100, **S), support=(0, 99),
                   dtype="int64"),
        RandomSpec("_sample_multinomial",
                   [f([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]])],
                   dict(shape=N_DRAWS, get_prob=True), support=(0, 3),
                   dtype="int32"),
        RandomSpec("_shuffle", [f(np.arange(100.0))], dtype="float32"),
    ]


RANDOM_SPECS = _random_specs()


def random_inputs(spec):
    return [k[1].copy() for k in spec.inputs]


def check_moments(spec, x):
    """Draws ``x`` (rows along the sampler's parameters, draws on the
    last axis) against the distribution: the mean within 6 standard
    errors of ``mean`` and the variance within 6 estimated standard
    errors (from the draws' fourth moment) of ``var``; returns the
    largest error in standard errors."""
    x = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
    n = x.shape[-1]
    mean = np.broadcast_to(np.asarray(spec.mean, np.float64), (x.shape[0],))
    var = np.broadcast_to(np.asarray(spec.var, np.float64), (x.shape[0],))
    m = x.mean(-1)
    s2 = x.var(-1)
    m4 = ((x - m[:, None]) ** 4).mean(-1)
    z_mean = np.abs(m - mean) / np.sqrt(var / n)
    z_var = np.abs(s2 - var) / np.sqrt(np.maximum(m4 - s2 ** 2, 1e-12) / n)
    worst = float(max(z_mean.max(), z_var.max()))
    assert worst < 6.0, (spec, m, mean, s2, var)
    return worst


def check_support(spec, x):
    x = np.asarray(x)
    if spec.support == "int":
        assert np.all(x == np.round(x)) and np.all(x >= 0), spec
    elif spec.support is not None:
        lo, hi = spec.support
        assert np.all(x >= lo) and np.all(x <= hi), (spec, x.min(), x.max())


def fd_case(spec):
    """The case has a gradient to hold against finite differences."""
    return (spec.grad and spec.fd and not op_no_grad(spec)
            and bool(diff_inputs(spec, op_inputs(spec, 0))))


def alias_cases(specs):
    """(first case of each op, each other name it is registered
    under)."""
    seen, out = set(), []
    for sp in specs:
        if sp.name in seen:
            continue
        seen.add(sp.name)
        out += [(sp, a) for a in op_names_of(sp.name) if a != sp.name]
    return out


def held_op_names():
    """The canonical names of every op a case here holds."""
    return {sp.name for specs in OP_SPECS.values() for sp in specs} | \
        {sp.name for sp in RANDOM_SPECS}


def check_on_card(spec, seed=0, name=None):
    """The case through the port on the card and on the CPU from the
    same inputs (TF32 off): outputs, inputs after the call and
    gradients within ``CARD_TOL``'s family limit.  Returns the largest
    absolute error."""
    import mxnet_tpu_torch as P
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays = op_inputs(spec, seed)
    c = run_case(P, spec, arrays, ctx=P.cpu(), name=name)
    g = run_case(P, spec, arrays, ctx=P.gpu(0), name=name)
    tol = CARD_TOL[spec.fam]
    worst = 0.0
    pairs = list(zip(canon(spec, g[0]), canon(spec, c[0]))) \
        + list(zip(g[1], c[1]))
    for k, (x, y) in enumerate(pairs):
        assert x.dtype == y.dtype, (spec, k, x.dtype, y.dtype)
        assert_close(x, y, tol, "%r card %d" % (spec, k))
        fin = np.isfinite(y) if x.dtype.kind == "f" else None
        if fin is not None and fin.any():
            worst = max(worst, float(np.abs(
                x[fin].astype(np.float64) - y[fin].astype(np.float64))
                .max()))
    if c[2] is not None:
        for k, (x, y) in enumerate(zip(g[2], c[2])):
            assert_close(x, y, grad_tol(spec.fam, CARD_TOL),
                         "%r card grad %d" % (spec, k))
            worst = max(worst, float(np.abs(x - y).max()) if x.size
                        else 0.0)
    return worst


def random_draw(pkg, spec, ctx=None, name=None):
    """The sampler case through ``pkg`` (on ``ctx``, under ``name``):
    its outputs as numpy."""
    kw = {} if ctx is None else {"ctx": ctx}
    xs = [pkg.nd.array(a, **kw) for a in random_inputs(spec)]
    fn = getattr(pkg.nd, name or spec.name)
    out = fn(*xs, **spec.attrs) if xs else fn(**spec.attrs, **kw)
    return [o.asnumpy() for o in _outs(out)]


def check_draw(spec, out):
    """A draw's support, moments (returns the worst, in standard
    errors), a shuffle's permutation and multinomial frequencies."""
    x = out[0]
    check_support(spec, x)
    worst = check_moments(spec, x) if spec.mean is not None else 0.0
    if spec.name == "_shuffle":
        np.testing.assert_array_equal(np.sort(x), random_inputs(spec)[0])
    if spec.name == "_sample_multinomial":
        probs = random_inputs(spec)[0]
        freq = np.stack([np.bincount(r.astype(int), minlength=4) / r.size
                         for r in x])
        assert np.abs(freq - probs).max() < 6 * np.sqrt(0.25 / x.shape[1])
    return worst


def check_hybridized_draws(ctx):
    """A hybridized block with ``F.random_uniform`` (through its
    ``_CachedOp``; a CUDA graph on the card): new values at every call,
    the same sequence after a re-seed, and the sequence of the same
    block run op by op."""
    import mxnet_tpu_torch as P

    class Noisy(P.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x + F.random_uniform(low=-1.0, high=1.0, shape=(3, 4))

    def calls(block, n=3):
        return [block(x).asnumpy() for _ in range(n)]

    x = P.nd.zeros((3, 4), ctx=ctx)
    block = Noisy()
    block.hybridize()
    P.random.seed(0)
    first = calls(block)
    P.random.seed(0)
    again = calls(block)
    P.random.seed(0)
    plain = calls(Noisy())
    assert not np.array_equal(first[0], first[1])
    for a, b, c in zip(first, again, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.min() >= -1.0 and a.max() < 1.0
