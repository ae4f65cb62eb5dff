"""Port parity: ``mxnet_tpu_torch.kernels.fused_optimizer`` (the grouped
SGD update) against the reference's ``fused_multi_sgd`` (its Pallas
kernels in interpreter mode, which it picks by itself off TPU) and
against the reference's per-tensor ``sgd_update`` / ``sgd_mom_update``;
the port's grouped ops against its own per-tensor ops; and, on the
card, the CUDA kernel against its plain version.

Tolerances.  The port's plain version rounds after every product and
sum, as eager ops do: it is bit-identical to the reference's per-tensor
ops run eagerly and to the port's per-tensor ops (up to the sign of a
zero where ``wd == 0``, compared after adding +0.0).  XLA:CPU compiles
the interpreted Pallas body and contracts ``mu*m - lr*g`` (and
``w - lr*g``) into an FMA, which rounds once where the port rounds
twice; the sum that follows can cancel, so against it the port is held
within two f32 ulps of the largest operand of the update (|w|, |m|,
|lr*g| and the results; ``_ulps``).  The CUDA kernel writes its
arithmetic with ``__fmul_rn``/``__fadd_rn``/``__fsub_rn`` and is held
bit for bit against the plain version on the card."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)

SHAPES = [(7, 5), (33,), (4, 4, 4), (129,), (3, 3, 2, 2), (1,)]
LRS = [0.1, 0.2, 0.05, 0.3, 0.01, 0.5]


def _group(seed, momentum):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [(3 * rng.randn(*s)).astype(np.float32) for s in SHAPES]
    ms = [rng.randn(*s).astype(np.float32) for s in SHAPES] \
        if momentum else None
    return ws, gs, ms


def _t(xs):
    return None if xs is None else [torch.from_numpy(x.copy()) for x in xs]


def _same(a, b):
    return np.array_equal(np.asarray(a) + 0.0, np.asarray(b) + 0.0)


def _ulps(*arrays):
    """Two f32 ulps of the largest magnitude among ``arrays``, per
    element: the most an FMA contraction moves an update."""
    big = np.max([np.abs(np.asarray(a, np.float32)) for a in arrays], axis=0)
    return 2 * np.spacing(big)


CASES = [(mom, clip, wd) for mom in (True, False)
         for clip in (-1.0, 1.0) for wd in (0.0, 1e-2)]


@pytest.mark.parametrize("momentum,clip,wd", CASES)
def test_plain_matches_reference_kernel(momentum, clip, wd):
    """The plain version against the reference's ``fused_multi_sgd``
    (Pallas, interpreter mode): within ``_ulps``."""
    import jax.numpy as jnp
    from mxnet_tpu.kernels.fused_optimizer import fused_multi_sgd as ref
    from mxnet_tpu_torch.kernels.fused_optimizer import \
        fused_multi_sgd_reference
    ws, gs, ms = _group(1, momentum)
    wds = [wd, 0.0, wd, 0.1, wd, 0.0]
    kw = dict(lrs=LRS, wds=wds, rescale_grad=0.5, clip_gradient=clip)
    if momentum:
        kw["momentum"] = 0.9
    jo, jm = ref([jnp.asarray(w) for w in ws], [jnp.asarray(g) for g in gs],
                 None if ms is None else [jnp.asarray(m) for m in ms], **kw)
    m0 = None if ms is None else [m.copy() for m in ms]
    to, tm = fused_multi_sgd_reference(_t(ws), _t(gs), _t(ms), **kw)
    for i in range(len(SHAPES)):
        step = LRS[i] * np.clip(gs[i] * 0.5, -abs(clip) if clip >= 0 else
                                -np.inf, clip if clip >= 0 else np.inf)
        ops = [ws[i], step, np.asarray(jo[i])] + (
            [m0[i], np.asarray(jm[i])] if momentum else [])
        pairs = [(jo[i], to[i])] + ([(jm[i], tm[i])] if momentum else [])
        for want, got in pairs:
            want, got = np.asarray(want), got.numpy()
            assert got.shape == want.shape
            assert (np.abs(want - got) <= _ulps(*ops)).all()


@pytest.mark.parametrize("momentum,clip,wd", CASES)
def test_plain_bit_identical_to_reference_per_tensor_ops(momentum, clip, wd):
    """The plain version against the reference's per-tensor
    ``sgd_update`` / ``sgd_mom_update`` run eagerly: bit for bit."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import optimizer_ops as J
    from mxnet_tpu_torch.kernels.fused_optimizer import \
        fused_multi_sgd_reference
    ws, gs, ms = _group(2, momentum)
    wds = [wd] * len(SHAPES)
    kw = dict(lrs=LRS, wds=wds, rescale_grad=1.0 / 64, clip_gradient=clip)
    to, tm = fused_multi_sgd_reference(
        _t(ws), _t(gs), _t(ms), momentum=0.9 if momentum else 0.0, **kw)
    for i in range(len(SHAPES)):
        one = dict(lr=LRS[i], wd=wds[i], rescale_grad=1.0 / 64,
                   clip_gradient=clip)
        if momentum:
            w, m = J.sgd_mom_update(jnp.asarray(ws[i]), jnp.asarray(gs[i]),
                                    jnp.asarray(ms[i]), momentum=0.9, **one)
            assert _same(m, tm[i].numpy())
        else:
            w = J.sgd_update(jnp.asarray(ws[i]), jnp.asarray(gs[i]), **one)
        assert _same(w, to[i].numpy())


@pytest.mark.parametrize("momentum", [True, False])
@pytest.mark.parametrize("fused", ["1", "0"])
def test_grouped_ops_match_reference_ops(monkeypatch, momentum, fused):
    """``nd.multi_sgd(_mom)_update`` of both packages on one group (the
    reference test_operator.py case): new weights returned, inputs
    untouched, momenta mutated.  The reference's eager dispatch
    jit-compiles the op, so XLA:CPU contracts into FMAs on both of its
    routes (fused kernel and loop): within ``_ulps``."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    monkeypatch.setenv("MXNET_FUSED_OPTIMIZER", fused)
    ws, gs, ms = _group(3, True)
    wds = [0.0, 0.01, 0.1, 0.0, 1e-4, 0.0]
    kw = dict(lrs=LRS, wds=wds, rescale_grad=0.5, clip_gradient=1.0,
              num_weights=len(SHAPES))
    if momentum:
        kw["momentum"] = 0.9
    outs = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        w_nd = [pkg.nd.array(w, ctx=ctx) for w in ws]
        m_nd = [pkg.nd.array(m, ctx=ctx) for m in ms]
        data = []
        for i in range(len(SHAPES)):
            data += [w_nd[i], pkg.nd.array(gs[i], ctx=ctx)] + (
                [m_nd[i]] if momentum else [])
        op = pkg.nd.multi_sgd_mom_update if momentum \
            else pkg.nd.multi_sgd_update
        res = op(*data, **kw)
        assert len(res) == len(SHAPES)
        for w, w0 in zip(w_nd, ws):
            assert _same(w.asnumpy(), w0)
        outs.append(([r.asnumpy() for r in res],
                     [m.asnumpy() for m in m_nd]))
    (jw, jm), (tw, tm) = outs
    for i in range(len(SHAPES)):
        ops = [ws[i], ms[i], LRS[i] * np.clip(gs[i] * 0.5, -1, 1), jw[i],
               jm[i]]
        assert (np.abs(jw[i] - tw[i]) <= _ulps(*ops)).all()
        if momentum:
            assert (np.abs(jm[i] - tm[i]) <= _ulps(*ops)).all()
        else:
            assert _same(tm[i], ms[i])


@pytest.mark.parametrize("momentum", [True, False])
def test_grouped_route_bit_identical_to_per_tensor_route(momentum):
    """The port's grouped op (the kernel's route) against its per-tensor
    ops with ``out=``, on the same gradients: bit for bit."""
    import mxnet_tpu_torch as mx
    ws, gs, ms = _group(4, True)
    wds = [1e-4] * 3 + [0.0] * 3
    ctx = mx.cpu()
    g_nd = [mx.nd.array(g, ctx=ctx) for g in gs]
    a_w = [mx.nd.array(w, ctx=ctx) for w in ws]
    a_m = [mx.nd.array(m, ctx=ctx) for m in ms]
    b_w = [w.copy() for w in a_w]
    b_m = [m.copy() for m in a_m]
    hyper = dict(rescale_grad=1.0 / 32, clip_gradient=0.25)
    for i in range(len(SHAPES)):
        if momentum:
            mx.nd.sgd_mom_update(a_w[i], g_nd[i], a_m[i], out=a_w[i],
                                 lr=LRS[i], wd=wds[i], momentum=0.9, **hyper)
        else:
            mx.nd.sgd_update(a_w[i], g_nd[i], out=a_w[i], lr=LRS[i],
                             wd=wds[i], **hyper)
    data = []
    for i in range(len(SHAPES)):
        data += [b_w[i], g_nd[i]] + ([b_m[i]] if momentum else [])
    if momentum:
        mx.nd.multi_sgd_mom_update(*data, out=b_w, lrs=LRS, wds=wds,
                                   momentum=0.9, num_weights=len(SHAPES),
                                   **hyper)
    else:
        mx.nd.multi_sgd_update(*data, out=b_w, lrs=LRS, wds=wds,
                               num_weights=len(SHAPES), **hyper)
    for a, b in zip(a_w + (a_m if momentum else []),
                    b_w + (b_m if momentum else [])):
        assert _same(a.asnumpy(), b.asnumpy())


def test_dispatch_rule():
    """The grouped kernel runs only for num_weights > 1, an all-f32
    group, host-number rates and MXNET_FUSED_OPTIMIZER=1; the preloaded
    ops (array rates) take the loop and give the same numbers."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import optimizer_ops as O
    t = [torch.zeros(3), torch.zeros(2, dtype=torch.float64)]
    assert O._use_fused_group(t[:1]) and not O._use_fused_group(t)
    assert O._concrete_rates([0.1, 1], [0.0, np.float32(0.1)])
    assert not O._concrete_rates(torch.tensor([0.1]), [0.0])
    ws, gs, ms = _group(5, True)
    ctx = mx.cpu()
    kw = dict(momentum=0.9, rescale_grad=0.5, num_weights=len(SHAPES))
    wds = [1e-3] * len(SHAPES)

    def run(preloaded):
        m_nd = [mx.nd.array(m, ctx=ctx) for m in ms]
        data = []
        for i in range(len(SHAPES)):
            data += [mx.nd.array(ws[i], ctx=ctx), mx.nd.array(gs[i], ctx=ctx),
                     m_nd[i]]
        if preloaded:
            out = mx.nd.preloaded_multi_sgd_mom_update(
                *data, mx.nd.array(LRS, ctx=ctx), mx.nd.array(wds, ctx=ctx),
                **kw)
        else:
            out = mx.nd.multi_sgd_mom_update(*data, lrs=LRS, wds=wds, **kw)
        return [o.asnumpy() for o in out] + [m.asnumpy() for m in m_nd]

    for a, b in zip(run(False), run(True)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("momentum", [True, False])
def test_out_may_be_the_weights(momentum):
    """``out=`` the weights themselves (the in-place update) gives the
    same numbers as fresh outputs, and returns the ``out`` tensors."""
    from mxnet_tpu_torch.kernels.fused_optimizer import \
        fused_multi_sgd_reference
    ws, gs, ms = _group(6, momentum)
    kw = dict(lrs=LRS, wds=[1e-3] * len(SHAPES), momentum=0.9,
              rescale_grad=0.25, clip_gradient=2.0)
    fresh, m1 = fused_multi_sgd_reference(_t(ws), _t(gs), _t(ms), **kw)
    inplace = _t(ws)
    got, m2 = fused_multi_sgd_reference(inplace, _t(gs), _t(ms), out=inplace,
                                        **kw)
    assert all(a is b for a, b in zip(got, inplace))
    for a, b in zip(fresh + (m1 if momentum else []),
                    got + (m2 if momentum else [])):
        assert torch.equal(a, b)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    from mxnet_tpu_torch.kernels.fused_optimizer import fused_multi_sgd
    with pytest.raises(ValueError, match="need"):
        fused_multi_sgd([torch.zeros(2)], [torch.zeros(2)], lrs=[], wds=[])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_multi_sgd([torch.zeros(2, device="meta")],
                        [torch.zeros(2, device="meta")], lrs=[0.1],
                        wds=[0.0])


# ------------------------------------------------------------- on the card --
@pytest.mark.cuda
@pytest.mark.parametrize("momentum", [True, False])
@pytest.mark.parametrize("clip,wd", [(-1.0, 0.0), (0.5, 1e-4)])
def test_cuda_kernel_bit_identical_to_plain(cuda_device, momentum,  # noqa
                                            clip, wd):
    """The kernel against its plain version on the card, on a group of
    odd sizes (float4 body and scalar tails, chunk edges) and a view at
    an unaligned offset: bit for bit, one launch per call; and writing
    in place (``out=`` the weights) gives the same bits."""
    from mxnet_tpu_torch.kernels import fused_optimizer as FO
    g = torch.Generator().manual_seed(7)
    sizes = [1, 3, 1023, 4097, 5, 64, 3 * 4096 + 1]
    ws = [torch.randn(n, generator=g).to(cuda_device) for n in sizes]
    ws.append(torch.randn(4101, generator=g).to(cuda_device)[1:])
    gs = [10 * torch.randn(w.shape, generator=g).to(cuda_device)
          for w in ws]
    ms = [torch.randn(w.shape, generator=g).to(cuda_device) for w in ws] \
        if momentum else None
    ms2 = [m.clone() for m in ms] if momentum else None
    kw = dict(lrs=[0.05 * (i + 1) for i in range(len(ws))],
              wds=[wd] * len(ws), momentum=0.9, rescale_grad=1 / 64,
              clip_gradient=clip)
    counter = "sgd_mom_launches" if momentum else "sgd_launches"
    n = getattr(FO.fused_multi_sgd, counter)
    ms3 = [m.clone() for m in ms] if momentum else None
    o1, m1 = FO.fused_multi_sgd(ws, gs, ms, **kw)
    o2, m2 = FO.fused_multi_sgd_reference(ws, gs, ms2, **kw)
    inplace = [w.clone() for w in ws]        # out= the weights themselves
    o3, m3 = FO.fused_multi_sgd(inplace, gs, ms3, out=inplace, **kw)
    torch.cuda.synchronize()
    assert getattr(FO.fused_multi_sgd, counter) == n + 2
    assert all(a is b for a, b in zip(o3, inplace))
    for a, b, c in zip(o1 + (m1 if momentum else []),
                       o2 + (m2 if momentum else []),
                       o3 + (m3 if momentum else [])):
        assert torch.equal(a + 0.0, b + 0.0)
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_kernel_reuses_its_table_only_for_the_same_key(
        cuda_device):  # noqa: F811
    """Repeated in-place updates of one group reuse the kept device
    table; a change of rates builds a new one.  Each of the three calls
    equals the plain version stepping the same copies, bit for bit."""
    from mxnet_tpu_torch.kernels import fused_optimizer as FO
    g = torch.Generator().manual_seed(8)
    sizes = [5, 4097, 3 * 4096 + 1]
    ws = [torch.randn(n, generator=g).to(cuda_device) for n in sizes]
    gs = [torch.randn(n, generator=g).to(cuda_device) for n in sizes]
    ms = [torch.zeros(n, device=cuda_device) for n in sizes]
    ws2, ms2 = [w.clone() for w in ws], [m.clone() for m in ms]
    FO._TABLES.clear()
    for lrs in ([0.1, 0.2, 0.3], [0.1, 0.2, 0.3], [0.3, 0.2, 0.1]):
        kw = dict(lrs=lrs, wds=[1e-4] * 3, momentum=0.9)
        FO.fused_multi_sgd(ws, gs, ms, out=ws, **kw)
        FO.fused_multi_sgd_reference(ws2, gs, ms2, out=ws2, **kw)
        torch.cuda.synchronize()
        for a, b in zip(ws + ms, ws2 + ms2):
            assert torch.equal(a + 0.0, b + 0.0)
    assert len(FO._TABLES) == 2
