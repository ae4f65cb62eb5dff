"""The split paged-attention kernels (``csrc/paged_attention.cu``:
``paged_split`` and ``paged_combine``), emulated in torch on the CPU and
held against the port's plain version and the reference Pallas kernel
(interpreter mode), from the same numpy draws; then, marked ``cuda``,
the kernels against their plain version on the card.

The emulation follows the kernels' order: split s of a row walks pages
[s*pps, min((s+1)*pps, last+1)), pps = ``split_pages(ps)``, last =
min(pos // ps, PP - 1); a split past the last page writes nothing (its
workspace rows stay NaN here, as ``torch.empty`` leaves them undefined on
the card); inside a split the scores (times the k scale, divided by
sqrt(dh), -1e30 above pos), the split's max, p = exp(s - m), l of the
unscaled p and the weights (times the v scale, rounded to the compute
dtype) before an f32 PV; the combine derives the live splits from pos
and rescales each by exp(m_s - M) in split order.

Limits: f32 within 3e-6 (the reference file's tolerance); bf16 and int8
pools within ``chip_smoke.PAGED_ROUND``'s 1e-5 + 8e-3 * (the plain
version on |v|): each weight is rounded once relative to its split's
max instead of the running max, at most 2^-8 relative, then rescaled in
f32.  A combine that also reads a dead split must come out NaN or
outside them."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from test_torch_paged_attention import _jax, _port

_F32_TOL = 3e-6
KINDS = ("float32", "bfloat16", "int8")


def _draw(kind, T=6, H=2, dh=8, ps=16, PP=10, NP=23, seed=0):
    """Numpy q, pool, scales and block table; int8 pools go with a bf16
    query, as the serving engine's int8 KV cache does."""
    rng = np.random.RandomState(seed)
    q = rng.randn(T, H, dh).astype(np.float32)
    if kind == "int8":
        pool = rng.randint(-127, 128, (NP, ps, H, 2 * dh)).astype(np.int8)
        scale = (np.abs(rng.randn(NP, 2, ps, H)) * 0.02 + 1e-4) \
            .astype(np.float32)
    else:
        pool = rng.randn(NP, ps, H, 2 * dh).astype(np.float32)
        scale = None
    bt = rng.randint(1, NP, (T, PP)).astype(np.int32)
    return q, pool, scale, bt, "float32" if kind == "float32" else "bfloat16"


def _torch_args(q, pool, scale, bt, pos, dtype, device="cpu"):
    dt = getattr(torch, dtype)
    pt = torch.from_numpy(pool).to(device)
    return (torch.from_numpy(q).to(device, dt),
            pt if pool.dtype == np.int8 else pt.to(dt),
            None if scale is None else torch.from_numpy(scale).to(device),
            torch.from_numpy(bt).to(device),
            torch.tensor(pos, dtype=torch.int32, device=device))


def split_walk(q, pool, scales, bt, pos, ps, combine_dead=False):
    """``paged_split`` then ``paged_combine``: (T, H, dh) f32.
    ``combine_dead`` reads every split, dead ones included."""
    from mxnet_tpu_torch.kernels.paged_attention import split_pages
    T, H, dh = q.shape
    PP = bt.shape[1]
    pps = split_pages(ps)
    NS = -(-PP // pps)
    sqrt_dh = torch.tensor(np.sqrt(np.float32(dh)))
    part = torch.full((T, H, NS, dh + 2), float("nan"))
    lasts = [min(int(p) // ps, PP - 1) for p in pos]
    for t in range(T):
        for sp in range(NS):
            j0 = sp * pps
            if j0 > lasts[t]:
                continue
            pages = bt[t, j0:min(j0 + pps, lasts[t] + 1)].long()
            n = len(pages) * ps
            kv = pool[pages].reshape(n, H, 2 * dh).float()
            s = torch.einsum("nhd,hd->hn", kv[..., :dh], q[t].float())
            if scales is not None:
                s = s * scales[pages, 0].reshape(n, H).T
            s = s / sqrt_dh
            kpos = j0 * ps + torch.arange(n)
            s = torch.where(kpos[None, :] <= int(pos[t]), s,
                            torch.tensor(-1e30))
            m = s.amax(-1)
            e = torch.exp(s - m[:, None])
            w = e if scales is None else e * scales[pages, 1].reshape(n, H).T
            w = w.to(q.dtype).float()
            part[t, :, sp, 0] = m
            part[t, :, sp, 1] = e.sum(-1)
            part[t, :, sp, 2:] = torch.einsum("hn,nhd->hd", w, kv[..., dh:])
    out = torch.empty(T, H, dh)
    for t in range(T):
        live = NS if combine_dead else lasts[t] // pps + 1
        pr = part[t, :, :live]
        M = pr[..., 0].amax(-1)
        l = torch.zeros(H)
        acc = torch.zeros(H, dh)
        for sp in range(live):                # split order, as the kernel
            f = torch.exp(pr[:, sp, 0] - M)
            l = l + pr[:, sp, 1] * f
            acc = acc + pr[:, sp, 2:] * f[:, None]
        out[t] = acc / l[:, None]
    return out


def _limit(q, pool, scale, bt, pos, ps, dtype):
    """The bf16 / int8 bar: 1e-5 + PAGED_ROUND * (plain version on |v|)."""
    from chip_smoke import PAGED_ROUND
    dh = q.shape[2]
    absv = pool.copy()
    absv[..., dh:] = np.abs(absv[..., dh:])
    return 1e-5 + PAGED_ROUND * _port(q, absv, scale, bt, pos, ps,
                                      dtype).numpy()


def _held(got, want, limit):
    got = np.asarray(got)
    return bool(np.isfinite(got).all()) and bool(
        (np.abs(got - want) <= limit).all())


CASES = {
    # ps 16, PP 10: 4 pages (64 positions) a split, 3 splits, the last
    # with 2 pages.  Split edges: the last slot of split 0, the first of
    # split 1, a ragged mid page, the first page only, the whole view
    # (pos = PP*ps - 1), and the slot before the last split.
    "split_edges": (dict(), [63, 64, 100, 5, 159, 127]),
    # one live split, the rest dead; pos 0 reads one slot
    "past_last_page": (dict(T=3), [0, 3, 15]),
    # dh 10: no row of any pool takes 16-byte loads (the scalar loop)
    "odd_dh": (dict(dh=10, T=4, seed=2), [17, 64, 159, 70]),
    # ps 8, PP 20: 8 pages a split, the last split 4 pages
    "page_8": (dict(ps=8, PP=20, NP=41, T=4, seed=3), [63, 64, 159, 130]),
}


def _case(name, kind):
    kw, pos = CASES[name]
    q, pool, scale, bt, dtype = _draw(kind, **kw)
    return q, pool, scale, bt, pos, kw.get("ps", 16), dtype


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_walk_matches_plain_and_reference(case, kind):
    q, pool, scale, bt, pos, ps, dtype = _case(case, kind)
    got = split_walk(*_torch_args(q, pool, scale, bt, pos, dtype), ps)
    plain = _port(q, pool, scale, bt, pos, ps, dtype).numpy()
    out_k, out_r = _jax(q, pool, scale, bt, pos, ps, dtype)
    limit = (_F32_TOL * (1 + np.abs(plain)) if kind == "float32"
             else _limit(q, pool, scale, bt, pos, ps, dtype))
    for want in (plain, out_k, out_r):
        assert _held(got.numpy(), want, limit), np.abs(got.numpy()
                                                       - want).max()


@pytest.mark.parametrize("kind", KINDS)
def test_split_walk_scratch_and_shared_pages(kind):
    """The engine's dead rows (an all-zero block-table row, scratch page
    0, pos 0) and aliased tables (prefix reuse, a repeated page)."""
    q, pool, scale, bt, dtype = _draw(kind, T=4, seed=4)
    bt = bt.copy()
    bt[0] = 0
    bt[1] = bt[2]
    bt[3] = bt[3, 0]
    pos = [0, 140, 70, 159]
    got = split_walk(*_torch_args(q, pool, scale, bt, pos, dtype), 16)
    plain = _port(q, pool, scale, bt, pos, 16, dtype).numpy()
    out_k, _ = _jax(q, pool, scale, bt, pos, 16, dtype)
    limit = (_F32_TOL * (1 + np.abs(plain)) if kind == "float32"
             else _limit(q, pool, scale, bt, pos, 16, dtype))
    assert _held(got.numpy(), plain, limit)
    assert _held(got.numpy(), out_k, limit)


@pytest.mark.parametrize("kind", KINDS)
def test_combining_a_dead_split_fails(kind):
    """A combine that reads every split, dead ones included, reads
    partials no split wrote: it must not pass."""
    q, pool, scale, bt, pos, ps, dtype = _case("split_edges", kind)
    args = _torch_args(q, pool, scale, bt, pos, dtype)
    plain = _port(q, pool, scale, bt, pos, ps, dtype).numpy()
    limit = (_F32_TOL * (1 + np.abs(plain)) if kind == "float32"
             else _limit(q, pool, scale, bt, pos, ps, dtype))
    assert _held(split_walk(*args, ps).numpy(), plain, limit)
    assert not _held(split_walk(*args, ps, combine_dead=True).numpy(),
                     plain, limit)


def test_split_count_is_a_function_of_shapes():
    """About 64 positions a split, at least one page; the walk needs no
    device data to size its grid."""
    from mxnet_tpu_torch.kernels.paged_attention import split_pages
    assert [split_pages(ps) for ps in (1, 4, 16, 32, 64, 100)] == \
        [64, 16, 4, 2, 1, 1]


def test_vector_loads_needs_aligned_rows():
    """16-byte loads need a 16-byte-aligned pool and k/v half rows of a
    multiple of 16 bytes; everything else takes the scalar loop."""
    from mxnet_tpu_torch.kernels.paged_attention import vector_loads
    for dtype, dh, want in ((torch.bfloat16, 64, True),
                            (torch.bfloat16, 12, False),
                            (torch.float32, 12, True),
                            (torch.int8, 16, True), (torch.int8, 24, False)):
        pool = torch.zeros(3, 4, 2, 2 * dh, dtype=dtype)
        assert vector_loads(pool, dh) is want
    buf = torch.zeros(3 * 4 * 2 * 128 + 1, dtype=torch.bfloat16)
    assert not vector_loads(buf[1:].view(3, 4, 2, 128), 64)


# ------------------------------------------------------------- on the card --
def _card(kind, path, dev, seed):
    """Engine-shaped inputs (T=32, H=12, ps=16, PP=32) on the card: the
    pool as drawn (``vector``), one element into a larger buffer
    (``offset``: not 16-byte aligned) or at dh 18 (``odd_dh``: 36, 72 or
    18 bytes a half row)."""
    dh = 18 if path == "odd_dh" else 64
    q, pool, scale, bt, dtype = _draw(kind, T=32, H=12, dh=dh, PP=32,
                                      NP=513, seed=seed)
    rng = np.random.RandomState(seed + 1)
    pos = rng.randint(0, 512, 32)
    pos[:2] = 0
    pos[2] = 511
    bt[:2] = 0
    bt[bt == 512] = 1          # page 512 stays free for the poisoned table
    args = list(_torch_args(q, pool, scale, bt, pos, dtype, device=dev))
    if path == "offset":
        flat = torch.empty(args[1].numel() + 1, dtype=args[1].dtype,
                           device=dev)
        flat[1:] = args[1].reshape(-1)
        args[1] = flat[1:].view(args[1].shape)
    return q, pool, scale, bt, pos, dtype, args


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["vector", "offset", "odd_dh"])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_split_kernels_match_plain(cuda_device, kind, path):  # noqa: F811
    """Both load paths against the plain version: f32 within 1e-5 (the
    card's bar), bf16 and int8 within the PAGED_ROUND limit; two calls
    bit-identical; one launch counted per call."""
    from mxnet_tpu_torch.kernels import paged_attention as PA
    q, pool, scale, bt, pos, dtype, args = _card(kind, path, cuda_device, 8)
    assert PA.vector_loads(args[1], q.shape[2]) is (path == "vector")
    before = PA.paged_attention.launches
    got = PA.paged_attention(*args, page_size=16)
    again = PA.paged_attention(*args, page_size=16)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 2
    assert torch.equal(got, again)
    plain = _port(q, pool, scale, bt, pos, 16, dtype).numpy()
    limit = (1e-5 * (1 + np.abs(plain)) if kind == "float32"
             else _limit(q, pool, scale, bt, pos, 16, dtype))
    assert _held(got.cpu().numpy(), plain, limit), \
        np.abs(got.cpu().numpy() - plain).max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_pages_past_the_last_are_not_read(cuda_device, kind):  # noqa: F811
    """Every block-table entry past a row's last page names a page of
    NaN (inf for int8, through its scales): the output stays finite and
    equal to the call with a clean table."""
    from mxnet_tpu_torch.kernels import paged_attention as PA
    q, pool, scale, bt, pos, dtype, args = _card(kind, "vector",
                                                 cuda_device, 9)
    clean = PA.paged_attention(*args, page_size=16)
    pool_p = args[1].clone()
    scale_p = None if args[2] is None else args[2].clone()
    if scale_p is None:
        pool_p[-1] = float("nan")
    else:
        scale_p[-1] = float("inf")
    bt_p = args[3].clone()
    last = torch.clamp(args[4].long() // 16, max=31)
    past = torch.arange(32, device=cuda_device)[None, :] > last[:, None]
    bt_p[past] = pool_p.shape[0] - 1
    got = PA.paged_attention(args[0], pool_p, scale_p, bt_p, args[4],
                             page_size=16)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)
