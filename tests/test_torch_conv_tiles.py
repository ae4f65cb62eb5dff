"""The bf16 tensor-core convolution's tile walk, emulated in torch on the
CPU: ``conv3x3_tc`` (``csrc/fused_conv.cu``) cannot run here, so this
rehearses its index logic against the plain version
``conv3x3_fused_reference`` of ``mxnet_tpu_torch.kernels.fused_conv``.

The emulation walks tiles of BM consecutive pixels of the flattened
B*H*W (a tile may cross rows and images) by BN output channels, (BM,
BN) = (256, 64) when K <= 64, else (128, 128).  Per chunk of CC = 32
input channels it stages the window: window row s holds flattened pixel
p0 - 1 + (dy-1)*W + (s - dy*SS), dy = min(s // SS, 2), SS = min(W,
BM + 2), with the prologue applied in f32 (two rounded ops), rounded to
bf16, zero past B*H*W and past C, and one all-zero row after it.  Tap
(dy, dx) of tile pixel i reads window row dy*SS + i + dx when the tap's
source row and column lie in the pixel's own image, else the zero row;
pixels past B*H*W read as the last pixel.  Weight slabs are zero past C
and K.  The stats follow the kernel's fixed order: a thread's 8 rows of
a column (rows g, g + 8 of its warp's 16-pixel tiles 0..3), the 8 lanes
g pairwise (__shfl_xor 4, 8, 16), the BM / 64 pixel warps in order, then
the second pass over the partial rows (row r of 32 takes partials r,
r + 32, ...; then rows 0..31).

Limits: y within ``chip_smoke.conv_limits`` of the plain version, the
emulated f32 accumulator within its slack, and the sums within
``chip_smoke.conv_stats_limits`` of an f64 reduction of that
accumulator, with every dropped partial row caught -- the bars the card
holds the kernel to.  Four mutants must fail them: the halo zeroed
before the prologue, dy and dx swapped in the window row, a tile that
crosses images reading the neighbouring image's row, and partial rows
that count the padded pixels past B*H*W."""
import itertools

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import fused_conv as FC

CC = 32
MUTANTS = ("halo_before_prologue", "swap_dy_dx", "cross_image",
           "count_padded")


def _prologue(v, scale, shift, relu):
    """The kernel's staging of f32 values of channels ``scale``/``shift``:
    x*scale + shift (two rounded ops), max(., 0), rounded to bf16."""
    if scale is not None:
        v = v * scale + shift
    if relu:
        v = torch.clamp_min(v, 0.0)
    return v.bfloat16().float()


def tiles_conv(x, w, scale=None, shift=None, relu=False, mutant=None):
    """``conv3x3_tc`` in its tile order: (the f32 accumulator (B, H, W,
    K), the partial rows (2, tiles, K), the sums (2, K))."""
    B, H, W, C = x.shape
    K = w.shape[3]
    BM, BN = _tile(K)
    P = B * H * W
    T = -(-P // BM)
    Kp = -(-K // BN) * BN
    Cp = -(-C // CC) * CC
    SS = min(W, BM + 2)
    NS = 2 * SS + BM + 2
    xf = _pad_cols(x.float().reshape(P, C), Cp)
    wf = torch.zeros(3, 3, Cp, Kp)
    wf[:, :, :C, :K] = w.float()
    sc = sh = None
    if scale is not None:
        sc = _pad_cols(scale.float()[None], Cp)[0]
        sh = _pad_cols(shift.float()[None], Cp)[0]
    cmask = torch.arange(Cp) < C

    p0 = torch.arange(T)[:, None] * BM                        # (T, 1)
    s = torch.arange(NS)[None, :]
    dyw = torch.clamp(s // SS, max=2)
    q = p0 - 1 + (dyw - 1) * W + (s - dyw * SS)               # (T, NS)
    qok = (q >= 0) & (q < P)
    i = torch.arange(BM)[None, :]
    p = torch.clamp(p0 + i, max=P - 1)                        # the lane's pixel
    arow = p - p0
    h, wc = (p // W) % H, p % W

    acc = torch.zeros(T, BM, Kp)
    for c0 in range(0, Cp, CC):
        win = torch.zeros(T, NS + 1, CC)
        vals = xf[q.clamp(0, P - 1), c0:c0 + CC]              # (T, NS, CC)
        if sc is not None or relu:
            vals = _prologue(vals, None if sc is None else sc[c0:c0 + CC],
                             None if sh is None else sh[c0:c0 + CC], relu)
        ok = qok[..., None] & cmask[c0:c0 + CC][None, None, :]
        win[:, :NS] = torch.where(ok, vals, torch.tensor(0.0))
        if mutant == "halo_before_prologue":
            zero = torch.zeros(1, CC)
            if sc is not None or relu:
                zero = _prologue(zero, None if sc is None
                                 else sc[c0:c0 + CC],
                                 None if sh is None else sh[c0:c0 + CC],
                                 relu)
            win[:, NS] = torch.where(cmask[c0:c0 + CC], zero[0],
                                     torch.tensor(0.0))
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            hh, ww = h + dy - 1, wc + dx - 1
            inside = (ww >= 0) & (ww < W)
            if mutant == "cross_image":     # only the flattened range
                src = p + (dy - 1) * W + (dx - 1)
                inside &= (src >= 0) & (src < P)
            else:
                inside &= (hh >= 0) & (hh < H)
            ry, rx = (dx, dy) if mutant == "swap_dy_dx" else (dy, dx)
            row = torch.where(inside, ry * SS + arow + rx,
                              torch.tensor(NS))               # (T, BM)
            a = torch.gather(win, 1, row[..., None].expand(T, BM, CC))
            acc = acc + a @ wf[dy, dx, c0:c0 + CC]
    acc = acc[:, :, :K]

    valid = (p0 + i < P)[..., None]
    if mutant == "count_padded":
        valid = torch.ones_like(valid)
    part = torch.stack([_block_partials(acc, valid, sq)
                        for sq in (False, True)])
    sums = torch.stack([_second_pass(part[k]) for k in range(2)])
    return acc.reshape(T * BM, K)[:P].reshape(B, H, W, K), part, sums


def _tile(K):
    """The kernel's (BM, BN) for K output channels."""
    return (256, 64) if K <= 64 else (128, 128)


def _pad_cols(t, n):
    """t (R, C) zero-padded to n columns."""
    return torch.nn.functional.pad(t, (0, n - t.shape[1]))


def _block_partials(acc, valid, square):
    """Each tile's f32 partial of (T, BM, K) in the kernel's order."""
    T, BM, K = acc.shape
    WMS = BM // 64
    v = torch.where(valid, acc * acc if square else acc, torch.tensor(0.0))
    v = v.reshape(T, WMS, 4, 2, 8, K)               # (warp, tile, half, g)
    t = torch.zeros(T, WMS, 8, K)
    for mi in range(4):
        for hf in range(2):
            t = t + v[:, :, mi, hf]
    t = t[:, :, 0::2] + t[:, :, 1::2]               # __shfl_xor 4
    t = t[:, :, 0::2] + t[:, :, 1::2]               # 8
    t = t[:, :, 0] + t[:, :, 1]                     # 16
    out = torch.zeros(T, K)
    for wm in range(WMS):
        out = out + t[:, wm]
    return out


def _second_pass(part):
    """reduce_stats_kernel's fixed order over the (rows, K) partials."""
    rows, K = part.shape
    r32 = torch.zeros(32, K)
    for r in range(0, rows, 32):
        blk = part[r:r + 32]
        r32[:blk.shape[0]] = r32[:blk.shape[0]] + blk
    out = torch.zeros(K)
    for r in range(32):
        out = out + r32[r]
    return out


def _verdict(x, w, kw, mutant=None):
    """(y, accumulator, stats) of the emulation against the card's
    limits: a list of the checks that failed."""
    from chip_smoke import conv_limits, conv_stats_verdict
    acc, _, sums = tiles_conv(x, w, kw.get("scale"), kw.get("shift"),
                              kw.get("relu", False), mutant)
    out = kw.get("out_dtype") or x.dtype
    y = acc.to(out)
    ref = FC.conv3x3_fused_reference(x, w, **kw)
    y_ref = ref[0] if kw.get("stats") else ref
    y_lim, acc_lim, acc_ref = conv_limits(x, w, kw)
    failed = []
    if not bool(((y.float() - y_ref.float()).abs() <= y_lim).all()):
        failed.append("y")
    if not bool(((acc - acc_ref).abs() <= acc_lim).all()):
        failed.append("accumulator")
    if kw.get("stats"):
        ratio, planted, _ = conv_stats_verdict(sums, acc, _tile(w.shape[3])[0],
                                               False)
        if not ratio <= 1:
            failed.append("stats")
        if not planted > 1:
            failed.append("planted")
    return failed


def _case(B, H, W, C, K, flags, seed, out_dtype=None):
    from chip_smoke import conv_inputs, conv_kw
    x, w, sc, sh = conv_inputs("cpu", B, H, W, C, torch.bfloat16,
                               np.random.RandomState(seed), K=K)
    return x, w, conv_kw(flags, sc, sh, None, None, out_dtype)


FLAGS = [dict(), dict(scale=1, relu=True, stats=True),
         dict(scale=1, stats=True), dict(relu=True)]
# the experiment's four shapes at batch 2 (56x56: tiles cross rows; the
# others cross images), then the ragged ones
SHAPES = [(2, 56, 56, 64, 64), (2, 28, 28, 128, 128), (2, 14, 14, 256, 256),
          (3, 7, 7, 512, 512)]
RAGGED = [(3, 5, 6, 20, 24), (2, 9, 1, 16, 8), (4, 3, 3, 8, 72),
          (1, 2, 200, 8, 16)]


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("shape", SHAPES + RAGGED)
def test_tile_walk(shape, flags):
    """The walk at the four experiment shapes and ragged ones (C = 20,
    K = 24; W = 1; H*W = 9 below one tile with K = 72 over two channel
    blocks; W = 200, wider than a tile, where the window is three runs)
    within the card's limits."""
    B, H, W, C, K = shape
    x, w, kw = _case(B, H, W, C, K, flags, seed=H * W + C)
    assert _verdict(x, w, kw) == []


def test_tile_walk_f32_out():
    """bf16 in, f32 out: y is the accumulator itself."""
    x, w, kw = _case(2, 14, 14, 32, 40, FLAGS[1], seed=4,
                     out_dtype=torch.float32)
    assert _verdict(x, w, kw) == []


@pytest.mark.parametrize("shape", [(3, 7, 7, 64, 64), (2, 14, 14, 32, 72)])
@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutants_fail(shape, mutant):
    """Each mutant of the walk fails the card's limits (with the
    prologue and the stats, at shapes whose tiles cross images and end
    past B*H*W)."""
    B, H, W, C, K = shape
    x, w, kw = _case(B, H, W, C, K, FLAGS[1], seed=11)
    assert _verdict(x, w, kw) == []
    assert _verdict(x, w, kw, mutant) != []


def test_window_rows_reach_every_tap():
    """Window row dy*SS + i + dx holds flattened pixel p0 + i + (dy-1)*W
    + (dx-1) for every tile pixel and tap, narrow and wide images."""
    for (BM, _), W in itertools.product(map(_tile, (64, 128)),
                                        (1, 3, 56, 129, 130, 131, 257,
                                         258, 259, 717)):
        SS = min(W, BM + 2)
        NS = 2 * SS + BM + 2
        s = torch.arange(NS)
        dyw = torch.clamp(s // SS, max=2)
        held = -1 + (dyw - 1) * W + (s - dyw * SS)            # p0 = 0
        i = torch.arange(BM)
        for dy in range(3):
            for dx in range(3):
                rows = dy * SS + i + dx
                assert bool((rows < NS).all())
                assert torch.equal(held[rows], i + (dy - 1) * W + dx - 1)
