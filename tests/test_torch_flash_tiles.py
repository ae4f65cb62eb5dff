"""The bf16 tensor-core flash kernels' tile order, emulated in torch on
the CPU: ``flash_fwd_tc`` (``csrc/flash_fwd.cu``), ``flash_bwd_dkv_tc``
and ``flash_bwd_dq_tc`` (``csrc/flash_bwd.cu``) cannot run here, so
this rehearses their index logic against the plain versions of
``mxnet_tpu_torch.kernels.flash_attention``.

The forward emulation walks 64-query tiles over key tiles of 64 (32 at
dh 256), zero-padded past T as cp.async's zero-fill pads them, with the
kernel's base-2 online softmax (scores times scale*log2(e), masked keys
-1e30*log2(e), keys past T -inf), the undropped denominator, the keep
bit of each element's absolute positions, and p~ rounded to bf16 per
tile before P~V.  The dK/dV emulation walks 64-key blocks over query
tiles of 64 (32 above dh 64) from the diagonal tile when causal, with
keys as rows and the hash called as (bh, q_pos, k_pos), and rounds P~
and dS to bf16 before their products.  The dQ emulation walks 64-query
tiles over key tiles of 64 (32 above dh 64), stopping at the diagonal
tile when causal, with lse in base 2 and dS rounded to bf16 before
dS K.

Limits: the forward's O against the plain version run in f32 on the
same bf16 inputs within ``chip_smoke.fwd_limit`` (FWD_ROUND), lse
within its f32 1e-4; dQ, dK and dV within ``chip_smoke.bwd_limits`` --
the bars the card holds the kernels to.  A dK/dV or dQ walk that calls
the hash with the positions swapped must fail them once dropout is on,
and a causal dQ walk that stops one key tile early must fail them."""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import flash_attention as FA

LOG2E = float(np.float32(1.4426950408889634))
LN2 = float(np.float32(0.6931471805599453))
MASKED = float(np.float32(-1e30) * np.float32(LOG2E))
RATE = 0.1


def _inputs(B, T, H, dh, use_mask, causal, seed):
    """bf16 q, k, v, dO and a (B, T) key mask.  Without causal, the last
    batch row's keys are all masked (its softmax is uniform over the T
    keys in kernel and plain version alike).  With causal, key 0 is
    kept in every row: a query whose keys up to the diagonal are all
    masked is uniform over all T keys in the plain version, but only
    over the tiles up to the diagonal in the kernels (and in the
    reference's Pallas kernel), so that case has no common answer."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, T, H, dh).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    mask = None
    if use_mask:
        m = rng.rand(B, T) > 0.3
        m[:, 0] = True
        if not causal:
            m[-1] = False
        mask = torch.from_numpy(m)
    return q, k, v, do, mask


def _bhtd(x):
    return x.float().permute(0, 2, 1, 3)    # (B, T, H, d) -> (B, H, T, d)


def _pad_rows(x, r0, n):
    """Rows [r0, r0 + n) of (B, H, T, d), zeros past T."""
    out = x[:, :, r0:r0 + n]
    if out.shape[2] < n:
        pad = torch.zeros(*out.shape[:2], n - out.shape[2], *out.shape[3:],
                          dtype=out.dtype)
        out = torch.cat([out, pad], 2)
    return out


def _key_mask(mask, B, T, cols):
    """(B, len(cols)) bool: the mask's byte at each column, 0 past T."""
    m = torch.ones(B, T, dtype=torch.bool) if mask is None else mask.bool()
    return m[:, cols.clamp(max=T - 1)] & (cols < T)[None, :]


def _keep(B, H, rows, cols, seed):
    bh = torch.arange(B * H).view(B, H, 1, 1)
    return FA._dropout_keep(bh, rows, cols, seed, RATE)


def tiles_fwd(q, k, v, mask, causal, dropout, seed):
    """``flash_fwd_tc`` in its tile order: (O bf16, lse (B, H, T) f32)."""
    B, T, H, dh = q.shape
    BQ, BK = 64, (64 if dh <= 128 else 32)
    scale2 = float(np.float32(1.0 / math.sqrt(dh)) * np.float32(LOG2E))
    inv = FA._inv_keep(RATE)
    qf, kf, vf = _bhtd(q), _bhtd(k), _bhtd(v)
    out = torch.zeros(B, H, T, dh)
    lse = torch.zeros(B, H, T)
    for q0 in range(0, T, BQ):
        rows = q0 + torch.arange(BQ)
        qt = _pad_rows(qf, q0, BQ)
        nk = -(-T // BK)
        if causal:
            nk = min(nk, -(-min(q0 + BQ, T) // BK))
        m = torch.full((B, H, BQ), -math.inf)
        l = torch.zeros(B, H, BQ)
        acc = torch.zeros(B, H, BQ, dh)
        for kt in range(nk):
            cols = kt * BK + torch.arange(BK)
            s = qt @ _pad_rows(kf, kt * BK, BK).transpose(-1, -2)
            valid = _key_mask(mask, B, T, cols)[:, None, None, :]
            if causal:
                valid = valid & (cols[None, :] <= rows[:, None])
            x = torch.where(valid, s * scale2, torch.tensor(MASKED))
            x = torch.where((cols < T)[None, None, None, :], x,
                            torch.tensor(-math.inf))
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(x - mn[..., None])
            l = l * alpha + p.sum(-1)
            if dropout:
                p = torch.where(_keep(B, H, rows, cols, seed), p * inv,
                                torch.tensor(0.0))
            acc = acc * alpha[..., None] \
                + p.bfloat16().float() @ _pad_rows(vf, kt * BK, BK)
            m = mn
        lc = l.clamp(min=1e-30)
        n = min(BQ, T - q0)
        out[:, :, q0:q0 + n] = (acc * (1.0 / lc)[..., None])[:, :, :n]
        lse[:, :, q0:q0 + n] = (m * LN2 + torch.log(lc))[:, :, :n]
    return out.permute(0, 2, 1, 3).bfloat16(), lse


def tiles_dkv(q, k, v, do, lse, delta, mask, causal, dropout, seed,
              swap_hash=False):
    """``flash_bwd_dkv_tc`` in its tile order: (dK, dV) bf16.
    ``swap_hash`` calls the hash as (bh, k_pos, q_pos), the fault a
    key-major loop invites."""
    B, T, H, dh = q.shape
    BK, BQ = 64, (64 if dh <= 64 else 32)
    sm_scale = float(np.float32(1.0 / math.sqrt(dh)))
    scale2 = float(np.float32(sm_scale) * np.float32(LOG2E))
    inv = FA._inv_keep(RATE)
    qf, kf, vf, dof = _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do)
    dk = torch.zeros(B, H, T, dh)
    dv = torch.zeros(B, H, T, dh)
    for k0 in range(0, T, BK):
        keys = k0 + torch.arange(BK)
        kon = _key_mask(mask, B, T, keys)[:, None, :, None]
        kt, vt = _pad_rows(kf, k0, BK), _pad_rows(vf, k0, BK)
        dka = torch.zeros(B, H, BK, dh)
        dva = torch.zeros(B, H, BK, dh)
        for q0 in range((k0 // BQ if causal else 0) * BQ, T, BQ):
            qs = q0 + torch.arange(BQ)
            qt, dot = _pad_rows(qf, q0, BQ), _pad_rows(dof, q0, BQ)
            ls = _pad_rows(lse[..., None], q0, BQ)[..., 0]
            dl = _pad_rows(delta[..., None], q0, BQ)[..., 0]
            sT = kt @ qt.transpose(-1, -2)              # keys x queries
            dpT = vt @ dot.transpose(-1, -2)
            valid = kon & (qs < T)[None, None, None, :]
            if causal:
                valid = valid & (keys[:, None] <= qs[None, :])
            p = torch.where(valid, torch.exp2(sT * scale2
                                              - ls[..., None, :] * LOG2E),
                            torch.tensor(0.0))
            pd = p
            if dropout:
                keep = (_keep(B, H, keys, qs, seed) if swap_hash
                        else _keep(B, H, qs, keys, seed).transpose(-1, -2))
                pd = torch.where(keep, p * inv, torch.tensor(0.0))
                dpT = torch.where(keep, dpT * inv, torch.tensor(0.0))
            ds = p * (dpT - dl[..., None, :]) * sm_scale
            dva = dva + pd.bfloat16().float() @ dot
            dka = dka + ds.bfloat16().float() @ qt
        n = min(BK, T - k0)
        dk[:, :, k0:k0 + n] = dka[:, :, :n]
        dv[:, :, k0:k0 + n] = dva[:, :, :n]
    return (dk.permute(0, 2, 1, 3).bfloat16(),
            dv.permute(0, 2, 1, 3).bfloat16())


def tiles_dq(q, k, v, do, lse, delta, mask, causal, dropout, seed,
             swap_hash=False, early_stop=False):
    """``flash_bwd_dq_tc`` in its tile order: dQ bf16.  ``swap_hash``
    calls the hash as (bh, k_pos, q_pos); ``early_stop`` ends a causal
    walk one key tile before the diagonal tile."""
    B, T, H, dh = q.shape
    BQ, BK = 64, (64 if dh <= 64 else 32)
    sm_scale = float(np.float32(1.0 / math.sqrt(dh)))
    scale2 = float(np.float32(sm_scale) * np.float32(LOG2E))
    inv = FA._inv_keep(RATE)
    qf, kf, vf, dof = _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do)
    lse2 = lse * LOG2E                       # the kernel's base-2 lse
    dq = torch.zeros(B, H, T, dh)
    for q0 in range(0, T, BQ):
        rows = q0 + torch.arange(BQ)
        qt, dot = _pad_rows(qf, q0, BQ), _pad_rows(dof, q0, BQ)
        ls = _pad_rows(lse2[..., None], q0, BQ)[..., 0]
        dl = _pad_rows(delta[..., None], q0, BQ)[..., 0]
        nk = -(-T // BK)
        if causal:
            nk = min(nk, -(-min(q0 + BQ, T) // BK)) - int(early_stop)
        acc = torch.zeros(B, H, BQ, dh)
        for kt in range(nk):
            cols = kt * BK + torch.arange(BK)
            ktile = _pad_rows(kf, kt * BK, BK)
            s = qt @ ktile.transpose(-1, -2)            # queries x keys
            dp = dot @ _pad_rows(vf, kt * BK, BK).transpose(-1, -2)
            valid = _key_mask(mask, B, T, cols)[:, None, None, :]
            if causal:
                valid = valid & (cols[None, :] <= rows[:, None])
            p = torch.where(valid, torch.exp2(s * scale2 - ls[..., None]),
                            torch.tensor(0.0))
            if dropout:
                keep = (_keep(B, H, cols, rows, seed).transpose(-1, -2)
                        if swap_hash else _keep(B, H, rows, cols, seed))
                dp = torch.where(keep, dp * inv, torch.tensor(0.0))
            ds = p * (dp - dl[..., None]) * sm_scale
            acc = acc + ds.bfloat16().float() @ ktile
        n = min(BQ, T - q0)
        dq[:, :, q0:q0 + n] = acc[:, :, :n]
    return dq.permute(0, 2, 1, 3).bfloat16()


CASES = [(False, True, True), (True, False, True), (True, True, False),
         (False, False, False)]


def _case(dh, T, causal, use_mask, dropout, seed):
    H = 2 if dh < 256 else 1
    q, k, v, do, mask = _inputs(2, T, H, dh, use_mask, causal, seed)
    kw = dict(mask=mask, causal=causal, dropout=RATE if dropout else 0.0,
              seed=torch.tensor([seed], dtype=torch.int32))
    return q, k, v, do, kw


def _within(got, ref, limit):
    err = (got.float() - ref.float()).abs()
    return bool(torch.isfinite(got.float()).all()) and bool(
        (err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("causal,use_mask,dropout", CASES)
@pytest.mark.parametrize("T", [1, 17, 100, 513])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_forward_tile_order(dh, T, causal, use_mask, dropout):
    from chip_smoke import LSE_TOL, fwd_limit
    q, k, v, _, kw = _case(dh, T, causal, use_mask, dropout, seed=T + dh)
    o, lse = tiles_fwd(q, k, v, kw["mask"], causal, dropout, kw["seed"])
    o_r, lse_r, lim = fwd_limit(FA, q, k, v, kw)
    ok, worst = _within(o, o_r, lim)
    assert ok, worst
    ok, worst = _within(lse, lse_r, LSE_TOL["float32"] * (1 + lse_r.abs()))
    assert ok, worst


@pytest.mark.parametrize("causal,use_mask,dropout", CASES)
@pytest.mark.parametrize("T", [1, 17, 100, 513])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_dkv_tile_order(dh, T, causal, use_mask, dropout):
    from chip_smoke import bwd_limits
    q, k, v, do, kw = _case(dh, T, causal, use_mask, dropout, seed=T + dh)
    o, lse = tiles_fwd(q, k, v, kw["mask"], causal, dropout, kw["seed"])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    refs = (FA.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
            *FA.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))
    _, lim_k, lim_v = bwd_limits(FA, q, k, v, do, lse, delta, refs, kw)
    args = (q, k, v, do, lse, delta, kw["mask"], causal, dropout, kw["seed"])
    dk, dv = tiles_dkv(*args)
    for name, got, ref, lim in (("dK", dk, refs[1], lim_k),
                                ("dV", dv, refs[2], lim_v)):
        ok, worst = _within(got, ref, lim)
        assert ok, (name, worst)
    if dropout and T > 1:
        dk_s, dv_s = tiles_dkv(*args, swap_hash=True)
        assert not (_within(dk_s, refs[1], lim_k)[0]
                    and _within(dv_s, refs[2], lim_v)[0])


@pytest.mark.parametrize("causal,use_mask,dropout", CASES)
@pytest.mark.parametrize("T", [1, 17, 100, 513])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_dq_tile_order(dh, T, causal, use_mask, dropout):
    from chip_smoke import bwd_limits
    q, k, v, do, kw = _case(dh, T, causal, use_mask, dropout, seed=T + dh)
    o, lse = tiles_fwd(q, k, v, kw["mask"], causal, dropout, kw["seed"])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    refs = (FA.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
            *FA.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))
    lim_q = bwd_limits(FA, q, k, v, do, lse, delta, refs, kw)[0]
    args = (q, k, v, do, lse, delta, kw["mask"], causal, dropout, kw["seed"])
    ok, worst = _within(tiles_dq(*args), refs[0], lim_q)
    assert ok, worst
    if dropout and 1 < T < 513:       # the mutants at the shorter lengths
        assert not _within(tiles_dq(*args, swap_hash=True), refs[0],
                           lim_q)[0]
    if causal and 1 < T < 513:
        assert not _within(tiles_dq(*args, early_stop=True), refs[0],
                           lim_q)[0]
