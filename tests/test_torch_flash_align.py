"""``flash_attention`` on bf16 views that do not start 16-byte aligned.

The tensor-core kernels copy 16-byte pieces, so the low-level wrappers
(``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) refuse such a view;
the reference ``flash_attention`` computes it.  ``flash_attention``
copies a misaligned q, k, v (and, in the backward, dO) to an aligned
tensor first, inside autograd, so the gradients reach the view.  The
same call on a view and on a copy of it runs the same kernels on the
same values: outputs and gradients agree bit for bit."""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)


def _views(dev, B=2, T=100, H=3, dh=64, seed=0):
    """q, k, v as bf16 views one element (2 bytes) into larger buffers,
    and aligned copies of them; dO likewise."""
    rng = np.random.RandomState(seed)
    views, copies = [], []
    for _ in range(4):
        x = torch.from_numpy(rng.randn(B, T, H, dh).astype(np.float32)) \
            .to(dev, torch.bfloat16)
        buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=dev)
        buf[1:] = x.reshape(-1)
        views.append(buf[1:].view(x.shape))
        copies.append(x)
    return views, copies


def _run(q, k, v, g, mask, causal, dropout):
    from mxnet_tpu_torch.kernels.flash_attention import flash_attention
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    o = flash_attention(q, k, v, mask=mask, causal=causal, dropout=dropout,
                        dropout_seed=7)
    o.backward(g)
    return o.detach(), q.grad, k.grad, v.grad


def test_aligned_copies_only_misaligned_bf16():
    """``_aligned`` copies a bf16 view that starts 2 bytes off to an
    aligned tensor of the same values, and passes aligned bf16 and f32
    tensors through as they are."""
    from mxnet_tpu_torch.kernels.flash_attention import _aligned
    views, copies = _views("cpu", T=8)
    assert views[0].data_ptr() % 16 != 0
    got = _aligned(views[0])
    assert got.data_ptr() % 16 == 0 and torch.equal(got, copies[0])
    assert _aligned(copies[0]) is copies[0]
    f = copies[0].float()
    assert _aligned(f) is f


@pytest.mark.parametrize("causal,dropout", [(False, 0.1), (True, 0.0)])
def test_offset_view_accepted(causal, dropout):
    """On the CPU (the plain versions) an offset bf16 view gives what its
    copy gives, forward and backward."""
    views, copies = _views("cpu", T=24, seed=1)
    mask = torch.from_numpy(np.random.RandomState(2).rand(2, 24) > 0.2)
    mask[:, 0] = True
    got = _run(*views[:3], views[3], mask, causal, dropout)
    want = _run(*copies[:3], copies[3], mask, causal, dropout)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,use_mask,dropout", [
    (False, True, 0.1), (True, False, 0.1), (True, True, 0.0)])
def test_cuda_offset_view_matches_copy(cuda_device, causal,  # noqa: F811
                                       use_mask, dropout):
    """On the card: the forward and backward on offset bf16 views (q, k,
    v and dO all 2 bytes off) launch the kernels and agree bit for bit
    with the same call on aligned copies."""
    from mxnet_tpu_torch.kernels import flash_attention as FA
    views, copies = _views(cuda_device, seed=3)
    mask = None
    if use_mask:
        m = np.random.RandomState(4).rand(2, 100) > 0.2
        m[:, 0] = True
        mask = torch.from_numpy(m).to(cuda_device)
    before = FA.flash_bwd_dq.launches
    got = _run(*views[:3], views[3], mask, causal, dropout)
    want = _run(*copies[:3], copies[3], mask, causal, dropout)
    torch.cuda.synchronize()
    assert FA.flash_bwd_dq.launches == before + 2
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a.float()).all())
        assert torch.equal(a, b)
