"""``mxnet_tpu_torch/kernels/nms.py``: greedy NMS's keep mask.

On the CPU the wrapper is its plain version, which
``tests/test_torch_vision_ops.py`` holds against the reference's
``_nms_keep``; here the CPU cases check what surrounds the kernel (the
argument checks, an empty batch) and that the plain version keeps the
reference's rule on a hand-made case.  The ``cuda`` cases (skipped
without a card) hold ``csrc/nms.cu`` against the plain version on the
card bit for bit: N = 400 (``nms_topk``) and N = 8732 (SSD300's
anchors), with class ids and across classes, a batch of images, score
ties and invalid rows, and count one launch per call.
"""
import pytest
import torch

from _torch_port import cuda_device, nms_case  # noqa: F401


def test_plain_version_keeps_the_greedy_rule():
    """Box 1 overlaps box 0 (suppressed), box 2 overlaps only box 1
    (kept: box 1 was not kept), box 3 is another class (kept unless
    suppression crosses classes), box 4 is invalid."""
    from mxnet_tpu_torch.kernels.nms import nms_keep
    boxes = torch.tensor([[[0, 0, 1, 1], [0.1, 0, 1.1, 1],
                           [0.7, 0, 1.7, 1], [0, 0, 1, 1],
                           [3, 3, 4, 4]]], dtype=torch.float32)
    valid = torch.tensor([[True, True, True, True, False]])
    ids = torch.tensor([[0, 0, 0, 1, 0]], dtype=torch.float32)
    assert nms_keep(boxes, valid, ids, 0.5).tolist() == \
        [[True, False, True, True, False]]
    assert nms_keep(boxes, valid, None, 0.5).tolist() == \
        [[True, False, True, False, False]]


def test_arguments_are_checked():
    from mxnet_tpu_torch.kernels.nms import nms_keep
    boxes, valid, ids = nms_case(1, 8, 0)
    for args in ((boxes.double(), valid, ids), (boxes[..., :3], valid, ids),
                 (boxes, valid.float(), ids), (boxes, valid, ids[:, :4]),
                 (boxes, valid, ids.long())):
        with pytest.raises(ValueError, match="nms_keep"):
            nms_keep(*args, 0.5)


def test_meta_tensors_give_the_shape():
    from mxnet_tpu_torch.kernels.nms import nms_keep
    keep = nms_keep(torch.empty(2, 7, 4, device="meta"),
                    torch.empty(2, 7, dtype=torch.bool, device="meta"),
                    None, 0.5)
    assert keep.shape == (2, 7) and keep.dtype == torch.bool


@pytest.mark.parametrize("B,N,ok", [(1, 29056 * 64, True),
                                    (1, 29056 * 64 + 1, False),
                                    (65535, 8, True), (65536, 8, False)])
def test_the_size_limit_is_checked(B, N, ok):
    """The sweep's bitmask of one image must fit a block's shared memory
    (29056 words) and the grid takes at most 65535 images: a larger
    batch is refused before any launch (meta tensors, so nothing is
    allocated)."""
    from mxnet_tpu_torch.kernels.nms import nms_keep
    args = (torch.empty(B, N, 4, device="meta"),
            torch.empty(B, N, dtype=torch.bool, device="meta"), None, 0.5)
    if ok:
        assert nms_keep(*args).shape == (B, N)
    else:
        with pytest.raises(ValueError,
                           match="at most 65535 images of 1859584 boxes"):
            nms_keep(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1, 400), (4, 400), (1, 8732), (2, 8732)])
@pytest.mark.parametrize("with_ids", [True, False])
def test_kernel_matches_plain_version(cuda_device, B, N, with_ids):
    from mxnet_tpu_torch.kernels.nms import nms_keep, nms_keep_reference
    boxes, valid, ids = nms_case(B, N, N + B, device=cuda_device)
    if not with_ids:
        ids = None
    for thresh in (0.45, 0.7):
        nms_keep.launches = 0
        got = nms_keep(boxes, valid, ids, thresh)
        torch.cuda.synchronize()
        assert nms_keep.launches == 1
        want = nms_keep_reference(boxes, valid, ids, thresh)
        assert torch.equal(got, want), (thresh, int((got != want).sum()))
        assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.cuda
def test_kernel_on_a_strided_batch(cuda_device):
    """Boxes sliced out of wider rows (not contiguous) and a batch of
    one box: copied for the kernel, the plain version's answer."""
    from mxnet_tpu_torch.kernels.nms import nms_keep, nms_keep_reference
    boxes, valid, ids = nms_case(3, 100, 9, device=cuda_device)
    wide = torch.cat([boxes, boxes], dim=-1)[..., 2:6]
    assert not wide.is_contiguous()
    assert torch.equal(nms_keep(wide, valid, ids, 0.5),
                       nms_keep_reference(wide, valid, ids, 0.5))
    one = nms_keep(boxes[:, :1], valid[:, :1], None, 0.5)
    assert torch.equal(one, valid[:, :1])
