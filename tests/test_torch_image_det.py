"""The port's detection augmenters and ``ImageDetIter``
(``mxnet_tpu_torch/image/detection.py``) against the reference's, on the
CPU, from the same seeded inputs.

Every augmenter draws from Python's ``random`` in the reference's order,
so under one seed both packages pick the same crops, pads and flips:
images and labels compare exactly for the geometric ones (crop, pad,
flip, Lanczos resize), colour ones within rtol 1e-5 (f32 sums in another
order).  ``ImageDetIter`` reads a ``.rec`` written by the reference's
``recordio.pack_img`` with multi-object labels (the ``[A, w, ...]``
header form and plain ``N * 5`` vectors) and yields the same images and
the same -1-padded ``(batch, max_objects, width)`` labels.
"""
import random

import numpy as np
import pytest

import mxnet_tpu_torch as P
from _torch_port import reference as R


def _img(seed, h=36, w=48):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx * f + yy * g) for f, g in
                    rng.uniform(0.05, 0.4, (3, 2))], -1)
    img += rng.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def _label(seed, n=3):
    rng = np.random.RandomState(seed)
    x0, y0 = rng.uniform(0, 0.5, (2, n))
    x1, y1 = x0 + rng.uniform(0.1, 0.5, n), y0 + rng.uniform(0.1, 0.5, n)
    lab = np.stack([rng.randint(0, 4, n), x0, y0, np.minimum(x1, 1),
                    np.minimum(y1, 1)], 1).astype(np.float32)
    lab[-1, 0] = -1                      # a padding row stays padding
    return lab


def _apply(mod, aug, img, lab, seed, as_float=False):
    random.seed(seed)
    np.random.seed(seed)
    if as_float:
        img = img.astype(np.float32)
    x = mod.nd.array(img, dtype=str(img.dtype)) if mod is R else \
        P.nd.array(img, ctx=P.cpu(), dtype=str(img.dtype))
    out, l2 = aug(x, lab.copy())
    return np.asarray(out.asnumpy() if hasattr(out, "asnumpy") else out), l2


def _make(mod, name, *args):
    img_mod = mod.image
    conv = []
    for a in args:
        if isinstance(a, tuple) and a and a[0] == "img":
            conv.append(getattr(img_mod, a[1])(*a[2:]))
        elif isinstance(a, list):
            conv.append([_make(mod, *x) for x in a])
        else:
            conv.append(a)
    return getattr(img_mod, name)(*conv)


DET_AUGS = [
    ("DetHorizontalFlipAug", (0.5,), False),
    ("DetRandomCropAug", (0.1, (0.75, 1.33), (0.3, 1.0), 50), False),
    ("DetRandomPadAug", ((0.75, 1.33), (1.0, 2.0), 50, (127, 127, 127)),
     False),
    ("DetBorrowAug", (("img", "ForceResizeAug", (30, 20), 4),), False),
    ("DetBorrowAug", (("img", "ColorJitterAug", 0.2, 0.2, 0.2),), True),
    ("DetRandomSelectAug", ([("DetHorizontalFlipAug", 1.0),
                             ("DetRandomCropAug", 0.3)], 0.3), False)]


@pytest.mark.parametrize("name,args,colour", DET_AUGS,
                         ids=["flip", "crop", "pad", "borrow_resize",
                              "borrow_colour", "select"])
def test_det_augmenter_equals_reference(name, args, colour):
    ref, port = _make(R, name, *args), _make(P, name, *args)
    for seed in range(4):
        img, lab = _img(seed), _label(seed)
        a, la = _apply(R, ref, img, lab, seed, colour)
        b, lb = _apply(P, port, img, lab, seed, colour)
        assert a.shape == b.shape and a.dtype == b.dtype
        if colour:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(lb, la)


@pytest.mark.parametrize("kw", [
    dict(rand_crop=0.7, rand_pad=0.5, rand_mirror=True, inter_method=4),
    dict(resize=40, rand_crop=1, rand_mirror=True, mean=True, std=True,
         brightness=0.1, contrast=0.1, saturation=0.1, hue=0.05,
         pca_noise=0.05, inter_method=4)], ids=["geometric", "full"])
def test_create_det_augmenter_chain(kw):
    ref = R.image.CreateDetAugmenter((3, 24, 24), **kw)
    port = P.image.CreateDetAugmenter((3, 24, 24), **kw)
    assert [type(a).__name__ for a in port] == \
        [type(a).__name__ for a in ref]
    for seed in range(3):
        outs = []
        for mod, augs in ((R, ref), (P, port)):
            random.seed(seed)
            np.random.seed(seed)
            img = _img(10 + seed)
            x = mod.nd.array(img, dtype="uint8") if mod is R else \
                P.nd.array(img, ctx=P.cpu(), dtype="uint8")
            lab = _label(seed)
            for a in augs:
                x, lab = a(x, lab)
            outs.append((x.asnumpy(), lab))
        (a, la), (b, lb) = outs
        assert b.shape == (24, 24, 3)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(lb, la)


def _det_rec(path, n=7):
    rec, idx = path + ".rec", path + ".idx"
    w = R.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        lab = _label(100 + i, n=1 + i % 4)
        if i % 2:
            flat = np.concatenate([[2, 5], lab.ravel()]).astype(np.float32)
        else:
            flat = lab.ravel()
        header = R.recordio.IRHeader(len(flat), flat, i, 0)
        w.write_idx(i, R.recordio.pack_img(header, _img(i)[:, :, ::-1],
                                           quality=95))
    w.close()
    return rec, idx


@pytest.mark.parametrize("max_objects", [None, 6])
def test_image_det_iter_over_a_reference_rec(tmp_path, max_objects):
    rec, idx = _det_rec(str(tmp_path / "d"))
    batches = []
    for mod in (R, P):
        random.seed(3)
        np.random.seed(3)
        augs = mod.image.CreateDetAugmenter((3, 24, 24), rand_crop=0.5,
                                            rand_mirror=True,
                                            inter_method=4)
        it = mod.image.ImageDetIter(3, (3, 24, 24), path_imgrec=rec,
                                    path_imgidx=idx, shuffle=True,
                                    aug_list=augs, max_objects=max_objects)
        got = []
        with P.cpu():
            for b in it:
                got.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
            got.append(it.provide_label[0].shape)
        batches.append(got)
    ref, port = batches
    assert port[-1] == ref[-1]
    assert len(port) == len(ref) == 4
    for (a, la, pa), (b, lb, pb) in zip(ref[:-1], port[:-1]):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(lb, la)
        assert pa == pb
        assert lb.shape[0] == 3 and lb.shape[2] == 5
