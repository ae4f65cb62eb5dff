"""The port's ``mxnet_tpu_torch.image`` against the reference's
``mxnet_tpu.image``, on the CPU, from the same seeded inputs.

* ``imdecode``/``imread``: the fixtures of ``tests/data/torch_image``
  (JPEGs at q 75 and 95, 4:2:0 and 4:4:4, odd sizes, one greyscale;
  ``make_fixtures.py`` made them), decoded with OpenCV in both: equal.
  The port's native libjpeg copy, its decoder where OpenCV is missing,
  gives the same pixels on them.
* ``imresize``: the port's own resize against OpenCV's (which the
  reference calls), per mode, at up- and down-scales.  Stated limits, in
  uint8 levels: nearest, area and Lanczos-4 exact; linear at most 1
  level on at most 2% of the pixels (OpenCV rounds its vector lanes and
  its scalar tail differently), cubic at most 1 level on at most 10%
  (its vertical pass rounds in float); float images within 1e-3.
* The augmenters, each and as ``CreateAugmenter`` chains, under one
  ``random``/``np.random`` seed: geometric ones exact; colour ones f32
  within rtol 1e-5 (sums in another order); a chain with the default
  cubic resize within 1 level before normalisation (1.1 / std after).
* ``ImageIter`` over a ``.rec`` that the reference's ``recordio.pack_img``
  writes: equal batches (Lanczos resize, exact), shuffled and cropped
  under one seed.
* ``jpeg_color``'s plain version (libjpeg's chroma upsampling and colour
  tables) on libjpeg's own 4:4:4 and greyscale planes (PIL's YCbCr and L
  decodes) gives OpenCV's RGB exactly, its upsampling equals a literal
  transcription of libjpeg's loops, its DCT-scaling stand-in (planes
  box-averaged) lies within the stated limits of libjpeg's 1/2-scale
  decode (``HALF_MEAN`` levels on average, ``HALF_MAX`` at most), and it
  boxes every layout (4:2:2's chroma by d x d / 2, an RGB image by d)
  as a literal loop does.
* ``image_aug``'s plain version against the reference's native loader
  (and the port's copy) on PNG records (lossless), bit for bit: centre
  crops, ``resize``, and an image smaller than the crop.

The ``cuda`` cases hold the kernels to their plain versions, the card's
decode (nvJPEG and ``jpeg_color``) to the fixtures' libjpeg pixels
(mean |difference| at most ``DECODE_MEAN``, any pixel at most
``DECODE_MAX`` levels; at scale 1/2 ``HALF_MEAN``/``HALF_MAX``) and the
card ``ImageRecordIter`` to the plain pipeline.
"""
import os
import random

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as P
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "data", "torch_image")
NAMES = sorted(f[:-4] for f in os.listdir(FIX) if f.endswith(".jpg"))
MEAN, STD = (123.68, 116.78, 103.94), (58.4, 57.12, 57.38)
# the card decode's limits against libjpeg, in full and at 1/2 scale
# (chip_smoke.py DECODE_MEAN, DECODE_MAX, HALF_MEAN, HALF_MAX)
DECODE_MEAN, DECODE_MAX = 0.25, 4
HALF_MEAN, HALF_MAX = 1.0, 24


def _read(name):
    with open(os.path.join(FIX, name + ".jpg"), "rb") as f:
        return f.read()


def _img(seed, h=29, w=41):
    """A smooth uint8 RGB image with an edge and some texture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx * f + yy * g) for f, g in
                    rng.uniform(0.05, 0.4, (3, 2))], -1)
    img[:, w // 3:w // 2] = 30
    img += rng.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def _both(img):
    return (R.nd.array(img, dtype="uint8"),
            P.nd.array(img, ctx=P.cpu(), dtype="uint8"))


# --- decode ----------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_imdecode_equals_reference(name):
    buf = _read(name)
    want = R.image.imdecode(buf).asnumpy()
    got = P.image.imdecode(buf, ctx=P.cpu())
    assert got.context == P.cpu() and got.dtype == np.uint8
    np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(
        P.image.imdecode(buf, to_rgb=False, ctx=P.cpu()).asnumpy(),
        R.image.imdecode(buf, to_rgb=False).asnumpy())
    np.testing.assert_array_equal(
        P.image.imread(os.path.join(FIX, name + ".jpg"),
                       ctx=P.cpu()).asnumpy(),
        R.image.imread(os.path.join(FIX, name + ".jpg")).asnumpy())
    np.testing.assert_array_equal(
        P.image.imdecode(buf, flag=0, ctx=P.cpu()).asnumpy(),
        R.image.imdecode(buf, flag=0).asnumpy())


def test_native_decoder_gives_opencvs_pixels(monkeypatch):
    """Where OpenCV is missing the CPU decode takes the port's native
    libjpeg/libpng copy: on the fixtures (and a PNG) it gives the pixels
    OpenCV gives."""
    if not P.native.available():
        pytest.skip("the native library does not build here: %s"
                    % P.native.build_log()[-200:])
    import cv2
    ok, png = cv2.imencode(".png", _img(3)[:, :, ::-1])
    bufs = [_read(n) for n in NAMES] + [png.tobytes()]
    want = [P.image.imdecode(b, ctx=P.cpu()).asnumpy() for b in bufs]
    monkeypatch.setattr(P.image.image, "_cv2", lambda: None)
    for b, w in zip(bufs, want):
        np.testing.assert_array_equal(
            P.image.imdecode(b, ctx=P.cpu()).asnumpy(), w)
    with pytest.raises(P.MXNetError, match="OpenCV"):
        P.image.imdecode(bufs[0], flag=0, ctx=P.cpu())


def test_card_decode_refuses_png_and_grey_flags():
    import cv2
    ok, png = cv2.imencode(".png", _img(1))
    with pytest.raises(P.MXNetError, match="PNG"):
        P.image.imdecode(png.tobytes(), ctx=P.gpu(0))
    with pytest.raises(P.MXNetError, match="flag=1"):
        P.image.imdecode(_read(NAMES[0]), flag=0, ctx=P.gpu(0))


# --- resize ----------------------------------------------------------------
# (mode, largest difference in levels, largest share of differing pixels)
RESIZE_LIMITS = [(0, 0, 0.0), (1, 1, 0.02), (2, 1, 0.10), (3, 0, 0.0),
                 (4, 0, 0.0), (9, 1, 0.02)]
SIZES = [(71, 29), (20, 15), (82, 58), (20, 14), (41, 29), (13, 9)]


@pytest.mark.parametrize("mode,limit,share", RESIZE_LIMITS,
                         ids=["interp%d" % m for m, _, _ in RESIZE_LIMITS])
def test_imresize_against_opencv(mode, limit, share):
    img = _img(mode)
    ra, pa = _both(img)
    for w, h in SIZES:
        want = R.image.imresize(ra, w, h, mode).asnumpy().astype(np.int64)
        got = P.image.imresize(pa, w, h, mode)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        d = np.abs(got.asnumpy().astype(np.int64) - want)
        assert d.max() <= limit, (w, h, d.max())
        assert (d > 0).mean() <= share, (w, h, (d > 0).mean())
    f = img.astype(np.float32)
    want = R.image.imresize(R.nd.array(f), 53, 23, mode).asnumpy()
    got = P.image.imresize(P.nd.array(f, ctx=P.cpu()), 53, 23,
                           mode).asnumpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_interp_draws_like_the_reference():
    """``interp=10`` draws one of the five modes from ``random`` as the
    reference draws it; 9 and unknown codes are linear."""
    for seed in range(5):
        random.seed(seed)
        a = [R.image.image._interp(10) for _ in range(6)]
        random.seed(seed)
        b = [P.image.image._interp(10) for _ in range(6)]
        assert a == b
    assert P.image.image._interp(9) == P.image.image._interp(7) == 1


def test_resize_short_and_crops():
    ra, pa = _both(_img(5, 33, 47))
    for size in (16, 40):
        np.testing.assert_array_equal(
            P.image.resize_short(pa, size, 4).asnumpy(),
            R.image.resize_short(ra, size, 4).asnumpy())
    np.testing.assert_array_equal(
        P.image.fixed_crop(pa, 3, 4, 20, 10, (8, 6), 4).asnumpy(),
        R.image.fixed_crop(ra, 3, 4, 20, 10, (8, 6), 4).asnumpy())
    a, ca = R.image.center_crop(ra, (30, 20), 4)
    b, cb = P.image.center_crop(pa, (30, 20), 4)
    assert ca == cb
    np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    for fn, args in ((R.image.random_crop, ((25, 50), 4)),
                     (R.image.random_size_crop, ((12, 12), (0.1, 1.0),
                                                 (0.75, 1.33), 4))):
        pfn = getattr(P.image, fn.__name__)
        random.seed(7)
        a, ca = fn(ra, *args)
        random.seed(7)
        b, cb = pfn(pa, *args)
        assert ca == cb
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())


# --- augmenters ------------------------------------------------------------
def _run(aug, x, seed):
    random.seed(seed)
    np.random.seed(seed)
    out = aug(x)
    return out.asnumpy()


AUGS = [("HorizontalFlipAug", (0.5,), 0), ("CastAug", (), 0),
        ("ColorNormalizeAug", (MEAN, STD), 1e-6),
        ("RandomCropAug", ((20, 16), 4), 0),
        ("CenterCropAug", ((20, 16), 4), 0),
        ("ResizeAug", (24, 4), 0), ("ForceResizeAug", ((30, 18), 4), 0),
        ("RandomSizedCropAug", ((16, 16), (0.1, 1.0), (0.75, 1.33), 4), 0),
        ("BrightnessJitterAug", (0.3,), 1e-5),
        ("ContrastJitterAug", (0.3,), 1e-5),
        ("SaturationJitterAug", (0.3,), 1e-5),
        ("HueJitterAug", (0.2,), 1e-5),
        ("ColorJitterAug", (0.2, 0.2, 0.2), 1e-5),
        ("LightingAug", (0.1, np.array([55.46, 4.794, 1.148]),
                         np.array([[-0.5675, 0.7192, 0.4009],
                                   [-0.5808, -0.0045, -0.8140],
                                   [-0.5836, -0.6948, 0.4203]])), 1e-5)]


@pytest.mark.parametrize("name,args,rtol", AUGS, ids=[a[0] for a in AUGS])
def test_augmenter_equals_reference(name, args, rtol):
    img = _img(11)
    geometric = rtol == 0
    ra, pa = _both(img) if geometric else (
        R.nd.array(img.astype(np.float32)),
        P.nd.array(img.astype(np.float32), ctx=P.cpu()))
    ref, port = getattr(R.image, name)(*args), getattr(P.image, name)(*args)
    assert port.dumps() == ref.dumps()
    for seed in range(3):
        want = _run(ref, ra, seed)
        got = _run(port, pa, seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        if geometric:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4)


def test_sequential_and_random_order():
    img = _img(12).astype(np.float32)
    ra, pa = R.nd.array(img), P.nd.array(img, ctx=P.cpu())
    for cls in ("SequentialAug", "RandomOrderAug"):
        ref = getattr(R.image, cls)([R.image.BrightnessJitterAug(0.2),
                                     R.image.HorizontalFlipAug(0.5),
                                     R.image.ContrastJitterAug(0.2)])
        port = getattr(P.image, cls)([P.image.BrightnessJitterAug(0.2),
                                      P.image.HorizontalFlipAug(0.5),
                                      P.image.ContrastJitterAug(0.2)])
        for seed in range(3):
            np.testing.assert_allclose(_run(port, pa, seed),
                                       _run(ref, ra, seed), rtol=1e-5,
                                       atol=1e-4)


CHAINS = [dict(resize=24, rand_crop=True, rand_mirror=True, mean=True,
               std=True, brightness=0.2, contrast=0.2, saturation=0.2,
               hue=0.1, pca_noise=0.1, inter_method=4),
          dict(rand_crop=True, rand_resize=True, inter_method=4,
               mean=np.array(MEAN), std=np.array(STD)),
          dict(resize=20, inter_method=4)]


@pytest.mark.parametrize("kw", CHAINS, ids=["full", "sized", "centre"])
def test_create_augmenter_chain_under_one_seed(kw):
    img = _img(13, 37, 53)
    ra, pa = _both(img)
    ref = R.image.CreateAugmenter((3, 20, 20), **kw)
    port = P.image.CreateAugmenter((3, 20, 20), **kw)
    assert [type(a).__name__ for a in port] == \
        [type(a).__name__ for a in ref]
    for seed in range(3):
        outs = []
        for augs, x in ((ref, ra), (port, pa)):
            random.seed(seed)
            np.random.seed(seed)
            for a in augs:
                x = a(x)
            outs.append(x.asnumpy())
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-4)


def test_chain_with_cubic_resize_within_a_level():
    """The default ``inter_method=2`` (cubic) resize differs from
    OpenCV's by at most 1 level, so the normalised chain by 1.1 / std."""
    img = _img(14, 37, 53)
    ra, pa = _both(img)
    kw = dict(resize=24, rand_crop=True, rand_mirror=True, mean=True,
              std=True)
    outs = []
    for mod, x in ((R.image, ra), (P.image, pa)):
        random.seed(0)
        for a in mod.CreateAugmenter((3, 20, 20), **kw):
            x = a(x)
        outs.append(x.asnumpy())
    assert np.abs(outs[1] - outs[0]).max() <= 1.1 / min(58.395, 57.12,
                                                        57.375)


def _pack(mod, path, imgs, fmt=".jpg", labels=None):
    rec, idx = path + ".rec", path + ".idx"
    w = mod.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i, img in enumerate(imgs):
        label = float(i % 5) if labels is None else labels[i]
        w.write_idx(i, R.recordio.pack_img(
            R.recordio.IRHeader(0, label, i, 0), img[:, :, ::-1],
            quality=95, img_fmt=fmt))
    w.close()
    return rec, idx


@pytest.mark.parametrize("shuffle", [False, True])
def test_image_iter_over_a_reference_rec(tmp_path, shuffle):
    imgs = [_img(20 + i, 30 + i, 44 - i) for i in range(7)]
    rec, idx = _pack(R, str(tmp_path / "a"), imgs)
    kw = dict(batch_size=3, data_shape=(3, 16, 16), path_imgrec=rec,
              path_imgidx=idx, shuffle=shuffle, rand_crop=True,
              rand_mirror=True, resize=20, inter_method=4)
    batches = []
    for mod in (R, P):
        random.seed(1)
        np.random.seed(1)
        it = mod.image.ImageIter(**kw)
        got = []
        with P.cpu():
            for b in it:
                got.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
        batches.append(got)
    assert len(batches[0]) == len(batches[1]) == 3
    for (a, la, pa_), (b, lb, pb) in zip(*batches):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(lb, la)
        assert pa_ == pb
    it = P.image.ImageIter(**kw)
    assert it.provide_data[0].shape == (3, 3, 16, 16)
    assert it.provide_label[0].shape == (3,)


def _pil_planes(name):
    """libjpeg's Y, Cb, Cr of a 4:4:4 fixture (PIL decodes to YCbCr with
    no upsampling at 4:4:4), or the Y of a greyscale one, as jpeg_color's
    scratch layout: (planes, (h, w), layout)."""
    from PIL import Image
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    im = Image.open(os.path.join(FIX, name + ".jpg"))
    if im.mode == "L":
        y = np.asarray(im)
        return torch.from_numpy(y.ravel().copy()), y.shape, JC.GREY
    im.draft("YCbCr", im.size)
    ycc = np.asarray(im)
    return torch.from_numpy(np.concatenate(
        [ycc[..., c].ravel() for c in range(3)]).copy()), ycc.shape[:2], \
        JC.YUV444


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if "_444_" in n or n.startswith("grey")])
def test_jpeg_color_equals_libjpeg_and_scales_within_limits(name):
    """jpeg_color's plain version on libjpeg's own planes (PIL) gives
    OpenCV's (libjpeg's) RGB exactly; at scale 1/2 its plane box averages
    stand in for libjpeg's reduced IDCT within HALF_MEAN / HALF_MAX."""
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    ref = np.load(os.path.join(FIX, "pixels.npz"))
    planes, (h, w), kind = _pil_planes(name)
    for d, key in ((1, "full_"), (2, "half_")):
        table, n = JC.color_table([(kind, h, w, d)])
        assert n == planes.numel()
        oh, ow = JC.out_size(h, w, d)
        got = JC.jpeg_color(planes, table, torch.zeros(
            oh * ow * 3, dtype=torch.uint8)).reshape(oh, ow, 3).numpy()
        diff = np.abs(got.astype(np.int64) - ref[key + name])
        if d == 1:
            assert diff.max() == 0
        else:
            assert diff.mean() <= HALF_MEAN and diff.max() <= HALF_MAX


def test_jpeg_color_upsampling_follows_libjpeg_loops():
    """The plain version's 4:2:0 and 4:2:2 upsampling against a literal
    transcription of libjpeg's h2v2/h2v1_fancy_upsample loops, on odd
    plane sizes."""
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    rng = np.random.RandomState(0)
    for ch, cw in ((5, 7), (1, 1), (3, 1), (1, 4)):
        c = rng.randint(0, 256, (ch, cw))
        want = np.zeros((2 * ch, 2 * cw), np.int64)
        for r in range(ch):
            for v, nb in ((0, max(r - 1, 0)), (1, min(r + 1, ch - 1))):
                s = c[r] * 3 + c[nb]
                row = want[2 * r + v]
                row[0] = (s[0] * 4 + 8) >> 4
                row[1] = ((s[0] * 3 + s[1] + 7) >> 4) if cw > 1 \
                    else (s[0] * 4 + 7) >> 4
                for i in range(1, cw):
                    row[2 * i] = (s[i] * 3 + s[i - 1] + 8) >> 4
                    row[2 * i + 1] = ((s[i] * 3 + s[i + 1] + 7) >> 4) \
                        if i < cw - 1 else (s[i] * 4 + 7) >> 4
        got = JC._up_h2v2(torch.from_numpy(c).int()).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.zeros((ch, 2 * cw), np.int64)
        for i in range(cw):
            v = c[:, i] * 3
            want[:, 2 * i] = c[:, 0] if i == 0 else \
                (v + c[:, i - 1] + 1) >> 2
            want[:, 2 * i + 1] = c[:, i] if i == cw - 1 else \
                (v + c[:, i + 1] + 2) >> 2
        np.testing.assert_array_equal(
            JC._up_h2v1(torch.from_numpy(c).int()).numpy(), want)


def _box_loop(p, fy, fx):
    """Block means of an (h, w[, c]) array, clipped at its edges and
    rounded half up, as a literal loop."""
    h, w = p.shape[:2]
    out = np.zeros((-(-h // fy), -(-w // fx)) + p.shape[2:], np.int64)
    for r in range(out.shape[0]):
        for c in range(out.shape[1]):
            blk = p[r * fy:(r + 1) * fy, c * fx:(c + 1) * fx].astype(np.int64)
            n = blk.shape[0] * blk.shape[1]
            out[r, c] = (blk.sum((0, 1)) + n // 2) // n
    return out


@pytest.mark.parametrize("d", [1, 2, 4])
def test_jpeg_color_scales_every_layout_like_a_loop(d):
    """The plain version at scale 1/d, on random planes of odd sizes, for
    each layout: Y and 4:4:4 chroma boxed by d, 4:2:2 chroma by d x d / 2,
    4:2:0 chroma by d / 2 (then libjpeg's colour tables), greyscale
    replicated, an RGB image boxed by d; against literal loops."""
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    rng = np.random.RandomState(d)
    h, w = 13, 19
    images, planes, want = [], [], []
    for kind in (JC.GREY, JC.YUV444, JC.YUV422, JC.YUV420, JC.RGB):
        if kind == JC.RGB:
            rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            planes.append(rgb.ravel())
            want.append(_box_loop(rgb, d, d))
            images.append((kind, h, w, d))
            continue
        ch, cw = JC._CHROMA[kind](h, w)
        y = rng.randint(0, 256, (h, w)).astype(np.uint8)
        cb, cr = (rng.randint(0, 256, (ch, cw)).astype(np.uint8)
                  for _ in range(2))
        planes += [y.ravel(), cb.ravel(), cr.ravel()]
        Y = _box_loop(y, d, d)
        if kind == JC.GREY:
            want.append(np.stack([Y] * 3, -1))
        else:
            if d == 1:
                up = {JC.YUV444: lambda c: c.astype(np.int64),
                      JC.YUV422: lambda c: JC._up_h2v1(
                          torch.from_numpy(c).int()).numpy(),
                      JC.YUV420: lambda c: JC._up_h2v2(
                          torch.from_numpy(c).int()).numpy()}[kind]
                Cb, Cr = up(cb)[:h, :w] - 128, up(cr)[:h, :w] - 128
            else:
                fy, fx = {JC.YUV444: (d, d), JC.YUV422: (d, d // 2),
                          JC.YUV420: (d // 2, d // 2)}[kind]
                Cb, Cr = _box_loop(cb, fy, fx) - 128, \
                    _box_loop(cr, fy, fx) - 128
            want.append(np.clip(np.stack([
                Y + ((91881 * Cr + 32768) >> 16),
                Y + ((-22554 * Cb + 32768 - 46802 * Cr) >> 16),
                Y + ((116130 * Cb + 32768) >> 16)], -1), 0, 255))
        images.append((kind, h, w, d))
    table, n = JC.color_table(images)
    planes = torch.from_numpy(np.concatenate(planes))
    assert n == planes.numel()
    want = np.concatenate([x.ravel() for x in want])
    got = JC.jpeg_color(planes, table, torch.zeros(want.size,
                                                   dtype=torch.uint8))
    np.testing.assert_array_equal(got.numpy(), want)


# --- image_aug's plain version against the native loader -------------------
NATIVE_CASES = [dict(), dict(resize=28), dict(resize=18),
                dict(layout="NHWC", resize=24)]


@pytest.mark.parametrize("kw", NATIVE_CASES,
                         ids=["centre", "resize28", "resize18", "nhwc"])
def test_image_aug_plain_equals_native_loader_on_png(tmp_path, kw):
    """PNG records (lossless) through the reference's native loader (and
    the port's copy) and through the plain version of ``image_aug`` on
    the decoded images: bit for bit, with centre crops (the native
    loader's random crops follow its per-thread streams).  Image 3 is
    smaller than the crop, so it takes the resize up."""
    from mxnet_tpu import native as RN
    from mxnet_tpu_torch.kernels import image_aug as IA
    if not RN.available():
        pytest.skip("the reference's native library is not built here")
    imgs = [_img(40 + i, 24 + 3 * i, 40 - 2 * i) for i in range(6)]
    imgs[3] = _img(43, 15, 19)
    rec, idx = _pack(R, str(tmp_path / "p"), imgs, fmt=".png")
    layout = kw.get("layout", "NCHW")
    shape = (3, 20, 20)
    common = dict(mean=MEAN, std=STD, layout=layout, resize=kw.get(
        "resize", 0))
    loader = RN.ImageRecordLoader(rec, idx, 6, shape, num_threads=2,
                                  **common)
    want = loader.next()[0].copy()          # a view into the loader's ring
    if P.native.available():
        loader = P.native.ImageRecordLoader(rec, idx, 6, shape,
                                            num_threads=2, **common)
        np.testing.assert_array_equal(loader.next()[0], want)
    decoded = [P.image.imdecode(_png_bytes(rec, idx, i), ctx=P.cpu())._data
               for i in range(6)]
    buf = torch.cat([d.reshape(-1) for d in decoded])
    table = IA.aug_table([tuple(d.shape[:2]) for d in decoded], shape,
                         np.random.RandomState(0), resize=common["resize"])
    got = IA.image_aug(buf, table, shape, MEAN, STD, layout=layout)
    np.testing.assert_array_equal(got.numpy(), want)


def _png_bytes(rec, idx, i):
    r = P.recordio.MXIndexedRecordIO(idx, rec, "r")
    blob = P.recordio.unpack(r.read_idx(i))[1]
    r.close()
    return blob


def test_aug_table_draws_like_the_python_loader():
    """Crop origins and flips: per image y, then x, then the flip, from
    one RandomState, as the reference's Python loader draws them; the
    decode's DCT factor is the native PickScaleDenom."""
    from mxnet_tpu_torch.kernels import image_aug as IA
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    sizes = [(480, 640), (640, 480), (100, 90), (481, 643)]
    t = IA.aug_table(sizes, (3, 224, 224), np.random.RandomState(3),
                     rand_crop=True, rand_mirror=True)
    rng = np.random.RandomState(3)
    F = {n: i for i, n in enumerate(IA.FIELDS)}
    for row, (h, w) in zip(t.tolist(), sizes):
        assert (row[F["h"]], row[F["w"]]) == (h, w)
        uh, uw = row[F["uh"]], row[F["uw"]]
        assert uh >= 224 and uw >= 224
        assert row[F["y0"]] == rng.randint(0, uh - 224 + 1)
        assert row[F["x0"]] == rng.randint(0, uw - 224 + 1)
        assert row[F["mirror"]] == rng.randint(2)
    assert [JC.pick_denom(480, 640, 224), JC.pick_denom(480, 640, 256),
            JC.pick_denom(1800, 2000, 224), JC.pick_denom(5, 5, 0)] == \
        [2, 1, 8, 1]
    assert [JC.min_short((3, 224, 224), True, 0, True),
            JC.min_short((3, 224, 224), True, 256, True),
            JC.min_short((3, 224, 224), False, 0, True),
            JC.min_short((3, 224, 224), True, 0, False)] == [224, 256, 0, 0]


# --- on the card -----------------------------------------------------------
def _decoded_batch(dev, shape, rand_crop=False, resize=0, dct_scale=True,
                   n=12, seed=0):
    """n seeded images encoded by nvJPEG on the card, decoded back as
    ImageRecordIter's card route decodes them (DCT-scaled on its
    random-crop path): the flat buffer and the sizes."""
    from mxnet_tpu_torch.image import _nvjpeg
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    codec = _nvjpeg.decoder(dev)
    blobs = [codec.encode(torch.from_numpy(
        _img(seed + i, 200 + 9 * i, 260 - 7 * i)).to(dev), 95, 420)
        for i in range(n)]
    blobs.append(_read(NAMES[-1]))            # smaller than the crop
    infos = [codec.info(b) for b in blobs]
    keep = JC.min_short(shape, rand_crop, resize, dct_scale)
    return codec.decode_batch(blobs, infos, [
        JC.pick_denom(inf[0], inf[1], keep) for inf in infos])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(rand_crop=True, rand_mirror=True),
                                dict(), dict(resize=256),
                                dict(rand_crop=True, dct_scale=False)],
                         ids=["random", "centre", "resize", "nodct"])
def test_image_aug_kernel_bit_for_bit(cuda_device, kw):
    from mxnet_tpu_torch.kernels import image_aug as IA
    kw = dict(kw)
    dct_scale = kw.pop("dct_scale", True)
    buf, sizes = _decoded_batch(cuda_device, (3, 96, 96),
                                kw.get("rand_crop", False),
                                kw.get("resize", 0), dct_scale)
    table = IA.aug_table(sizes, (3, 96, 96), np.random.RandomState(0),
                         **kw).to(cuda_device)
    for layout in ("NCHW", "NHWC"):
        n0 = IA.image_aug.launches
        got = IA.image_aug(buf, table, (3, 96, 96), MEAN, STD,
                           layout=layout)
        torch.cuda.synchronize()
        assert IA.image_aug.launches == n0 + 1
        want = IA.image_aug_reference(buf, table, (3, 96, 96), MEAN, STD,
                                      layout=layout)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_nvjpeg_decode_within_the_stated_tolerance(cuda_device, name):
    """The card's decode (nvJPEG, then jpeg_color) against libjpeg's
    pixels, in full and at scale 1/2; jpeg_color bit for bit with its
    plain version on the same planes."""
    from mxnet_tpu_torch.image import _nvjpeg
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    ref = np.load(os.path.join(FIX, "pixels.npz"))
    got = P.image.imdecode(_read(name), ctx=P.gpu(0))
    assert got.context == P.gpu(0) and got.shape == ref["full_" + name].shape
    d = np.abs(got.asnumpy().astype(np.int64) - ref["full_" + name])
    assert d.mean() <= DECODE_MEAN and d.max() <= DECODE_MAX
    codec = _nvjpeg.decoder(cuda_device)
    buf, sizes = codec.decode_batch([_read(name)], denoms=[2])
    half = buf.view(sizes[0][0], sizes[0][1], 3)
    d = np.abs(half.cpu().numpy().astype(np.int64) - ref["half_" + name])
    assert d.mean() <= HALF_MEAN and d.max() <= HALF_MAX
    inf = codec.info(_read(name))
    for denom in (1, 2):
        scratch, table = codec.decode_planes([_read(name)], [inf],
                                             denoms=[denom])
        oh, ow = JC.out_size(inf[0], inf[1], denom)
        table = table.to(cuda_device)
        a = JC.jpeg_color(scratch, table, torch.zeros(
            oh * ow * 3, dtype=torch.uint8, device=cuda_device))
        b = JC.jpeg_color_reference(scratch, table, torch.zeros(
            oh * ow * 3, dtype=torch.uint8, device=cuda_device))
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_image_record_iter_equals_plain_pipeline(cuda_device,
                                                      tmp_path):
    """ImageRecordIter on the card against the same records decoded by
    nvJPEG and run through image_aug's plain version with the same
    seeded table: bit for bit; a PNG record raises."""
    from mxnet_tpu_torch.image import _nvjpeg
    from mxnet_tpu_torch.kernels import image_aug as IA
    from mxnet_tpu_torch.kernels import jpeg_color as JC
    codec = _nvjpeg.decoder(cuda_device)
    rec, idx = str(tmp_path / "c.rec"), str(tmp_path / "c.idx")
    w = P.recordio.MXIndexedRecordIO(idx, rec, "w")
    blobs = []
    for i in range(10):
        blobs.append(codec.encode(torch.from_numpy(
            _img(60 + i, 240, 300)).to(cuda_device), 95, 420))
        w.write_idx(i, P.recordio.pack(P.recordio.IRHeader(0, float(i), i,
                                                           0), blobs[-1]))
    w.close()
    it = P.io.ImageRecordIter(rec, idx, data_shape=(3, 112, 112),
                              batch_size=4, rand_crop=True, rand_mirror=True,
                              mean_r=MEAN[0], mean_g=MEAN[1], mean_b=MEAN[2],
                              std_r=STD[0], std_g=STD[1], std_b=STD[2],
                              seed=5, ctx=P.gpu(0))
    rng = np.random.RandomState(5)
    order = np.arange(10)
    seen = 0
    for b in it:
        keys = [order[(seen + i) % 10] for i in range(4)]
        part = [blobs[k] for k in keys]
        infos = [codec.info(x) for x in part]
        denoms = [JC.pick_denom(inf[0], inf[1], 112) for inf in infos]
        buf, sizes = codec.decode_batch(part, infos, denoms)
        assert sizes == [(120, 150)] * 4          # scaled by jpeg_color
        table = IA.aug_table(sizes, (3, 112, 112), rng, rand_crop=True,
                             rand_mirror=True).to(cuda_device)
        want = IA.image_aug_reference(buf, table, (3, 112, 112), MEAN, STD)
        assert torch.equal(b.data[0]._data, want)
        np.testing.assert_array_equal(b.label[0].asnumpy(),
                                      np.asarray(keys, np.float32))
        seen += 4
    assert seen == 12 and b.pad == 2
    import cv2
    ok, png = cv2.imencode(".png", _img(1))
    w = P.recordio.MXIndexedRecordIO(idx, rec, "w")
    w.write_idx(0, P.recordio.pack(P.recordio.IRHeader(0, 0.0, 0, 0),
                                   png.tobytes()))
    w.close()
    with pytest.raises(P.MXNetError, match="PNG"):
        P.io.ImageRecordIter(rec, idx, data_shape=(3, 8, 8), batch_size=1,
                             ctx=P.gpu(0)).next()
