"""Make the image fixtures of the port's image tests (run from the
repository root: ``python tests/data/torch_image/make_fixtures.py``).

Seeded synthetic images (smooth colour fields with edges and mild
texture, not white noise) at odd sizes, encoded with OpenCV as JPEGs at
quality 75 and 95, with 4:2:0 and 4:4:4 chroma, plus one greyscale JPEG.
``pixels.npz`` holds each file's pixels as the reference decodes them
(``cv2.imdecode``, RGB): ``full_<name>`` in full and ``half_<name>``
DCT-halved (``cv2.IMREAD_REDUCED_COLOR_2``, libjpeg's scale 1/2).
"""
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# (name, height, width, quality, chroma)
CASES = [("q95_420_37x53", 37, 53, 95, "420"),
         ("q75_420_61x45", 61, 45, 75, "420"),
         ("q95_444_50x77", 50, 77, 95, "444"),
         ("q75_444_33x129", 33, 129, 75, "444"),
         ("q95_420_96x80", 96, 80, 95, "420")]
GREY = ("grey_q90_43x58", 43, 58, 90)


def field(h, w, seed):
    """An RGB uint8 image: smooth waves, a bright disc, a dark bar and
    mild texture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        fy, fx, ph = rng.uniform(0.05, 0.3, 2).tolist() + [rng.uniform(0, 6)]
        img[..., c] = 128 + 80 * np.sin(xx * fx + ph) * np.cos(yy * fy)
    cy, cx, r = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w, \
        min(h, w) / 4
    img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(180, 250, 3)
    x0 = rng.randint(0, w // 2)
    img[:, x0:x0 + max(2, w // 10)] = rng.uniform(0, 60, 3)
    img += rng.randn(h, w, 3) * 5
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    sampling = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
    pixels = {}
    for i, (name, h, w, q, chroma) in enumerate(CASES):
        rgb = field(h, w, i)
        ok, buf = cv2.imencode(".jpg", rgb[:, :, ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, q,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling[chroma]])
        assert ok
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(buf.tobytes())
    name, h, w, q = GREY
    grey = cv2.cvtColor(field(h, w, 99), cv2.COLOR_RGB2GRAY)
    ok, buf = cv2.imencode(".jpg", grey, [cv2.IMWRITE_JPEG_QUALITY, q])
    assert ok
    with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
        f.write(buf.tobytes())
    for name in [c[0] for c in CASES] + [GREY[0]]:
        data = np.fromfile(os.path.join(HERE, name + ".jpg"), np.uint8)
        pixels["full_" + name] = cv2.imdecode(data, 1)[:, :, ::-1]
        pixels["half_" + name] = cv2.imdecode(
            data, cv2.IMREAD_REDUCED_COLOR_2)[:, :, ::-1]
    np.savez_compressed(os.path.join(HERE, "pixels.npz"), **pixels)


if __name__ == "__main__":
    main()
