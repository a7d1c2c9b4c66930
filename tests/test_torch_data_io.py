"""The port's image files and image ops (dmayolo_tpu_torch/data/imageio.py,
cvops.py, the host letterbox) against cv2 and the JAX package, on the CPU.

Tolerances, and why:
- JPEG decode on the same libjpeg as cv2's: bit-exact.  PNG: bit-exact
  both ways (lossless), for 8-bit RGB, grey, RGBA and 16-bit files.
- `resize` linear follows cv2's 11-bit fixed-point vector route; cv2
  finishes each row's last values by its scalar route, which rounds once
  at the end: within 1 level on at most 1% of the values.  `resize` area averages in float where
  cv2 has its own tables: within 1 level on at most 0.1%.
- `warp_affine` / `warp_perspective` interpolate on float coordinates and
  weights; cv2 rounds its own way: within 1 level on at most 0.1%.
- BGR->HSV, box blur and median blur: bit-exact.  Grey: cv2's 14-bit
  weights, which its vector route rounds its own way: within 1 level on
  at most 0.5%.  HSV->BGR follows
  cv2's scalar route bit-exactly; cv2 converts the bulk of each row by a
  vector route that differs from its scalar one by 1: within 1 level.
  Gaussian blur (float, where cv2 has a fixed-point kernel): within 1.
- The raster: circles and rectangles bit-exact; polygons and ellipses may
  differ from cv2's fill at boundary pixels (cv2 fills on vertices kept
  to 1/65536 px, ours on integer vertices): at most 20% of the painted
  pixels of a small ellipse, 2% of the large polygon's; thick lines (the
  generator's roads), 35% of a band 2-5 px wide, where most pixels are on
  its boundary, 5% of a 20 px band.
- The host letterbox: ratio, padding and shape equal to the JAX one's,
  pixels within 1 (its resize as above).
"""
import cv2
import numpy as np
import pytest

from dmayolo_tpu.data.augment import letterbox as jax_letterbox
from dmayolo_tpu_torch.data import cvops, imageio
from dmayolo_tpu_torch.data.letterbox import letterbox_host


def diff(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return d.max(), (d > 0).mean()


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8), (9, 9), 3)
    return {"noise": noise, "smooth": smooth}


@pytest.fixture(scope="module")
def files(tmp_path_factory, images):
    d = tmp_path_factory.mktemp("imgio")
    rng = np.random.default_rng(1)
    out = {}
    for q in (85, 95):
        out[f"q{q}"] = d / f"q{q}.jpg"
        cv2.imwrite(str(out[f"q{q}"]), images["smooth"], [cv2.IMWRITE_JPEG_QUALITY, q])
    cases = {"rgb": images["noise"], "grey": rng.integers(0, 256, (40, 50), dtype=np.uint8),
             "rgba": rng.integers(0, 256, (40, 50, 4), dtype=np.uint8),
             "u16": rng.integers(0, 65536, (40, 50, 3), dtype=np.uint16)}
    for k, v in cases.items():
        out[k] = d / f"{k}.png"
        cv2.imwrite(str(out[k]), v)
    return out


@pytest.mark.parametrize("name", ["q85", "q95", "rgb", "grey", "rgba", "u16"])
def test_imread_matches_cv2(files, name):
    ours = imageio.imread(files[name])
    np.testing.assert_array_equal(ours, cv2.imread(str(files[name])))
    assert imageio.image_shape(files[name]) == ours.shape[:2]


def test_imwrite_png_and_jpeg(tmp_path, images):
    img = images["noise"]
    imageio.imwrite(tmp_path / "a.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")), img)
    imageio.imwrite(tmp_path / "a.jpg", img, quality=85)
    cv2.imwrite(str(tmp_path / "b.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 85])
    # the same libjpeg at the same settings: the same decoded pixels
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.jpg"),
                                  cv2.imread(str(tmp_path / "b.jpg")))


def test_unsupported_and_corrupt(tmp_path, images):
    # BMP, TIFF and webp read and write (tests/test_torch_image_formats.py):
    # webp through cv2's decoder, to cv2's pixels; a GIF raises, naming
    # itself, at both ends, and so does a corrupt JPEG
    cv2.imwrite(str(tmp_path / "a.webp"), images["noise"])
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.webp"),
                                  cv2.imread(str(tmp_path / "a.webp")))
    (tmp_path / "a.gif").write_bytes(b"GIF89a" + b"\0" * 64)
    with pytest.raises(ValueError, match="'gif' is not supported"):
        imageio.imread(tmp_path / "a.gif")
    (tmp_path / "b.jpg").write_bytes(b"\xff\xd8\xff" + b"\0" * 64)
    with pytest.raises(ValueError, match="JPEG"):
        imageio.imread(tmp_path / "b.jpg")
    with pytest.raises(ValueError, match="'gif' is not supported"):
        imageio.imwrite(tmp_path / "c.gif", images["noise"])


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("dsize", [(60, 40), (331, 100), (400, 300)])
def test_resize_linear(images, kind, dsize):
    im = images[kind]
    mx, share = diff(cvops.resize(im, dsize), cv2.resize(im, dsize, interpolation=cv2.INTER_LINEAR))
    assert mx <= 1 and share <= 1e-2, (mx, share)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("dsize", [(60, 40), (100, 72), (64, 64)])
def test_resize_area(images, kind, dsize):
    im = images[kind]
    mx, share = diff(cvops.resize(im, dsize, cvops.INTER_AREA),
                     cv2.resize(im, dsize, interpolation=cv2.INTER_AREA))
    assert mx <= 1 and share <= 5e-3, (mx, share)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("perspective", [False, True])
def test_warps(images, kind, perspective):
    im = images[kind]
    M = np.eye(3)
    M[:2] = cv2.getRotationMatrix2D((0, 0), 7.3, 1.1)
    M[:2, 2] += (30, -20)
    np.testing.assert_allclose(cvops.get_rotation_matrix_2d((3, 4), 17, 1.3),
                               cv2.getRotationMatrix2D((3, 4), 17, 1.3), atol=1e-12)
    if perspective:
        M[2, :2] = (1e-4, -2e-4)
        ours = cvops.warp_perspective(im, M, (300, 250), 114)
        ref = cv2.warpPerspective(im, M, (300, 250), borderValue=(114, 114, 114))
    else:
        ours = cvops.warp_affine(im, M[:2], (300, 250), 114)
        ref = cv2.warpAffine(im, M[:2], (300, 250), borderValue=(114, 114, 114))
    mx, share = diff(ours, ref)
    assert mx <= 1 and share <= 1e-3, (mx, share)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_colour(images, kind):
    im = images[kind]
    hsv = cv2.cvtColor(im, cv2.COLOR_BGR2HSV)
    np.testing.assert_array_equal(cvops.bgr_to_hsv(im), hsv)
    mx, share = diff(cvops.to_gray(im), cv2.cvtColor(im, cv2.COLOR_BGR2GRAY))
    assert mx <= 1 and share <= 5e-3, (mx, share)
    np.testing.assert_array_equal(cvops.bgr_to_rgb(im), cv2.cvtColor(im, cv2.COLOR_BGR2RGB))
    assert diff(cvops.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))[0] <= 1
    # one pixel a row: cv2's scalar route, which ours follows exactly
    col = np.ascontiguousarray(hsv.reshape(-1, 1, 3))
    np.testing.assert_array_equal(cvops.hsv_to_bgr(col), cv2.cvtColor(col, cv2.COLOR_HSV2BGR))
    luts = [np.random.default_rng(i).integers(0, 256, 256).astype(np.uint8) for i in range(3)]
    luts[0] %= 180
    ours = im.copy()
    cvops.hsv_lut(ours, *luts)
    h, s, v = cv2.split(hsv)
    ref = cv2.cvtColor(cv2.merge((cv2.LUT(h, luts[0]), cv2.LUT(s, luts[1]), cv2.LUT(v, luts[2]))),
                       cv2.COLOR_HSV2BGR)
    assert diff(ours, ref)[0] <= 1


@pytest.mark.parametrize("k", [3, 5, 7])
def test_filters(images, k):
    im = images["noise"]
    np.testing.assert_array_equal(cvops.blur(im, k), cv2.blur(im, (k, k)))
    np.testing.assert_array_equal(cvops.median_blur(im, k), cv2.medianBlur(im, k))
    for sigma in (0.3, 0.8):
        assert diff(cvops.gaussian_blur(im, 3, sigma), cv2.GaussianBlur(im, (3, 3), sigma))[0] <= 1
    delta = np.random.default_rng(k).normal(0, 20, im.shape).astype(np.int16)
    np.testing.assert_array_equal(cvops.add_saturate(im, delta), cv2.add(im, delta, dtype=cv2.CV_8U))
    np.testing.assert_array_equal(cvops.copy_make_border(im, 3, 1, 2, 5, (114, 114, 114)),
                                  cv2.copyMakeBorder(im, 3, 1, 2, 5, cv2.BORDER_CONSTANT,
                                                     value=(114, 114, 114)))


def _painted(ours_fn, cv_fn, shape=(64, 64, 3)):
    a, b = np.zeros(shape, np.uint8), np.zeros(shape, np.uint8)
    ours_fn(a)
    cv_fn(b)
    return int((a != b).any(-1).sum()), int(b.any(-1).sum())


def test_raster():
    for r in (1, 2, 3, 5, 9, 14):
        assert _painted(lambda a: cvops.fill_circle(a, (30, 31), r, (255, 0, 0)),
                        lambda b: cv2.circle(b, (30, 31), r, (255, 0, 0), -1))[0] == 0
    assert _painted(lambda a: cvops.fill_rect(a, (-3, 10), (40, 70), (1, 2, 3)),
                    lambda b: cv2.rectangle(b, (-3, 10), (40, 70), (1, 2, 3), -1))[0] == 0
    assert _painted(lambda a: cvops.line(a, (-40, 10), (100, 45), (7, 7, 7)),
                    lambda b: cv2.line(b, (-40, 10), (100, 45), (7, 7, 7), 1))[0] == 0
    base = np.array([[10, 20], [50, 12], [55, 40], [20, 50]])
    for ang in (0, 17, 45, 100):
        R = cv2.getRotationMatrix2D((32, 32), ang, 1)
        p = np.round(base @ R[:, :2].T + R[:, 2]).astype(np.int32)
        bad, n = _painted(lambda a: cvops.fill_poly(a, p, (0, 255, 0)),
                          lambda b: cv2.fillPoly(b, [p], (0, 255, 0)))
        assert bad <= 0.02 * n, (ang, bad, n)
    for axes, ang in (((1, 2), 30), ((2, 4), 10), ((5, 3), 60), ((12, 7), 100)):
        bad, n = _painted(lambda a: cvops.fill_ellipse(a, (30, 30), axes, ang, (9, 9, 9)),
                          lambda b: cv2.ellipse(b, (30, 30), axes, ang, 0, 360, (9, 9, 9), -1))
        assert bad <= max(1, 0.2 * n), (axes, bad, n)
    for th in (2, 5, 20):
        bad, n = _painted(lambda a: cvops.line(a, (-40, 10), (100, 45), (7, 7, 7), th),
                          lambda b: cv2.line(b, (-40, 10), (100, 45), (7, 7, 7), th))
        assert bad <= (0.35 if th <= 5 else 0.05) * n, (th, bad, n)


@pytest.mark.parametrize("shape,kw", [
    ((64, 64), dict(auto=False, scaleup=False)),
    ((128, 96), dict(auto=False, scaleup=True)),
    ((128, 128), dict(auto=True, scaleup=True)),
    ((100, 80), dict(auto=False, scale_fill=True)),
])
def test_letterbox_host(images, shape, kw):
    im = images["smooth"]
    ours, r1, p1 = letterbox_host(im, shape, **kw)
    ref, r2, p2 = jax_letterbox(im, shape, **kw)
    assert ours.shape == ref.shape and r1 == r2 and p1 == p2
    assert diff(ours, ref)[0] <= 1
