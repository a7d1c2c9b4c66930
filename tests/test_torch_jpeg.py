"""JPEG in the port (dmayolo_tpu_torch/data/imageio.py) and its box
drawing (data/cvops.py::rectangle, put_text), on the CPU.

- The fixtures of tests/torch_data/jpeg/ (baseline 4:2:0 and 4:4:4, one
  grey component, progressive, restart markers, 37x23, a 1536x864
  VisDrone-analog frame at quality 85) decode on the libjpeg route to
  exactly `cv2.imdecode`'s pixels and `pixels.npz`, by `imread` and by
  `imdecode`; PNG bytes decode too; bytes that are neither raise.
  `pixels_box.npz` is the same route with chroma replicated (nvJPEG's
  upsampling), equal to the default where no chroma is upsampled.
- `jpeg_codec()`: "libjpeg" where <jpeglib.h> is found; "nvjpeg" where it
  is not but nvjpeg.h and a CUDA device are; otherwise it raises, naming
  both (the probes monkeypatched).
- The frame header parse (`jpeg_frame`) reads each fixture's coding, size
  and components; `nvjpeg_unsupported` names CMYK, 12-bit and
  arithmetic-coded frames, and the nvJPEG route raises naming them
  before it loads nvJPEG.
- `rectangle` is pixel-equal to `cv2.rectangle` (thickness -1 to 7,
  corners inside and outside the image); `put_text` draws inside the text
  box cv2 would fill (its pixels are a bitmap font's, not compared).
The nvJPEG route runs only where a CUDA device is: chip_smoke.py's jpeg
phase holds it against these pixels on the card.
"""
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from dmayolo_tpu_torch.data import cvops, imageio
from dmayolo_tpu_torch.utils import cuda_build

FIXTURES = Path(__file__).resolve().parent / "torch_data" / "jpeg"
NAMES = ["baseline_420", "baseline_444", "gray", "progressive", "restart", "odd_37x23",
         "visdrone_1536x864"]
CODING = {"baseline_420": "baseline", "baseline_444": "baseline", "gray": "baseline",
          "progressive": "progressive", "restart": "baseline", "odd_37x23": "baseline",
          "visdrone_1536x864": "baseline"}


@pytest.fixture(scope="module")
def pixels():
    with np.load(FIXTURES / "pixels.npz") as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("name", NAMES)
def test_fixture_decodes_like_cv2(name, pixels):
    assert imageio.jpeg_codec() == "libjpeg"
    path = FIXTURES / f"{name}.jpg"
    buf = path.read_bytes()
    want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(imageio.imread(path), want)
    np.testing.assert_array_equal(imageio.imdecode(buf), want)
    np.testing.assert_array_equal(pixels[name], want)
    assert imageio.image_shape(path) == want.shape[:2]
    coding, precision, h, w, comps = imageio.jpeg_frame(buf, path)
    assert (coding, precision, (h, w)) == (CODING[name], 8, want.shape[:2])
    assert comps == (1 if name == "gray" else 3)
    assert imageio.nvjpeg_unsupported((coding, precision, h, w, comps)) == ""


@pytest.mark.parametrize("name", NAMES[:-1])
def test_box_upsampled_reference(name, pixels):
    """pixels_box.npz (the reference nvJPEG is held to on the card) is the
    libjpeg route with chroma replicated; it differs from the default
    decode only where 4:2:0 chroma is upsampled."""
    with np.load(FIXTURES / "pixels_box.npz") as d:
        box = d[name]
    path = FIXTURES / f"{name}.jpg"
    np.testing.assert_array_equal(imageio._jpeg_decode(path.read_bytes(), path, fancy=False),
                                  box)
    same = np.array_equal(box, pixels[name])
    assert same == (name in ("gray", "baseline_444")), name


def test_fixtures_stay_small():
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1.5 * 2 ** 20


def test_imdecode_png_and_garbage(tmp_path):
    img = np.random.default_rng(0).integers(0, 255, (17, 29, 3), dtype=np.uint8)
    imageio.imwrite(tmp_path / "a.png", img)
    np.testing.assert_array_equal(imageio.imdecode((tmp_path / "a.png").read_bytes()), img)
    for bad in (b"", b"GIF89a....", b"\xff\xd8\xff\xe0" + b"\x00" * 40):
        with pytest.raises(ValueError):
            imageio.imdecode(bad)


@pytest.mark.parametrize("libjpeg, nvjpeg, cuda, want", [
    (True, True, True, "libjpeg"), (True, False, False, "libjpeg"),
    (False, True, True, "nvjpeg"), (False, True, False, None), (False, False, True, None)])
def test_jpeg_codec_choice(monkeypatch, libjpeg, nvjpeg, cuda, want):
    real = cuda_build.has_header
    monkeypatch.setattr(cuda_build, "has_header",
                        lambda h: libjpeg if h == "jpeglib.h" else real(h))
    monkeypatch.setattr(cuda_build, "nvjpeg_header", lambda: nvjpeg)
    monkeypatch.setattr(imageio.torch.cuda, "is_available", lambda: cuda)
    if want is None:
        with pytest.raises(RuntimeError, match="jpeglib.h.*nvJPEG"):
            imageio.jpeg_codec()
        assert not imageio.jpeg_available()
    else:
        assert imageio.jpeg_codec() == want and imageio.jpeg_available()


def frame_bytes(marker: int, precision: int, comps: int, h=8, w=8) -> bytes:
    """SOI, an APP0 segment, then one frame header."""
    app0 = b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00" + b"\x01\x01\x00" + b"\x00" * 6
    body = struct.pack(">BHHB", precision, h, w, comps) + b"\x11\x11\x00" * comps
    return b"\xff\xd8" + app0 + bytes([0xFF, marker]) + struct.pack(">H", 2 + len(body)) + body


@pytest.mark.parametrize("marker, precision, comps, kind", [
    (0xC0, 8, 4, "CMYK"), (0xC1, 12, 3, "12-bit"), (0xC9, 8, 3, "arithmetic-coded"),
    (0xCA, 8, 3, "progressive arithmetic-coded"), (0xC3, 8, 3, "lossless")])
def test_nvjpeg_route_names_unsupported_kinds(monkeypatch, marker, precision, comps, kind):
    buf = frame_bytes(marker, precision, comps)
    assert imageio.nvjpeg_unsupported(imageio.jpeg_frame(buf, "x")) == kind
    monkeypatch.setattr(imageio, "jpeg_codec", lambda: "nvjpeg")
    monkeypatch.setattr(imageio, "nvlib", lambda: pytest.fail("nvJPEG loaded for a file it "
                                                              "does not take"))
    with pytest.raises(ValueError, match=f"{kind} JPEG is not supported by nvJPEG"):
        imageio.imdecode(buf)


def test_frame_header_missing_raises():
    with pytest.raises(ValueError, match="no frame header"):
        imageio.jpeg_frame(b"\xff\xd8\xff\xda\x00\x02", "y.jpg")


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3, 4, 5, 7])
def test_rectangle_matches_cv2(thickness):
    rng = np.random.default_rng(thickness + 10)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(8, 60, 2))
        p1 = tuple(int(v) for v in rng.integers(-15, 75, 2))
        p2 = tuple(int(v) for v in rng.integers(-15, 75, 2))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = want.copy()
        cv2.rectangle(want, p1, p2, color, thickness)
        cvops.rectangle(got, p1, p2, color, thickness)
        np.testing.assert_array_equal(got, want)


def test_put_text_draws_in_cv2s_box():
    text, org, scale, thick = "car 0.87", (5, 30), 0.6, 2
    (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thick)
    im = np.zeros((50, 120, 3), np.uint8)
    cvops.put_text(im, text, org, scale, (255, 255, 255), thick)
    ys, xs = np.nonzero(im[..., 0])
    assert len(xs) > 50
    slack = 3  # the bitmap's blocks and its stroke width against cv2's
    assert xs.min() >= org[0] - slack and xs.max() <= org[0] + tw + slack
    assert ys.min() >= org[1] - th - slack and ys.max() <= org[1] + base + slack
