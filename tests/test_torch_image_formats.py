"""BMP, TIFF, MPO and EXIF orientation in the port's image files
(dmayolo_tpu_torch/data/imageio.py, the host library's BMP, LZW, PackBits,
predictor and orientation routines) and its anti-aliased box
(data/cvops.py::rectangle(..., line_type=LINE_AA)), against cv2 (the JAX
package reads and writes through it), PIL (the JAX REST server's decoder)
and the JAX `DetectionDataset`, on the CPU.

- Every fixture of tests/torch_data/formats/ (BMP of 1, 4, 8, 16, 24 and
  32 bits, bitfields, top-down, OS/2; TIFF none, LZW with and without
  predictor 2, deflate 8 and 32946, PackBits, tiled, grey, palette, RGBA,
  16-bit colour and grey, big-endian 8- and 16-bit; an MPO; JPEGs of EXIF
  orientations 1-8 in both byte orders; PNGs with eXIf) reads to cv2's
  pixels exactly, by `imread` and `imdecode`, and `image_shape` gives
  their shape.  cv2 5.0.0's `imread` fails on a TIFF whose orientation tag
  is 5-8 (an internal assertion); the port rotates it as `cv2.imdecode`
  does.  Bytes read by their signature: a `.jpg` holding PNG is a PNG.
- `imwrite` writes BMP (24-bit) and TIFF (LZW, predictor 2) that cv2 and
  the port read back to the same pixels; LZW and PackBits round trips.
- webp (lossy q80, lossless, lossless with alpha, and one under EXIF
  orientation 6, through cv2's decoder) reads to cv2's pixels by
  `imread` and `imdecode`, `image_shape` gives its shape from the header,
  and `imwrite` writes cv2's own bytes; a DNG (a TIFF with DNGVersion)
  reads as its IFD0, to cv2's (24, 40, 3).
- The REST decode (`imdecode(exif=False)`) is PIL's `convert("RGB")` on
  every fixture (no EXIF rotation of JPEG, MPO or PNG; a TIFF's tag
  applied), but the four whose samples the port scales as cv2 does
  (16-bit BMP fields, 16-bit TIFF), which it holds to cv2.
- The Grad-CAM box: `rectangle(..., 2, LINE_AA)` against
  `cv2.rectangle(..., 2, cv2.LINE_AA)`: every pixel either draws in the
  colour itself is the same in both (the band and its round corners);
  the rest within AA_MAX levels, their mean within AA_MEAN over the
  pixels either draws (the soft edge is a fitted ramp, not cv2's LineAA
  tables: 53 or 58 beside a band where the port draws 56, and up to ~70
  at the corners and between two close sides, which cv2 blends twice).
- A dataset of mixed formats (PNG, BMP, TIFF, JPEG with EXIF
  orientations 3, 6 and 8 holding rotated pixels): the label-cache
  shapes (the rotated ones) and labels equal JAX's `DetectionDataset`'s,
  and the loader's batches equal JAX's within the area resize's 1 level.
"""
import io
import random
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from dmayolo_tpu.data import datasets as jd
from dmayolo_tpu.data import loader as jl
from dmayolo_tpu_torch.data import cvops, imageio
from dmayolo_tpu_torch.data import datasets as pd
from dmayolo_tpu_torch.data import loader as pl
from dmayolo_tpu_torch.data import synthetic as ps

FIXTURES = Path(__file__).resolve().parent / "torch_data" / "formats"
NAMES = sorted(p.stem for p in FIXTURES.iterdir() if p.suffix not in (".py", ".npz"))
SCALED = {"bmp16_555", "bmp16_565", "tif_16bit", "tif_16bit_grey", "tif_bigendian_16bit"}
AA_MAX, AA_MEAN = 80, 6.0


def fixture(name):
    (path,) = [p for p in FIXTURES.iterdir() if p.stem == name]
    return path


@pytest.fixture(scope="module")
def pixels():
    with np.load(FIXTURES / "pixels.npz") as d:
        return {k: d[k] for k in d.files}


def cv2_read(path):
    im = cv2.imread(str(path))
    return cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR) if im is None else im


def test_fixtures_cover_the_formats_and_stay_small():
    assert len(NAMES) == 46
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 512 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_fixture_reads_as_cv2(name, pixels):
    path = fixture(name)
    want = cv2_read(path)
    np.testing.assert_array_equal(pixels[name], want)
    np.testing.assert_array_equal(imageio.imread(path), want)
    np.testing.assert_array_equal(imageio.imdecode(path.read_bytes()), want)
    assert imageio.image_shape(path) == want.shape[:2]


@pytest.mark.parametrize("o", range(1, 9))
def test_exif_orientation(o, pixels):
    """Orientation o of both byte orders: the stored pixels turned as cv2
    turns them (mirror, 180, flip, transpose, 90 cw, transverse, 90 ccw)."""
    stored = cv2.imdecode(np.fromfile(fixture("exif_o1_le"), np.uint8), cv2.IMREAD_COLOR)
    t = stored.transpose(1, 0, 2)
    want = {1: stored, 2: stored[:, ::-1], 3: stored[::-1, ::-1], 4: stored[::-1], 5: t,
            6: t[:, ::-1], 7: t[::-1, ::-1], 8: t[::-1]}[o]
    for order in ("le", "be"):
        path = fixture(f"exif_o{o}_{order}")
        np.testing.assert_array_equal(imageio.imread(path), want)
        assert imageio.image_shape(path) == want.shape[:2]
        np.testing.assert_array_equal(imageio.imdecode(path.read_bytes(), exif=False), stored)


def test_tiff_orientation_where_cv2_imread_fails():
    path = fixture("tif_orient6")
    assert cv2.imread(str(path)) is None  # cv2 5.0.0: 'original_ptr == real_mat.data'
    want = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_COLOR)
    assert want.shape[:2] == (40, 24)
    np.testing.assert_array_equal(imageio.imread(path), want)


def test_mpo_is_its_first_image():
    buf = fixture("mpo_o6").read_bytes()
    first = imageio._jpeg_first_image(buf)
    assert len(first) < len(buf) and first.endswith(b"\xff\xd9")
    assert imageio._jpeg_meta(buf) == (6, True)
    np.testing.assert_array_equal(imageio.imdecode(buf), imageio.imdecode(first))


def test_signature_not_extension(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (9, 13, 3), np.uint8)
    imageio.imwrite(tmp_path / "a.png", img)
    (tmp_path / "a.jpg").write_bytes((tmp_path / "a.png").read_bytes())
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.jpg"), cv2.imread(str(tmp_path / "a.jpg")))


def _pattern(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    img[:, : w // 2] = (np.arange(w // 2)[None, :, None] * 3 + np.arange(h)[:, None, None]) % 256
    return img


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (37, 53), (300, 700)])
@pytest.mark.parametrize("ext", ["bmp", "tif", "tiff"])
def test_imwrite_reads_back(tmp_path, ext, size):
    img = _pattern(*size, seed=size[0])
    path = tmp_path / f"a.{ext}"
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(str(path)), img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    assert imageio.image_shape(path) == size
    if ext != "bmp":
        tags = Image.open(path).tag_v2
        assert (tags[259], tags[317]) == (5, 2)  # LZW, horizontal differencing, as cv2 writes


@pytest.mark.parametrize("n", [0, 1, 2, 300, 5000, 200_000])
def test_lzw_round_trip(n):
    rng = np.random.default_rng(n)
    for data in (rng.integers(0, 256, n, dtype=np.uint8),  # incompressible: table resets
                 np.repeat(rng.integers(0, 4, max(n // 16, 1)).astype(np.uint8), 16)[:n]):
        data = np.ascontiguousarray(data)
        cap = data.size * 3 // 2 + 16
        enc = np.empty(cap, np.uint8)
        k = imageio.lib().io_lzw_encode(imageio._ptr(data), data.size, imageio._ptr(enc), cap)
        assert 0 < k <= cap
        out = np.empty(max(data.size, 1), np.uint8)
        m = imageio.lib().io_lzw_decode(imageio._ptr(enc), k, imageio._ptr(out), data.size)
        assert m == data.size
        np.testing.assert_array_equal(out[:m], data)


def test_packbits_decode():
    # the TIFF specification's example
    src = np.frombuffer(bytes.fromhex("FEAA0280002AFDAA0380002A22F7AA"),
                        np.uint8)
    want = bytes.fromhex("AAAAAA80002AAAAAAAAA80002A22AAAAAAAAAAAAAAAAAAAA")
    out = np.zeros(len(want), np.uint8)
    assert imageio.lib().io_packbits_decode(imageio._ptr(src), src.size, imageio._ptr(out),
                                            out.size) == len(want)
    assert out.tobytes() == want


def _dng(tmp_path):
    """A TIFF whose IFD0 holds DNGVersion (50706)."""
    buf = bytearray(fixture("tif_none").read_bytes())
    ifd = struct.unpack("<I", buf[4:8])[0]
    n = struct.unpack("<H", buf[ifd:ifd + 2])[0]
    entries = [bytes(buf[ifd + 2 + 12 * k:ifd + 14 + 12 * k]) for k in range(n)]
    entries.append(struct.pack("<HHI", 50706, 1, 4) + bytes([1, 4, 0, 0]))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    new_ifd = len(buf) + (len(buf) & 1)
    buf += b"\0" * (len(buf) & 1) + struct.pack("<H", n + 1) + b"".join(entries) + b"\0" * 4
    buf[4:8] = struct.pack("<I", new_ifd)
    path = tmp_path / "a.dng"
    path.write_bytes(bytes(buf))
    return path


def _webps(tmp_path):
    """Lossy q80, lossless (cv2's default), lossless with alpha and one
    under EXIF orientation 6 (PIL writes those two)."""
    img = _pattern(24, 40, 0)
    paths = {"q80": tmp_path / "q80.webp", "lossless": tmp_path / "lossless.webp",
             "alpha": tmp_path / "alpha.webp", "o6": tmp_path / "o6.webp"}
    cv2.imwrite(str(paths["q80"]), img, [cv2.IMWRITE_WEBP_QUALITY, 80])
    cv2.imwrite(str(paths["lossless"]), img)
    rgba = np.dstack([img[:, :, ::-1], np.arange(24 * 40, dtype=np.uint8).reshape(24, 40)])
    Image.fromarray(rgba).save(paths["alpha"], "WEBP", lossless=True)
    exif = Image.Exif()
    exif[274] = 6
    Image.fromarray(img[:, :, ::-1]).save(paths["o6"], "WEBP", lossless=True,
                                          exif=exif.tobytes())
    return paths


def test_webp_and_dng_raise(tmp_path):
    """webp and DNG read as cv2 reads them; webp is written as cv2 writes
    it."""
    paths = _webps(tmp_path)
    for kind, path in paths.items():
        want = cv2.imread(str(path))
        assert want is not None and want.shape[:2] == ((40, 24) if kind == "o6" else (24, 40))
        np.testing.assert_array_equal(imageio.imread(path), want)
        np.testing.assert_array_equal(imageio.imdecode(path.read_bytes()), want)
        assert imageio.image_shape(path) == want.shape[:2], kind
    # the REST decode (PIL's) leaves the EXIF orientation unapplied
    np.testing.assert_array_equal(imageio.imdecode(paths["o6"].read_bytes(), exif=False),
                                  np.asarray(Image.open(paths["o6"]).convert("RGB"))[:, :, ::-1])
    img = _pattern(16, 16, 0)
    imageio.imwrite(tmp_path / "b.webp", img)
    cv2.imwrite(str(tmp_path / "c.webp"), img)
    assert (tmp_path / "b.webp").read_bytes() == (tmp_path / "c.webp").read_bytes()
    np.testing.assert_array_equal(imageio.imread(tmp_path / "b.webp"), img)  # lossless
    dng = _dng(tmp_path)
    want = cv2.imread(str(dng))
    assert want.shape == (24, 40, 3)
    np.testing.assert_array_equal(imageio.imread(dng), want)
    np.testing.assert_array_equal(imageio.imdecode(dng.read_bytes()), want)
    assert imageio.image_shape(dng) == (24, 40)


@pytest.mark.parametrize("kind", ["q80", "lossless", "alpha"])
def test_webp_decode_as_pil(tmp_path, kind):
    """The REST decode of a webp upload is PIL's `convert("RGB")`, which
    the JAX server answers to: alpha dropped, the same pixels."""
    path = _webps(tmp_path)[kind]
    np.testing.assert_array_equal(imageio.imdecode(path.read_bytes(), exif=False)[:, :, ::-1],
                                  np.asarray(Image.open(path).convert("RGB")))


def test_dng_compression_the_reader_lacks_raises(tmp_path):
    """A DNG whose IFD0 is JPEG-compressed raises, naming it (cv2 reads
    none such either: it returns None for a JPEG TIFF it wrote itself)."""
    buf = bytearray(_dng(tmp_path).read_bytes())
    ifd = struct.unpack("<I", buf[4:8])[0]
    for k in range(struct.unpack("<H", buf[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * k
        if struct.unpack("<H", buf[e:e + 2])[0] == 259:
            buf[e + 8:e + 10] = struct.pack("<H", 7)
    path = tmp_path / "jpeg.dng"
    path.write_bytes(bytes(buf))
    with pytest.raises(ValueError, match="DNG compression 7 .JPEG."):
        imageio.imread(path)


@pytest.mark.parametrize("name", NAMES)
def test_rest_decode_as_pil(name):
    buf = fixture(name).read_bytes()
    ours = imageio.imdecode(buf, exif=False)[:, :, ::-1]
    if name in SCALED:  # cv2's sample scaling, held to cv2 (above) instead
        np.testing.assert_array_equal(ours[:, :, ::-1], cv2_read(fixture(name)))
        return
    np.testing.assert_array_equal(ours, np.asarray(Image.open(io.BytesIO(buf)).convert("RGB")))


def _box_case(k):
    rng = np.random.default_rng(k)
    h, w = (int(v) for v in rng.integers(30, 200, 2))
    x1, x2 = sorted(int(v) for v in rng.integers(-10, w + 10, 2))
    y1, y2 = sorted(int(v) for v in rng.integers(-10, h + 10, 2))
    bg = rng.integers(0, 256, (h, w, 3), np.uint8) if k % 2 else np.zeros((h, w, 3), np.uint8)
    colour = (0, 0, 255) if k % 3 == 0 else tuple(int(v) for v in rng.integers(0, 256, 3))
    return bg, (x1, y1), (x2, y2), colour


@pytest.mark.parametrize("k", range(12))
def test_antialiased_box_near_cv2(k):
    bg, p1, p2, colour = _box_case(k)
    ref, ours = bg.copy(), bg.copy()
    cv2.rectangle(ref, p1, p2, colour, 2, cv2.LINE_AA)
    cvops.rectangle(ours, p1, p2, colour, 2, line_type=cvops.LINE_AA)
    col = np.array(colour, np.uint8)
    solid = ((ref == col).all(-1) | (ours == col).all(-1)) & (bg != col).any(-1)
    np.testing.assert_array_equal(ours[solid], ref[solid])
    drawn = (ref != bg).any(-1) | (ours != bg).any(-1)
    d = np.abs(ours.astype(np.int64) - ref).max(-1)
    assert d.max() <= AA_MAX
    if drawn.any():
        assert d[drawn].mean() <= AA_MEAN


# the mixed-format dataset: stored pixels turned by the inverse of the
# EXIF orientation, so that both readers see the generated image
UNTURN = {3: lambda a: a[::-1, ::-1], 6: lambda a: a.transpose(1, 0, 2)[::-1],
          8: lambda a: a.transpose(1, 0, 2)[:, ::-1]}


def _exif_jpeg(img, o):
    jpeg = cv2.imencode(".jpg", np.ascontiguousarray(UNTURN[o](img)),
                        [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
    tiff = (b"MM\0*" + struct.pack(">IH", 8, 1) + struct.pack(">HHI", 0x0112, 3, 1)
            + struct.pack(">H", o) + b"\0\0" + b"\0" * 4)
    body = b"Exif\0\0" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed")
    ps.generate_visdrone_analog(root, n_train=6, n_val=1, img_size=96, min_objects=3,
                                max_objects=6, seed=4, ext="png", workers=1)
    d = root / "images" / "train"
    files = sorted(d.iterdir())
    for f, kind in zip(files, ["png", "bmp", "tif", "o3", "o6", "o8"]):
        if kind == "png":
            continue
        img = cv2.imread(str(f))
        f.unlink()
        if kind in ("bmp", "tif"):
            imageio.imwrite(f.with_suffix(f".{kind}"), img)
        else:
            f.with_suffix(".jpg").write_bytes(_exif_jpeg(img, int(kind[1])))
    return str(d)


def test_mixed_dataset_as_jax(mixed):
    ref = jd.DetectionDataset(mixed, img_size=64, nc=10)
    ours = pd.DetectionDataset(mixed, img_size=64, nc=10)
    assert [Path(f).suffix for f in ours.im_files] == [".png", ".bmp", ".tif", ".jpg", ".jpg",
                                                       ".jpg"]
    assert ours.im_files == ref.im_files
    np.testing.assert_array_equal(ours.shapes, ref.shapes)
    for a, b in zip(ours.labels, ref.labels):
        np.testing.assert_array_equal(a, b)
    kw = dict(max_targets=10, seed=3)
    got = [(b.indices, np.asarray(b.images), [np.asarray(t) for t in b.targets])
           for b in pl.DataLoader(ours, 3, workers=1, **kw)]
    want = [(b.indices, np.asarray(b.images), [np.asarray(t) for t in b.targets])
            for b in jl.DataLoader(ref, 3, workers=1, **kw)]
    assert len(got) == len(want) == 2
    for (ig, xg, tg), (iw, xw, tw) in zip(got, want):
        assert ig == iw
        assert np.abs(xg.astype(np.int64) - xw).max() <= 1
        for u, v in zip(tg, tw):
            np.testing.assert_array_equal(u, v)
