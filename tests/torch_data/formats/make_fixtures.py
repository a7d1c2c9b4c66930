"""Writes the BMP, TIFF, MPO and EXIF fixtures of this folder and
`pixels.npz`, the pixels cv2 reads from each (`cv2.imread`; for the TIFFs
of orientation 5-8, where cv2 5.0.0's imread fails, `cv2.imdecode`).

    PYTHONPATH=. python tests/torch_data/formats/make_fixtures.py

cv2 writes the 24-bit BMP, the TIFFs with LZW and predictor 2 (8- and
16-bit) and the JPEGs; PIL writes the BMPs of 1, 8 and 32 bits, the TIFFs
it compresses (none, LZW, deflate, PackBits; grey, palette, RGBA), the
MPO and the PNG's eXIf chunk; the rest is written here byte by byte: the
4-bit, 16-bit, bitfield, top-down and OS/2 BMPs, the tiled, big-endian,
code-32946 deflate and orientation-tagged TIFFs, and the EXIF APP1
segments in both byte orders.
"""
import io
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
H, W = 24, 40  # small, and not a multiple of 8 or 16 across


def scene(h=H, w=W, seed=0):
    """Gradients, two flat blocks and noise: BGR uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / (w - 1) * 255, yy / (h - 1) * 255, (xx + yy) / (h + w - 2) * 255], -1)
    img[2:9, 3:15] = (30, 200, 90)
    img[12:20, 22:37] = (240, 20, 160)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil(img):
    return Image.fromarray(np.ascontiguousarray(img[:, :, ::-1]))


# ---------------------------------------------------------------- BMP
def bmp(h, w, bpp, rows, palette=b"", comp=0, masks=b"", top_down=False, core=False):
    """A BMP of the given pixel rows (already padded, in file order)."""
    if core:
        info = struct.pack("<IHhHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, comp,
                           len(rows), 2835, 2835, len(palette) // 4, 0)
    off = 14 + len(info) + len(masks) + len(palette)
    return struct.pack("<2sIHHI", b"BM", off + len(rows), 0, 0, off) + info + masks + palette + rows


def pad_rows(a, stride):
    out = np.zeros((a.shape[0], stride), np.uint8)
    out[:, :a.shape[1]] = a
    return out


def write_bmps(img):
    files = {}
    cv2.imwrite(str(HERE / "bmp24.bmp"), img)
    pil(img).convert("RGBA").save(HERE / "bmp32.bmp")
    pil(img).convert("P").save(HERE / "bmp8_palette.bmp")
    pil(img).convert("L").save(HERE / "bmp8_grey.bmp")
    pil(img).convert("1").save(HERE / "bmp1.bmp")
    files.update({k: HERE / f"{k}.bmp" for k in ("bmp24", "bmp32", "bmp8_palette", "bmp8_grey",
                                                 "bmp1")})
    h, w = img.shape[:2]
    idx = (cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) // 16).astype(np.uint8)  # 16 levels
    pal16 = np.array([[16 * i, 255 - 16 * i, (37 * i) % 256, 0] for i in range(16)], np.uint8)
    nib = np.zeros((h, (w + 1) // 2), np.uint8)
    nib[:] = idx[:, 0::2] << 4
    nib[:, :w // 2] |= idx[:, 1::2]
    stride = ((w * 4 + 31) // 32) * 4
    raw = {"bmp4": bmp(h, w, 4, pad_rows(nib[::-1], stride).tobytes(), pal16.tobytes())}
    stride = ((w * 24 + 31) // 32) * 4
    raw["bmp24_topdown"] = bmp(h, w, 24, pad_rows(img.reshape(h, -1), stride).tobytes(),
                               top_down=True)
    b5, g5, r5 = (img[..., c].astype(np.uint16) >> 3 for c in range(3))
    g6 = img[..., 1].astype(np.uint16) >> 2
    stride = ((w * 16 + 31) // 32) * 4
    px555 = (r5 << 10 | g5 << 5 | b5).astype("<u2").view(np.uint8).reshape(h, -1)
    px565 = (r5 << 11 | g6 << 5 | b5).astype("<u2").view(np.uint8).reshape(h, -1)
    raw["bmp16_555"] = bmp(h, w, 16, pad_rows(px555[::-1], stride).tobytes())
    raw["bmp16_565"] = bmp(h, w, 16, pad_rows(px565[::-1], stride).tobytes(), comp=3,
                           masks=struct.pack("<III", 0xF800, 0x7E0, 0x1F))
    bgra = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1).reshape(h, -1)
    raw["bmp32_bitfields"] = bmp(h, w, 32, bgra[::-1].tobytes(), comp=3,
                                 masks=struct.pack("<III", 0xFF0000, 0xFF00, 0xFF))
    stride = ((w * 8 + 31) // 32) * 4
    grey_pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    raw["bmp8_os2"] = bmp(h, w, 8, pad_rows(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[::-1],
                                            stride).tobytes(), grey_pal.tobytes(), core=True)
    for k, data in raw.items():
        (HERE / f"{k}.bmp").write_bytes(data)
        files[k] = HERE / f"{k}.bmp"
    return files


# --------------------------------------------------------------- TIFF
def tiff(planes, e="<", comp=1, predictor=1, tile=None, photometric=2, orientation=None,
         extra_tags=()):
    """A one-IFD TIFF of `planes` (h, w, spp) uint8 or uint16, in strips of
    8 rows or in `tile` x `tile` tiles, compressed with deflate (8, 32946)
    or not at all, optionally with horizontal differencing."""
    h, w, spp = planes.shape
    bits = planes.dtype.itemsize * 8
    dt = np.dtype(planes.dtype).newbyteorder(e)

    def encode(block):
        block = block.astype(np.int64)
        if predictor == 2:
            block[:, 1:] = np.diff(block, axis=1)
        block = (block % (1 << bits)).astype(dt).tobytes()
        return zlib.compress(block) if comp in (8, 32946) else block

    chunks = []
    if tile:
        for ty in range(0, h, tile):
            for tx in range(0, w, tile):
                t = np.zeros((tile, tile, spp), planes.dtype)
                part = planes[ty:ty + tile, tx:tx + tile]
                t[:part.shape[0], :part.shape[1]] = part
                chunks.append(encode(t))
    else:
        for y in range(0, h, 8):
            chunks.append(encode(planes[y:y + 8]))
    data = b"".join(chunks)
    offsets = list(np.cumsum([8] + [len(c) for c in chunks[:-1]]))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [comp]),
            (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [1])]
    if tile:
        tags += [(322, 3, [tile]), (323, 3, [tile]), (324, 4, offsets),
                 (325, 4, [len(c) for c in chunks])]
    else:
        tags += [(273, 4, offsets), (278, 3, [8]), (279, 4, [len(c) for c in chunks])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if orientation:
        tags.append((274, 3, [orientation]))
    tags += list(extra_tags)
    tags.sort()
    fmts = {3: "H", 4: "I", 1: "B"}
    blob_at = 8 + len(data) + (len(data) & 1)
    blobs, entries = b"", b""
    for tag, typ, vals in tags:
        body = struct.pack(e + fmts[typ] * len(vals), *vals)
        if len(body) <= 4:
            val = body.ljust(4, b"\0")
        else:
            val = struct.pack(e + "I", blob_at + len(blobs))
            blobs += body + b"\0" * (len(body) & 1)
        entries += struct.pack(e + "HHI", tag, typ, len(vals)) + val
    ifd_at = blob_at + len(blobs)
    head = (b"II*\0" if e == "<" else b"MM\0*") + struct.pack(e + "I", ifd_at)
    return (head + data + b"\0" * (len(data) & 1) + blobs + struct.pack(e + "H", len(tags))
            + entries + struct.pack(e + "I", 0))


def write_tiffs(img):
    files = {}
    for name, comp in (("tif_none", "raw"), ("tif_lzw", "tiff_lzw"),
                       ("tif_deflate", "tiff_adobe_deflate"), ("tif_packbits", "packbits")):
        pil(img).save(HERE / f"{name}.tif", compression=comp)
        files[name] = HERE / f"{name}.tif"
    for name, mode in (("tif_grey", "L"), ("tif_palette", "P"), ("tif_rgba", "RGBA")):
        pil(img).convert(mode).save(HERE / f"{name}.tif", compression="tiff_lzw")
        files[name] = HERE / f"{name}.tif"
    cv2.imwrite(str(HERE / "tif_lzw_predictor.tif"), img)  # cv2's own: LZW, predictor 2
    files["tif_lzw_predictor"] = HERE / "tif_lzw_predictor.tif"
    rng = np.random.default_rng(5)
    u16 = (img.astype(np.uint16) << 8) | rng.integers(0, 256, img.shape, dtype=np.uint16)
    cv2.imwrite(str(HERE / "tif_16bit.tif"), u16)
    cv2.imwrite(str(HERE / "tif_16bit_grey.tif"), u16[..., 1])
    files.update(tif_16bit=HERE / "tif_16bit.tif", tif_16bit_grey=HERE / "tif_16bit_grey.tif")
    rgb = np.ascontiguousarray(img[:, :, ::-1])
    raw = {"tif_deflate_32946": tiff(rgb, comp=32946, predictor=2),
           "tif_tiled": tiff(rgb, comp=8, tile=16),
           "tif_bigendian": tiff(rgb, e=">", comp=8, predictor=2),
           "tif_bigendian_16bit": tiff(u16[:, :, ::-1].copy(), e=">", comp=8, predictor=2)}
    for o in (3, 6):
        raw[f"tif_orient{o}"] = tiff(rgb, orientation=o)
    for k, data in raw.items():
        (HERE / f"{k}.tif").write_bytes(data)
        files[k] = HERE / f"{k}.tif"
    return files


# ---------------------------------------------------------- EXIF, MPO
def exif_tiff(orientation, e):
    """A TIFF-structured EXIF block whose IFD0 holds tag 0x0112 (and a
    software tag before it, so that the parse walks past an entry)."""
    sw = b"fixture\0"
    head = (b"II*\0" if e == "<" else b"MM\0*") + struct.pack(e + "I", 8)
    n = 2
    at = 8 + 2 + 12 * n + 4
    entries = (struct.pack(e + "HHII", 0x0131, 2, len(sw), at)
               + struct.pack(e + "HHI", 0x0112, 3, 1) + struct.pack(e + "H", orientation) + b"\0\0")
    return head + struct.pack(e + "H", n) + entries + struct.pack(e + "I", 0) + sw


def with_app1(jpeg: bytes, tiff_block: bytes) -> bytes:
    body = b"Exif\0\0" + tiff_block
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


def write_exif_and_mpo(img):
    files = {}
    jpeg = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
    for e, tag in (("<", "le"), (">", "be")):
        for o in range(1, 9):
            name = f"exif_o{o}_{tag}"
            (HERE / f"{name}.jpg").write_bytes(with_app1(jpeg, exif_tiff(o, e)))
            files[name] = HERE / f"{name}.jpg"
    for o in (6, 8):
        ex = Image.Exif()
        ex[0x0112] = o
        pil(img).save(HERE / f"png_exif_o{o}.png", exif=ex.tobytes())
        files[f"png_exif_o{o}"] = HERE / f"png_exif_o{o}.png"
    second = pil(scene(seed=3))
    first = Image.open(io.BytesIO(jpeg))
    first.save(HERE / "mpo_o6.mpo", format="MPO", save_all=True, append_images=[second],
               exif=b"Exif\0\0" + exif_tiff(6, "<"))
    files["mpo_o6"] = HERE / "mpo_o6.mpo"
    return files


def cv2_pixels(path):
    buf = np.frombuffer(path.read_bytes(), np.uint8)
    im = cv2.imread(str(path))
    if im is None:  # cv2 5.0.0's imread fails on TIFFs of orientation 5-8; imdecode rotates
        im = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    return im


def main():
    img = scene()
    files = {**write_bmps(img), **write_tiffs(img), **write_exif_and_mpo(img)}
    pixels = {name: cv2_pixels(path) for name, path in files.items()}
    for name, px in pixels.items():
        assert px is not None and px.shape[2] == 3, name
    np.savez_compressed(HERE / "pixels.npz", **pixels)


if __name__ == "__main__":
    main()
