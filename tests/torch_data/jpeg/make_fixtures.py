"""Writes the JPEG fixtures of this folder and `pixels.npz`, their pixels
as the port's libjpeg route decodes them (equal to `cv2.imdecode`, which
this script checks), and `pixels_box.npz`, the small fixtures' pixels
with 4:2:0 chroma upsampled by replication (libjpeg's
do_fancy_upsampling off), the upsampling nvJPEG does.

    PYTHONPATH=. python tests/torch_data/jpeg/make_fixtures.py

Baseline 4:2:0, the odd-sized file and the VisDrone-analog frame are
written by the port's own encoder (libjpeg's defaults: baseline, 4:2:0);
the other kinds by cv2's encoder flags, which the port's encoder does not
have: 4:4:4 chroma, one grey component, progressive, restart markers every
four MCUs.
"""
from pathlib import Path

import cv2
import numpy as np

from dmayolo_tpu_torch.data.imageio import _jpeg_decode, imread, imwrite
from dmayolo_tpu_torch.data.synthetic import _visdrone_scene

HERE = Path(__file__).resolve().parent
FRAME_SEED = 7  # the smallest of seeds 0-11 once compressed


def scene(h, w, seed):
    """Smooth gradients, a few filled shapes and mild noise: BGR uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / max(w - 1, 1) * 255, yy / max(h - 1, 1) * 255,
                    (xx + yy) / max(h + w - 2, 1) * 255], -1)
    for _ in range(4):
        x0, y0 = rng.integers(0, w), rng.integers(0, h)
        img[max(0, y0 - h // 6):y0 + h // 6, max(0, x0 - w // 6):x0 + w // 6] = rng.integers(0, 256, 3)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main():
    files = {}
    for name, (h, w) in {"baseline_420": (48, 64), "odd_37x23": (23, 37)}.items():
        imwrite(HERE / f"{name}.jpg", scene(h, w, len(files)))
        files[name] = HERE / f"{name}.jpg"
    img = scene(48, 64, 10)
    flags = {"baseline_444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
             "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
             "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 4]}
    for name, f in flags.items():
        cv2.imwrite(str(HERE / f"{name}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 95, *f])
        files[name] = HERE / f"{name}.jpg"
    cv2.imwrite(str(HERE / "gray.jpg"), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    files["gray"] = HERE / "gray.jpg"
    frame, _ = _visdrone_scene(FRAME_SEED, 1536, 40, 110, 1.0, 1.0, 1.0)
    imwrite(HERE / "visdrone_1536x864.jpg", np.ascontiguousarray(frame[:864]), quality=85)
    files["visdrone_1536x864"] = HERE / "visdrone_1536x864.jpg"
    pixels = {}
    for name, path in files.items():
        pixels[name] = imread(path)
        ref = cv2.imdecode(np.frombuffer(path.read_bytes(), np.uint8), cv2.IMREAD_COLOR)
        assert np.array_equal(pixels[name], ref), name
    np.savez_compressed(HERE / "pixels.npz", **pixels)
    np.savez_compressed(HERE / "pixels_box.npz", **{
        name: _jpeg_decode(path.read_bytes(), path, fancy=False)
        for name, path in files.items() if name != "visdrone_1536x864"})


if __name__ == "__main__":
    main()
