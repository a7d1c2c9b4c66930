"""CLAHE in the port (dmayolo_tpu_torch/data/augment.py::clahe, through
cvops.bgr_to_lab / clahe / lab_to_bgr and the host library's io_bgr2lab,
io_clahe, io_lab2bgr) against the JAX package's cv2 pipeline, on the CPU.

- BGR -> LAB and LAB -> BGR equal cv2's 8-bit conversions on every one of
  the 2^24 inputs each way, and so does BGR -> grey (`to_gray`, which
  `photometric` runs before CLAHE: it took cv2's 14-bit weights, 1 level
  off on 0.26% of colours, where cv2 5.0.0 uses 15-bit ones);
- `cvops.clahe` equals cv2's CLAHE on one channel, and `augment.clahe`
  JAX's `clahe`, bit for bit, on sizes the 8 x 8 grid divides and does
  not (the histograms then come from the reflect-101 padded image), at
  clip limits from none to far above any histogram, on 4 x 4 tiles too;
- `photometric` with `clahe` on draws what JAX's draws, in the same
  order (`clip_limit = rng.uniform(1, 4)`), and gives the same image on
  every seed, alone and with the other photometric keys;
- the augmenting `DetectionDataset.get` with `clahe: 1.0` beside the
  VisDrone hyp: labels equal to JAX's, images within the pipeline's
  augmentation bounds (tests/test_torch_data_pipeline.py).
"""
import random

import cv2
import numpy as np
import pytest

from dmayolo_tpu.data import augment as ja
from dmayolo_tpu.data import datasets as jd
from dmayolo_tpu.data import synthetic as js
from dmayolo_tpu_torch.data import augment as pa
from dmayolo_tpu_torch.data import cvops
from dmayolo_tpu_torch.data import datasets as pd
from dmayolo_tpu_torch.train.trainer import load_hyp

SIZES = [(64, 64), (48, 80), (37, 23), (100, 64), (123, 257), (8, 8), (5, 3)]
CLIPS = [1.0, 2.5, 40.0]
AUG_MAX, AUG_MEAN = 24, 1.0  # tests/test_torch_data_pipeline.py's bounds


def scene(h, w, seed):
    """Gradients and blocks with noise: CLAHE has contrast to limit."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / max(w - 1, 1) * 200, yy / max(h - 1, 1) * 120 + 40,
                    (xx * yy) % 97 + 60], -1)
    img[h // 4:h // 2, w // 3:] = rng.integers(0, 256, 3)
    img += rng.normal(0, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("direction", ["bgr2lab", "lab2bgr", "bgr2gray"])
def test_lab_every_input(direction):
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    img = img.reshape(4096, 4096, 3)
    if direction == "bgr2lab":
        ours, ref = cvops.bgr_to_lab(img), cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
    elif direction == "lab2bgr":
        ours, ref = cvops.lab_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_LAB2BGR)
    else:  # photometric's to_gray, before CLAHE, must be exact too
        ours, ref = cvops.to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("clip", [0.0, 0.5, 3.7])
@pytest.mark.parametrize("size", [(64, 64), (37, 23), (1, 9), (513, 1025)])
def test_clahe_channel_as_cv2(size, clip):
    g = scene(*size, seed=size[0])[..., 1].copy()
    want = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(g)
    np.testing.assert_array_equal(cvops.clahe(g, clip), want)


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("size", SIZES)
def test_clahe_as_jax(size, clip):
    im = scene(*size, seed=sum(size))
    np.testing.assert_array_equal(pa.clahe(im, clip), ja.clahe(im, clip))


def test_clahe_other_grid():
    im = scene(70, 90, seed=4)
    np.testing.assert_array_equal(pa.clahe(im, 2.0, tile=4), ja.clahe(im, 2.0, tile=4))


HYPS = {"clahe": {"clahe": 1.0},
        "all": {"blur": 0.3, "median_blur": 0.3, "to_gray": 0.2, "clahe": 0.6,
                "brightness_contrast": 0.5}}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("hyp", list(HYPS))
def test_photometric_as_jax(hyp, seed):
    im = scene(96, 128, seed=seed)
    rj, rp = random.Random(seed), random.Random(seed)
    want = ja.photometric(im.copy(), HYPS[hyp], rj)
    got = pa.photometric(im.copy(), HYPS[hyp], rp)
    np.testing.assert_array_equal(got, want)
    assert rp.getstate() == rj.getstate()  # the same draws, in the same order


def test_dataset_get_with_clahe(tmp_path):
    js.generate_visdrone_analog(tmp_path, n_train=3, n_val=1, img_size=160, min_objects=4,
                                max_objects=8, seed=6)
    h = load_hyp("visdrone")
    h.update(clahe=1.0)
    path = str(tmp_path / "images" / "train")
    ref = jd.DetectionDataset(path, img_size=128, augment=True, hyp=h, nc=10)
    ours = pd.DetectionDataset(path, img_size=128, augment=True, hyp=h, nc=10)
    for i in range(len(ours)):
        (im_o, lb_o), (im_r, lb_r) = ours.get(i, random.Random(i)), ref.get(i, random.Random(i))
        np.testing.assert_array_equal(lb_o, lb_r)
        d = np.abs(im_o.astype(np.int64) - im_r)
        assert d.max() <= AUG_MAX and d.mean() <= AUG_MEAN
