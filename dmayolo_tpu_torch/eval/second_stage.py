"""Second-stage classifier over detections, and save_one_box's crop math.

Port of `dmayolo_tpu/eval/second_stage.py`:
- `apply_classifier` (the reference's utils/general.py:881-914): square
  each detection box (wh -> max), pad (*1.3 + 30), truncate, invert the
  letterbox, crop from the native BGR image, resize to 224, RGB in
  [0, 1], run a classifier, and keep only detections whose detector class
  agrees with the classifier's argmax.  `load_second_stage` takes any
  checkpoint whose config ends in a `Classify` head.
- `save_one_box` (general.py:916-929): crop a detection with a gain/pad
  margin, optionally squared, clipped to the image.

Host-side numpy; the resize is `data/cvops.py::resize` (cv2's
INTER_LINEAR, within one level) and the writes go through
`data/imageio.py`.  The classifier forward is the only device work.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.cvops import resize
from ..data.imageio import imwrite


def _xyxy2xywh_np(b):
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], axis=1)


def _xywh2xyxy_np(b):
    cx, cy, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)


def expand_boxes(xyxy, gain: float = 1.02, pad: float = 10.0, square: bool = False):
    """save_one_box's margin math (general.py:918-923): wh*gain + pad,
    optionally squared to max(w, h) first; truncated like torch .long()."""
    b = _xyxy2xywh_np(np.asarray(xyxy, np.float64).reshape(-1, 4))
    if square:
        m = b[:, 2:4].max(axis=1)
        b[:, 2] = b[:, 3] = m
    b[:, 2:4] = b[:, 2:4] * gain + pad
    return np.trunc(_xywh2xyxy_np(b))


def save_one_box(xyxy, im, file=None, gain: float = 1.02, pad: float = 10.0,
                 square: bool = False, BGR: bool = False, save: bool = True):
    """Crop one detection with margin; optionally write it (general.py:916).

    `im` is HWC BGR (cv2 layout); returns the crop in RGB unless BGR=True,
    exactly like the reference.  `file` is the destination path when
    ``save``; parent dirs are created.
    """
    box = expand_boxes(xyxy, gain=gain, pad=pad, square=square)[0]
    h, w = im.shape[:2]
    x1, y1 = int(np.clip(box[0], 0, w)), int(np.clip(box[1], 0, h))
    x2, y2 = int(np.clip(box[2], 0, w)), int(np.clip(box[3], 0, h))
    crop = im[y1:y2, x1:x2, ::(1 if BGR else -1)]
    if save and file is not None and crop.size:
        f = Path(file).with_suffix(".jpg")
        f.parent.mkdir(parents=True, exist_ok=True)
        # imwrite takes BGR; flip back if the crop was returned RGB
        imwrite(f, crop if BGR else crop[:, :, ::-1])
    return crop


def apply_classifier(dets, classifier_fn, lb_shape, im0s, size: int = 224):
    """Second-stage agreement filter (general.py:881-914).

    dets: list of (n, 6) numpy [x1 y1 x2 y2 conf cls] in LETTERBOX coords
      (the reference filters pre-scale_coords detections too).
    classifier_fn: (N, size, size, 3) float32 RGB in [0, 1] NHWC ->
      (N, n_classes) logits/scores; argmax must be class-index-aligned
      with the detector's classes.
    lb_shape: (h, w) of the letterboxed model input.
    im0s: native BGR image per entry of dets.

    Returns the filtered list; boxes keep their original (un-expanded,
    letterbox-coord) values like the reference (it clones before
    expanding).
    """
    out = []
    for d, im0 in zip(dets, im0s):
        d = np.asarray(d, np.float32)
        if d.shape[0] == 0:
            out.append(d)
            continue
        # square to max(w,h), *1.3 + 30, truncate (general.py:889-892)
        box = expand_boxes(d[:, :4], gain=1.3, pad=30.0, square=True)
        # letterbox-invert + clip (general.py:895 scale_coords)
        gain = min(lb_shape[0] / im0.shape[0], lb_shape[1] / im0.shape[1])
        pad_x = (lb_shape[1] - im0.shape[1] * gain) / 2
        pad_y = (lb_shape[0] - im0.shape[0] * gain) / 2
        box[:, [0, 2]] = ((box[:, [0, 2]] - pad_x) / gain).clip(0, im0.shape[1])
        box[:, [1, 3]] = ((box[:, [1, 3]] - pad_y) / gain).clip(0, im0.shape[0])
        ims, ok = [], np.ones(d.shape[0], bool)
        for j, (x1, y1, x2, y2) in enumerate(box):
            cut = im0[int(y1):int(y2), int(x1):int(x2)]
            if cut.size == 0:  # degenerate after clip: unclassifiable, drop
                ok[j] = False  # (the reference crashes here; we filter)
                continue
            cut = resize(cut, (size, size))[:, :, ::-1]  # BGR->RGB
            ims.append(cut.astype(np.float32) / 255.0)
        if not ims:
            out.append(d[:0])
            continue
        logits = np.asarray(classifier_fn(np.stack(ims)))
        cls2 = logits.argmax(1)
        agree = np.zeros(d.shape[0], bool)
        agree[ok] = d[ok, 5].astype(int) == cls2[: int(ok.sum())]
        out.append(d[agree])
    return out


def load_second_stage(weights: str, cfg: str | None = None, device=None):
    """A classifier_fn from a checkpoint whose config ends in a `Classify`
    head (the reference's load_classifier analogue): the BN-folded model
    on `device` (None: CUDA), bf16, logits returned as float32 numpy."""
    from ..cli.common import load_model_from_checkpoint

    model = load_model_from_checkpoint(weights, cfg, device=device).fuse()
    dev = next(model.parameters()).device

    def classifier_fn(x):
        with torch.inference_mode():
            xt = torch.as_tensor(np.ascontiguousarray(x), device=dev)
            out = model.apply(xt, dtype=torch.bfloat16, fused=True)
            return out.float().cpu().numpy()

    return classifier_fn
