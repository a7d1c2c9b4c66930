"""Host image augmentation for the data loader, without OpenCV.

Port of `dmayolo_tpu/data/augment.py`: the same random draws in the same
order from the caller's `random.Random`, the same numpy arithmetic on the
labels, so that the labels come out equal to the JAX package's; the pixel
work goes through `cvops` (see its docstring for how close each op comes
to cv2).  Runs in the loader's threads; the loops release the GIL.

Labels here are (n, 5) [cls, x1, y1, x2, y2] pixel xyxy unless stated.
"""
from __future__ import annotations

import math
import random

import numpy as np

from . import cvops


def augment_hsv(im, hgain=0.5, sgain=0.5, vgain=0.5, rng: random.Random = random):
    """Lookup-table HSV jitter of a BGR image, in place."""
    if not (hgain or sgain or vgain):
        return
    r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain] + 1
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(im.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(im.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(im.dtype)
    cvops.hsv_lut(im, lut_hue, lut_sat, lut_val)


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1, eps=1e-16):
    """Boxes that survive the warp sanely: wider and taller than wh_thr px,
    more than area_thr of their area, aspect under ar_thr."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def random_perspective(im, targets=np.zeros((0, 5)), degrees=10, translate=0.1,
                       scale=0.1, shear=10, perspective=0.0, border=(0, 0),
                       rng: random.Random = random, segments=None):
    """Centre, perspective, rotation, scale, shear and translation in one
    warp of the image and its xyxy boxes (or polygons)."""
    height = im.shape[0] + border[0] * 2
    width = im.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -im.shape[1] / 2
    C[1, 2] = -im.shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cvops.get_rotation_matrix_2d((0, 0), a, s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            im = cvops.warp_perspective(im, M, (width, height), 114)
        else:
            im = cvops.warp_affine(im, M[:2], (width, height), 114)

    n = len(targets)
    if n:
        use_segments = segments is not None and len(segments) == n and any(len(s) for s in segments)
        if use_segments:
            segments = resample_segments(segments)
            new = np.zeros((n, 4))
            for i, seg in enumerate(segments):
                xy = np.ones((len(seg), 3))
                xy[:, :2] = seg
                xy = xy @ M.T
                xy = xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]
                new[i] = segment2box(xy, width, height)
            keep = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T, area_thr=0.01)
            targets = targets[keep]
            targets[:, 1:5] = new[keep]
            return im, targets
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T, area_thr=0.10)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return im, targets


def segment2box(segment, width=640, height=640):
    """Polygon -> its xyxy box over the points inside the image."""
    x, y = segment.T
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[inside], y[inside]
    return (np.array([x.min(), y.min(), x.max(), y.max()])
            if x.size else np.zeros(4))


def segments2boxes(segments):
    """Polygons -> (n, 4) xywh boxes."""
    boxes = []
    for seg in segments:
        x, y = seg.T
        boxes.append([x.min(), y.min(), x.max(), y.max()])
    b = np.asarray(boxes, np.float32)
    out = np.empty_like(b)
    out[:, 0] = (b[:, 0] + b[:, 2]) / 2
    out[:, 1] = (b[:, 1] + b[:, 3]) / 2
    out[:, 2] = b[:, 2] - b[:, 0]
    out[:, 3] = b[:, 3] - b[:, 1]
    return out


def resample_segments(segments, n=1000):
    """Each (m, 2) polygon, closed, resampled to n points."""
    out = []
    for seg in segments:
        seg = np.concatenate((seg, seg[0:1]), 0)
        x = np.linspace(0, len(seg) - 1, n)
        xp = np.arange(len(seg))
        out.append(np.stack([np.interp(x, xp, seg[:, i]) for i in range(2)], -1))
    return out


def copy_paste(im, labels, segments, p=0.5, rng: random.Random = random):
    """Paste mirrored copies of labelled polygons where they overlap the
    other labels by less than 0.30 of their area.  Applies only when every
    label carries a polygon (labels[j] pairs with segments[j])."""
    n = len(segments)
    if n != len(labels):
        return im, labels, segments
    if p and n:
        h, w = im.shape[:2]
        im_new = np.zeros(im.shape, np.uint8)
        for j in rng.sample(range(n), k=round(p * n)):
            l, seg = labels[j], segments[j]
            box = np.array([w - l[3], l[2], w - l[1], l[4]])
            ioa = _bbox_ioa(box, labels[:, 1:5])
            if (ioa < 0.30).all():
                labels = np.concatenate((labels, [[l[0], *box]]), 0)
                segments.append(np.concatenate((w - seg[:, 0:1], seg[:, 1:2]), 1))
                cvops.fill_poly(im_new, segments[j].astype(np.int32), (255, 255, 255))
        result = (im & im_new)[:, ::-1]
        mask = result > 0
        im[mask] = result[mask]
    return im, labels, segments


def mixup(im, labels, im2, labels2, rng: random.Random = random):
    """beta(32, 32) blend of two images; the labels of both."""
    r = np.random.default_rng(rng.getrandbits(32)).beta(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.uint8)
    return im, np.concatenate((labels, labels2), 0)


def blur(im, k: int):
    """Box blur with an odd kernel."""
    return cvops.blur(im, k)


def median_blur(im, k: int):
    """Median blur with an odd kernel."""
    return cvops.median_blur(im, k)


def to_gray(im):
    """Luma, replicated back to three channels (BGR)."""
    g = cvops.to_gray(im)
    return np.repeat(g[..., None], 3, axis=2)


def clahe(im, clip_limit: float = 2.0, tile: int = 8):
    """Contrast-limited adaptive histogram equalisation of the LAB
    lightness channel (BGR in and out), on a tile x tile grid."""
    lab = cvops.bgr_to_lab(im)
    lab[..., 0] = cvops.clahe(lab[..., 0], clip_limit, tile)
    return cvops.lab_to_bgr(lab)


def brightness_contrast(im, alpha: float = 1.0, beta: float = 0.0):
    """out = clip(im * alpha + beta * 255); alpha = contrast, beta = brightness."""
    return np.clip(im.astype(np.float32) * alpha + beta * 255.0, 0, 255).astype(np.uint8)


def photometric(im, hyp, rng: random.Random = random):
    """Blur, median blur, grey, CLAHE and brightness-contrast, each an
    independent draw gated by its hyp key (all default 0, off)."""
    if rng.random() < hyp.get("blur", 0.0):
        im = blur(im, rng.choice([3, 5, 7]))
    if rng.random() < hyp.get("median_blur", 0.0):
        im = median_blur(im, rng.choice([3, 5, 7]))
    if rng.random() < hyp.get("to_gray", 0.0):
        im = to_gray(im)
    if rng.random() < hyp.get("clahe", 0.0):
        im = clahe(im, clip_limit=rng.uniform(1.0, 4.0))
    if rng.random() < hyp.get("brightness_contrast", 0.0):
        im = brightness_contrast(
            im, alpha=1.0 + rng.uniform(-0.2, 0.2), beta=rng.uniform(-0.2, 0.2))
    return im


def cutout(im, labels, p=0.5, rng: random.Random = random):
    """Random grey squares, in place; drops labels covered over 0.60."""
    if rng.random() >= p:
        return labels
    h, w = im.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
    for s in scales:
        mask_h = rng.randint(1, int(h * s))
        mask_w = rng.randint(1, int(w * s))
        xmin = max(0, rng.randint(0, w) - mask_w // 2)
        ymin = max(0, rng.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        im[ymin:ymax, xmin:xmax] = [rng.randint(64, 191) for _ in range(3)]
        if len(labels) and s > 0.03:
            ioa = _bbox_ioa(np.array([xmin, ymin, xmax, ymax], np.float32), labels[:, 1:5])
            labels = labels[ioa < 0.60]
    return labels


def _bbox_ioa(box1, box2, eps=1e-7):
    """Intersection over box2's area."""
    b2x1, b2y1, b2x2, b2y2 = box2[:, 0], box2[:, 1], box2[:, 2], box2[:, 3]
    inter = (np.minimum(box1[2], b2x2) - np.maximum(box1[0], b2x1)).clip(0) * (
        np.minimum(box1[3], b2y2) - np.maximum(box1[1], b2y1)
    ).clip(0)
    return inter / ((b2x2 - b2x1) * (b2y2 - b2y1) + eps)


def flip_lr(im, labels_xywhn):
    im = np.fliplr(im)
    if len(labels_xywhn):
        labels_xywhn[:, 1] = 1 - labels_xywhn[:, 1]
    return np.ascontiguousarray(im), labels_xywhn


def flip_ud(im, labels_xywhn):
    im = np.flipud(im)
    if len(labels_xywhn):
        labels_xywhn[:, 2] = 1 - labels_xywhn[:, 2]
    return np.ascontiguousarray(im), labels_xywhn
