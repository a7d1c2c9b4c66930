"""mAP / PR metrics — host-side numpy, matching the reference protocol.

Port of `dmayolo_tpu/eval/metrics.py` (host numpy, copied).

ref: utils/metrics.py:15-189 (ap_per_class, compute_ap, ConfusionMatrix,
fitness) and val.py:62-83 (process_batch 10-IoU TP matching).

These run on host between device batches (the arrays are tiny); keeping
them numpy preserves exact reference numerics incl. the max-F1 operating
point and 101-pt COCO interpolation.
"""
from __future__ import annotations

import numpy as np


def fitness(x: np.ndarray) -> np.ndarray:
    """0.1*mAP@.5 + 0.9*mAP@.5:.95.  ref: utils/metrics.py:15-18."""
    w = np.asarray([0.0, 0.0, 0.1, 0.9])
    return (x[:, :4] * w).sum(1)


def compute_ap(recall, precision):
    """101-point COCO-interpolated AP.  ref: utils/metrics.py:85-111."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") else np.trapz(
        np.interp(x, mrec, mpre), x
    )
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls):
    """PR curves at 1000 conf points; returns (p, r, ap, f1, classes) at the
    max-F1 operating point.  ref: utils/metrics.py:21-83."""
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]

    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1 = 2 * p * r / (p + r + 1e-16)
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype(np.int32)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4)x(M,4) xyxy IoU matrix, numpy."""
    inter = (
        np.clip(
            np.minimum(a[:, None, 2:], b[None, :, 2:])
            - np.maximum(a[:, None, :2], b[None, :, :2]),
            0,
            None,
        )
    ).prod(2)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-16)


def process_batch(detections: np.ndarray, labels: np.ndarray, iouv: np.ndarray) -> np.ndarray:
    """Per-image TP matrix over IoU thresholds with greedy unique matching.
    detections (N,6) xyxy/conf/cls; labels (M,5) cls/xyxy.  ref: val.py:62-83."""
    correct = np.zeros((detections.shape[0], iouv.shape[0]), bool)
    if labels.shape[0] == 0 or detections.shape[0] == 0:
        return correct
    iou = box_iou_np(labels[:, 1:], detections[:, :4])
    match = (iou >= iouv[0]) & (labels[:, 0:1] == detections[None, :, 5])
    li, di = np.nonzero(match)
    if li.shape[0]:
        matches = np.stack([li, di, iou[li, di]], 1)
        if li.shape[0] > 1:
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        correct[matches[:, 1].astype(int)] = matches[:, 2:3] >= iouv[None, :].reshape(1, -1)
    return correct


class ConfusionMatrix:
    """IoU-matched confusion matrix incl. background row/col.
    ref: utils/metrics.py:114-189."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        if detections.shape[0]:
            detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int) if labels.shape[0] else np.zeros(0, int)
        detection_classes = detections[:, 5].astype(int) if detections.shape[0] else np.zeros(0, int)

        if labels.shape[0] == 0:
            # reference quirk, matched exactly: with no labels there are no
            # IoU matches, n=False, and its unmatched-detections block is
            # inside `if n:` (metrics.py:157-160) — detections on label-free
            # images are recorded NOWHERE, not as background FP
            return
        if detections.shape[0] == 0:
            for gc in gt_classes:
                self.matrix[self.nc, gc] += 1  # background FN
            return

        iou = box_iou_np(labels[:, 1:], detections[:, :4])
        li, di = np.nonzero(iou > self.iou_thres)
        if li.shape[0]:
            matches = np.stack([li, di, iou[li, di]], 1)
            if li.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int) if n else (np.zeros(0, int),) * 3
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[detection_classes[m1[j]][0], gc] += 1  # correct
            else:
                self.matrix[self.nc, gc] += 1  # background FP (missed gt)
        if n:
            for i, dc in enumerate(detection_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # background FN (extra det)

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]
