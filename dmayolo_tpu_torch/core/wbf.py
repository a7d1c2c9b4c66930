"""Weighted Boxes Fusion (Solovyev et al., 2021): offline ensembling.

Port of `dmayolo_tpu/core/wbf.py`, line for line: a numpy implementation
of the published algorithm with the `ensemble_boxes` package's documented
semantics, on the host (it fuses a handful of saved prediction files):

  * prefilter: drop boxes with score < skip_box_thr (score == thr is KEPT),
    clip coordinates to [0, 1], swap inverted x1>x2 / y1>y2 pairs, drop
    zero-area boxes;
  * per-model weights multiply scores before clustering;
  * greedy clustering against the running FUSED box, same-label only,
    strict `iou > iou_thr`;
  * fused coords = weighted-score average over the cluster;
  * conf_type 'avg' (cluster mean of weighted scores) or 'max';
  * support rescale: score *= min(T, W)/W with T = cluster size and W =
    total model weight, or T/W when allows_overflow=True.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _iou(box, boxes):
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (a1 + a2 - inter + 1e-9)


def weighted_boxes_fusion(
    boxes_list: Sequence[np.ndarray],   # per model: (n, 4) normalised xyxy
    scores_list: Sequence[np.ndarray],
    labels_list: Sequence[np.ndarray],
    weights: Sequence[float] | None = None,
    iou_thr: float = 0.55,
    skip_box_thr: float = 0.0,
    conf_type: str = "avg",
    allows_overflow: bool = False,
):
    """Returns (boxes (m,4), scores (m,), labels (m,)) sorted by score."""
    if conf_type not in ("avg", "max"):
        raise ValueError(f"unknown conf_type {conf_type!r}")
    n_models = len(boxes_list)
    if weights is None:
        weights = np.ones(n_models)
    elif len(weights) != n_models:
        # package behavior: warn and fall back to uniform weights rather
        # than silently deflating every fused score (extra weights inflate
        # total_w) or crashing on weights[m]
        import warnings

        warnings.warn(
            f"wbf: {len(weights)} weights for {n_models} models — ignoring"
        )
        weights = np.ones(n_models)
    weights = np.asarray(weights, np.float64)

    # prefilter + gather: rows [label, score*w, w, x1, y1, x2, y2]
    rows = []
    for m in range(n_models):
        b = np.asarray(boxes_list[m], np.float64).reshape(-1, 4)
        s = np.asarray(scores_list[m], np.float64).reshape(-1)
        l = np.asarray(labels_list[m], np.float64).reshape(-1)
        for bb, ss, ll in zip(b, s, l):
            if ss < skip_box_thr:  # score == thr is kept
                continue
            x1, y1, x2, y2 = np.clip(bb, 0.0, 1.0)
            if x2 < x1:
                x1, x2 = x2, x1
            if y2 < y1:
                y1, y2 = y2, y1
            if (x2 - x1) * (y2 - y1) == 0.0:  # zero-area after clipping
                continue
            rows.append([ll, ss * weights[m], weights[m], x1, y1, x2, y2])
    if not rows:
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0)
    rows = np.asarray(rows)
    rows = rows[rows[:, 1].argsort()[::-1]]

    out_boxes: List[np.ndarray] = []   # fused box per cluster
    clusters: List[List[np.ndarray]] = []
    for row in rows:
        matched = -1
        if out_boxes:
            fused = np.asarray(out_boxes)
            same = fused[:, 0] == row[0]
            if same.any():
                ious = _iou(row[3:], fused[:, 3:])
                ious[~same] = 0
                j = int(np.argmax(ious))
                if ious[j] > iou_thr:
                    matched = j
        if matched >= 0:
            clusters[matched].append(row)
            c = np.asarray(clusters[matched])
            w = c[:, 1]
            fused_box = (c[:, 3:] * w[:, None]).sum(0) / w.sum()
            out_boxes[matched] = np.concatenate(
                [[row[0], w.sum(), c[:, 2].sum()], fused_box]
            )
        else:
            clusters.append([row])
            out_boxes.append(row.copy())

    fused = np.asarray(out_boxes)
    boxes = fused[:, 3:]
    labels = fused[:, 0]
    # cluster confidence: 'avg' = mean of weighted scores, 'max' = their max;
    # then the support rescale min(T, W)/W (or T/W under allows_overflow)
    # with T = cluster size, W = total model weight
    total_w = float(weights.sum())
    scores = []
    for c in clusters:
        ws = np.asarray(c)[:, 1]
        conf = ws.max() if conf_type == "max" else ws.sum() / len(ws)
        support = len(ws) / total_w if allows_overflow else (
            min(len(ws), total_w) / total_w)
        scores.append(conf * support)
    scores = np.asarray(scores)
    order = scores.argsort()[::-1]
    return boxes[order], scores[order], labels[order]
