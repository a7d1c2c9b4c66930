"""Native numpy COCOeval (bbox) — pycocotools-protocol evaluation without
pycocotools, so `--save-json` gives the full 12-metric COCO summary where
pycocotools is not installed.  Port of `dmayolo_tpu/eval/cocoeval.py`
(host numpy, copied).

Implements the published COCO detection protocol: greedy score-ordered
per-image matching at IoU thresholds 0.50:0.05:0.95, crowd/ignore
handling, area ranges (all/small/medium/large), maxDets (1/10/100),
101-point interpolated precision, and the standard AP/AR summary table.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def _box_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU of (D,4) x (G,4) top-left xywh boxes; crowd gts use inter/dt_area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None], d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class NpCOCOeval:
    """COCO bbox evaluation over json-dict GT annotations + result entries.

    Args:
        gt: COCO annotation dict ({'images', 'annotations', 'categories'}).
        dt: detection entries [{'image_id','category_id','bbox','score'}, ...].
        img_ids: optional image-id subset.
    """

    def __init__(self, gt: Dict, dt: List[dict], img_ids: Optional[List] = None):
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = [1, 10, 100]
        self.area_rng = [
            (0.0, 1e10), (0.0, 32.0 ** 2), (32.0 ** 2, 96.0 ** 2), (96.0 ** 2, 1e10)
        ]
        self.area_lbl = ["all", "small", "medium", "large"]

        self.img_ids = list(img_ids) if img_ids is not None else [
            im["id"] for im in gt["images"]
        ]
        self.cat_ids = sorted(c["id"] for c in gt.get("categories", []))
        if not self.cat_ids:  # derive from annotations
            self.cat_ids = sorted({a["category_id"] for a in gt["annotations"]})

        self._gts = defaultdict(list)
        # dtm/gtm bookkeeping needs positive unique gt ids: 0 means
        # "unmatched" (the pycocotools convention), so a third-party json
        # with missing, zero, or duplicate annotation ids would silently
        # score matched dets as FPs — reassign internal ids in that case
        raw_ids = [a.get("id") for a in gt["annotations"]]
        ok_ids = (all(isinstance(i, int) and i > 0 for i in raw_ids)
                  and len(set(raw_ids)) == len(raw_ids))
        for i, a in enumerate(gt["annotations"]):
            a = dict(a)
            if not ok_ids:
                a["id"] = i + 1
            a.setdefault("iscrowd", 0)
            a.setdefault("area", a["bbox"][2] * a["bbox"][3])
            a.setdefault("ignore", 0)
            self._gts[(a["image_id"], a["category_id"])].append(a)
        self._dts = defaultdict(list)
        for i, d in enumerate(dt):
            d = dict(d)
            d["id"] = i + 1  # internal, like pycocotools loadRes
            self._dts[(d["image_id"], d["category_id"])].append(d)

        self.stats = None
        self._eval = None

    # -- per-image matching -------------------------------------------------
    def _prepare_img(self, img_id, cat_id, max_det):
        """Score-sort + cap dets and compute the IoU matrix ONCE per
        (img, cat); every area range shares it (pycocotools computeIoU)."""
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if not gts and not dts:
            return None
        scores = np.array([d["score"] for d in dts], float)
        order_d = np.argsort(-scores, kind="stable")[:max_det]
        dts = [dts[i] for i in order_d]
        crowd_raw = np.array([bool(g["iscrowd"]) for g in gts], bool)
        ious_raw = _box_iou_xywh(
            np.array([d["bbox"] for d in dts], float).reshape(-1, 4),
            np.array([g["bbox"] for g in gts], float).reshape(-1, 4),
            crowd_raw,
        )
        return dts, gts, ious_raw

    def _evaluate_area(self, prepared, area):
        """Greedy matching for one area range, reusing the prepared IoU."""
        dts, gts, ious_raw = prepared
        g_ign = np.array([
            bool(g["ignore"]) or bool(g["iscrowd"])
            or not (area[0] <= g["area"] <= area[1])
            for g in gts
        ], bool)
        order_g = np.argsort(g_ign, kind="stable")  # ignore last
        gts = [gts[i] for i in order_g]
        g_ign = g_ign[order_g]
        crowd = np.array([bool(g["iscrowd"]) for g in gts], bool)
        ious = ious_raw[:, order_g] if len(gts) else ious_raw

        T, D, G = len(self.iou_thrs), len(dts), len(gts)
        dtm = np.zeros((T, D), np.int64)
        gtm = np.zeros((T, G), np.int64)
        dt_ign = np.zeros((T, D), bool)
        for t, thr in enumerate(self.iou_thrs):
            for di in range(D):
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in range(G):
                    if gtm[t, gi] and not crowd[gi]:
                        continue  # gt already matched (crowd can multi-match)
                    if best > -1 and not g_ign[best] and g_ign[gi]:
                        break  # past non-ignored gts; keep the real match
                    if ious[di, gi] < best_iou:
                        continue
                    best, best_iou = gi, ious[di, gi]
                if best == -1:
                    continue
                dtm[t, di] = gts[best]["id"]
                gtm[t, best] = dts[di]["id"]
                dt_ign[t, di] = g_ign[best]
        # unmatched dets outside the area range are ignored
        d_out = np.array([
            not (area[0] <= d["bbox"][2] * d["bbox"][3] <= area[1]) for d in dts
        ], bool)
        dt_ign |= (dtm == 0) & d_out[None]
        return {
            "scores": np.array([d["score"] for d in dts], float),
            "dtm": dtm,
            "dt_ign": dt_ign,
            "n_gt": int((~g_ign).sum()),
        }

    # -- accumulation -------------------------------------------------------
    def evaluate(self):
        T, R = len(self.iou_thrs), len(self.rec_thrs)
        K, A, M = len(self.cat_ids), len(self.area_rng), len(self.max_dets)
        md_cap = max(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for k, cat in enumerate(self.cat_ids):
            # match once per (img, area) at maxDets=100; smaller maxDets are
            # per-image column truncations in accumulation (pycocotools'
            # evaluateImg/accumulate split)
            per_img = []
            for img in self.img_ids:
                prepared = self._prepare_img(img, cat, md_cap)
                if prepared is None:
                    continue
                per_img.append([
                    self._evaluate_area(prepared, rng) for rng in self.area_rng
                ])
            for a in range(A):
                evs = [p[a] for p in per_img]
                if not evs:
                    continue
                npig = sum(e["n_gt"] for e in evs)
                if npig == 0:
                    continue
                for m, md in enumerate(self.max_dets):
                    scores = np.concatenate([e["scores"][:md] for e in evs])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtm"][:, :md] for e in evs], 1)[:, order]
                    ign = np.concatenate(
                        [e["dt_ign"][:, :md] for e in evs], 1)[:, order]
                    tps = np.cumsum((dtm != 0) & ~ign, axis=1, dtype=float)
                    fps = np.cumsum((dtm == 0) & ~ign, axis=1, dtype=float)
                    for t in range(T):
                        tp, fp = tps[t], fps[t]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        # monotone-from-the-right interpolated precision
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        valid = inds < len(pr)
                        q[valid] = pr[inds[valid]]
                        precision[t, :, k, a, m] = q
        self._eval = {"precision": precision, "recall": recall}
        return self

    def _summ(self, ap=True, iou=None, area="all", max_det=100):
        a = self.area_lbl.index(area)
        m = self.max_dets.index(max_det)
        if ap:
            s = self._eval["precision"]
            if iou is not None:
                s = s[[int(np.argmin(np.abs(self.iou_thrs - iou)))]]
            s = s[:, :, :, a, m]
        else:
            s = self._eval["recall"]
            if iou is not None:
                s = s[[int(np.argmin(np.abs(self.iou_thrs - iou)))]]
            s = s[:, :, a, m]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def summarize(self, verbose: bool = True):
        """The standard 12-stat vector; prints the pycocotools-style table."""
        self.stats = np.array([
            self._summ(True),
            self._summ(True, iou=0.5),
            self._summ(True, iou=0.75),
            self._summ(True, area="small"),
            self._summ(True, area="medium"),
            self._summ(True, area="large"),
            self._summ(False, max_det=1),
            self._summ(False, max_det=10),
            self._summ(False, max_det=100),
            self._summ(False, area="small"),
            self._summ(False, area="medium"),
            self._summ(False, area="large"),
        ])
        if verbose:
            names = [
                ("Average Precision  (AP)", "0.50:0.95", "   all", 100),
                ("Average Precision  (AP)", "0.50     ", "   all", 100),
                ("Average Precision  (AP)", "0.75     ", "   all", 100),
                ("Average Precision  (AP)", "0.50:0.95", " small", 100),
                ("Average Precision  (AP)", "0.50:0.95", "medium", 100),
                ("Average Precision  (AP)", "0.50:0.95", " large", 100),
                ("Average Recall     (AR)", "0.50:0.95", "   all", 1),
                ("Average Recall     (AR)", "0.50:0.95", "   all", 10),
                ("Average Recall     (AR)", "0.50:0.95", "   all", 100),
                ("Average Recall     (AR)", "0.50:0.95", " small", 100),
                ("Average Recall     (AR)", "0.50:0.95", "medium", 100),
                ("Average Recall     (AR)", "0.50:0.95", " large", 100),
            ]
            for (label, iou, area, md), v in zip(names, self.stats):
                print(f" {label} @[ IoU={iou} | area={area} | "
                      f"maxDets={md:3d} ] = {v:.3f}")
        return self.stats


def evaluate_coco_native(pred_json, anno_json, img_ids=None):
    """Load GT + predictions json and run the native evaluator.

    Returns (map, map50) like `evaluate_coco`, or None on failure."""
    try:
        with open(anno_json) as f:
            gt = json.load(f)
        with open(pred_json) as f:
            dt = json.load(f)
        ev = NpCOCOeval(gt, dt, img_ids=img_ids).evaluate()
        stats = ev.summarize()
        return float(stats[0]), float(stats[1])
    except Exception as e:
        print(f"native COCOeval unable to run: {e}")
        return None
