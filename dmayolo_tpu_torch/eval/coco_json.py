"""COCO-format prediction export + optional pycocotools evaluation.

Port of `dmayolo_tpu/eval/coco_json.py` (host numpy, copied), with the
GT builder from a YOLO-layout dataset, `build_coco_gt_from_yolo`, which
reads the dataset's label cache.

Reference surface: val.py:50-60 (save_one_json), val.py:325-341 (COCOeval),
utils/general.py:517-525 (coco80_to_coco91_class). Output entries are
protocol-identical: {"image_id", "category_id", "bbox" [x,y,w,h] top-left,
"score"} with bbox rounded to 3 decimals and score to 5.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# 80-class (detection) index -> 91-class (paper) COCO category id.
# Standard public mapping (reference general.py:517-525).
_COCO91 = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]


def coco80_to_coco91_class() -> List[int]:
    return list(_COCO91)


def is_coco_data(data: Dict) -> bool:
    """Reference heuristic: val split ends with coco/val2017.txt (val.py:153)."""
    val = data.get("val")
    return isinstance(val, str) and val.endswith("coco/val2017.txt")


def image_id_map(im_files: Sequence[str]) -> Dict[str, object]:
    """Stable image ids shared by the GT builder and the prediction writer.

    int(stem)/stem when every stem is unique (the reference/COCO convention,
    val.py:52); otherwise unique relative-path ids, so sequence-style
    datasets (frames named img00001.jpg inside each sequence dir) don't
    silently attribute detections across sequences."""
    import os

    files = [str(f) for f in im_files]
    stems = [Path(f).stem for f in files]
    if len(set(stems)) == len(files):
        # isdecimal (not isnumeric: int() rejects unicode numerics like '²');
        # the CONVERTED ids must stay unique too ('7' vs '007' both -> 7)
        ids = [int(s) if s.isdecimal() else s for s in stems]
        if len(set(map(str, ids))) == len(ids):
            return dict(zip(files, ids))
        return dict(zip(files, stems))
    root = os.path.commonpath(files) if len(files) > 1 else os.path.dirname(files[0])
    return {
        f: str(Path(os.path.relpath(f, root)).with_suffix("")).replace(os.sep, "/")
        for f in files
    }


def append_coco_json(jdict: List[dict], dets_native: np.ndarray,
                     stem: Optional[str] = None,
                     class_map: Sequence[int] = (),
                     image_id=None) -> None:
    """Append one image's detections (native-space (k,6) xyxy/conf/cls) as
    COCO result entries.  ref: val.py:50-60.  Pass image_id from
    image_id_map() when stems may repeat across directories."""
    if image_id is None:
        image_id = int(stem) if stem.isdecimal() else stem
    d = np.asarray(dets_native, np.float64)
    for x1, y1, x2, y2, conf, cls in d:
        jdict.append({
            "image_id": image_id,
            "category_id": class_map[int(cls)],
            "bbox": [round(v, 3) for v in (x1, y1, x2 - x1, y2 - y1)],
            "score": round(float(conf), 5),
        })


def write_coco_json(jdict: List[dict], path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(jdict, f)
    return path


def build_coco_gt_from_yolo(val_path, nc: int, names=None,
                            class_map: Optional[Sequence[int]] = None,
                            single_cls: bool = False) -> Dict:
    """COCO-format GT dict from a YOLO-layout dataset (images + labels txt),
    so that the COCO protocol runs on any dataset.  Image ids are those of
    `append_coco_json` (`image_id_map`); `class_map` must be the map the
    prediction writer used.  Reads the dataset's label cache (shapes and
    labels): no image is decoded again."""
    from ..data.datasets import DetectionDataset

    ds = DetectionDataset(val_path, img_size=640, augment=False, rect=False)
    cmap = list(class_map) if class_map is not None else list(range(nc))
    ids = image_id_map(ds.im_files)
    images, annotations = [], []
    ann_id = 1
    cats = set()
    for f, lb, (h, w) in zip(ds.im_files, ds.labels, ds.shapes):
        iid = ids[str(f)]
        images.append({"id": iid, "file_name": Path(f).name,
                       "height": int(h), "width": int(w)})
        for cls, cx, cy, bw, bh in np.asarray(lb, np.float64).reshape(-1, 5):
            if single_cls:  # the --single-cls protocol: every class 0
                cls = 0
            x1, y1 = (cx - bw / 2) * w, (cy - bh / 2) * h
            cat = cmap[int(cls)]
            annotations.append({
                "id": ann_id, "image_id": iid, "category_id": cat,
                "bbox": [x1, y1, bw * w, bh * h], "area": bw * w * bh * h,
                "iscrowd": 0,
            })
            ann_id += 1
            cats.add((int(cls), cat))
    categories = [{"id": cat, "name": (names[c] if names and c < len(names) else str(c))}
                  for c, cat in sorted(cats)]
    return {"images": images, "annotations": annotations, "categories": categories}


def evaluate_coco(pred_json, anno_json, img_ids: Optional[List[int]] = None):
    """Run pycocotools COCOeval (bbox) when the package is importable.

    Returns (map, map50) or None (with a printed explanation) — matching the
    reference's try/except behaviour (val.py:327-341).
    """
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        # fall back to the native numpy COCOeval — same protocol, same
        # 12-stat summary, no dependency (eval/cocoeval.py)
        from .cocoeval import evaluate_coco_native

        print("pycocotools not installed — using the native COCO evaluator")
        return evaluate_coco_native(pred_json, anno_json, img_ids=img_ids)
    try:
        anno = COCO(str(anno_json))
        pred = anno.loadRes(str(pred_json))
        ev = COCOeval(anno, pred, "bbox")
        if img_ids is not None:
            ev.params.imgIds = img_ids
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        return float(ev.stats[0]), float(ev.stats[1])
    except Exception as e:  # anno file missing / malformed preds
        print(f"pycocotools unable to run: {e}")
        return None
