"""Dataset tools: autosplit, box extraction, dataset statistics.

Port of `dmayolo_tpu/data/tools.py`, with the port's image reader and
writer in place of cv2.
"""
from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np

from .datasets import IMG_FORMATS, DetectionDataset, check_dataset, img2label_paths
from .imageio import imread, imwrite


def autosplit(path, weights=(0.9, 0.1, 0.0), annotated_only=False, seed=0):
    """Write autosplit_{train,val,test}.txt image lists beside `path`."""
    path = Path(path)
    files = sorted(x for x in path.rglob("*.*") if x.suffix[1:].lower() in IMG_FORMATS)
    rng = random.Random(seed)
    indices = rng.choices([0, 1, 2], weights=weights, k=len(files))
    txt = ["autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"]
    for t in txt:
        (path.parent / t).unlink(missing_ok=True)
    n = 0
    for i, img in zip(indices, files):
        if annotated_only and not Path(img2label_paths([str(img)])[0]).exists():
            continue
        with open(path.parent / txt[i], "a") as f:
            f.write(f"./{img.relative_to(path.parent)}\n")
        n += 1
    print(f"autosplit: {n} images -> {txt}")
    return [path.parent / t for t in txt]


def extract_boxes(path):
    """Crop every labelled box (padded 1.2x + 3 px) into a classification
    layout, classifier/<cls>/<stem>_<j>.jpg beside `path`."""
    path = Path(path)
    out = path.parent / "classifier"
    files = sorted(x for x in path.rglob("*.*") if x.suffix[1:].lower() in IMG_FORMATS)
    n = 0
    for im_file in files:
        lb_file = Path(img2label_paths([str(im_file)])[0])
        if not lb_file.exists():
            continue
        im = imread(im_file)
        h, w = im.shape[:2]
        rows = np.array([x.split() for x in lb_file.read_text().strip().splitlines() if x],
                        np.float32)
        for j, row in enumerate(rows):
            c = int(row[0])
            f = out / str(c) / f"{im_file.stem}_{j}.jpg"
            f.parent.mkdir(parents=True, exist_ok=True)
            b = row[1:5] * [w, h, w, h]
            b[2:] = b[2:] * 1.2 + 3  # pad
            x1 = int(max(b[0] - b[2] / 2, 0))
            y1 = int(max(b[1] - b[3] / 2, 0))
            x2 = int(min(b[0] + b[2] / 2, w))
            y2 = int(min(b[1] + b[3] / 2, h))
            crop = im[y1:y2, x1:x2]
            if crop.size:
                imwrite(f, crop)
                n += 1
    print(f"extract_boxes: {n} crops -> {out}")
    return out


def dataset_stats(data_yaml, verbose=False):
    """Instance and image counts by split and class -> a dict (and
    stats.json under the dataset's path)."""
    data = check_dataset(data_yaml)
    stats = {}
    for split in ("train", "val", "test"):
        if not data.get(split):
            stats[split] = None
            continue
        ds = DetectionDataset(data[split], nc=data["nc"], augment=False)
        x = np.array([np.bincount(l[:, 0].astype(int), minlength=data["nc"]) for l in ds.labels])
        stats[split] = {
            "instance_stats": {"total": int(x.sum()), "per_class": x.sum(0).tolist()},
            "image_stats": {"total": ds.n, "unlabelled": int(np.all(x == 0, 1).sum()),
                            "per_class": (x > 0).sum(0).tolist()},
        }
    stats["nc"] = data["nc"]
    stats["names"] = data["names"]
    out = Path(data.get("path", ".")) / "stats.json"
    try:
        out.write_text(json.dumps(stats, indent=2))
    except OSError as e:
        print(f"WARNING: {out} not written: {e}")
    if verbose:
        print(json.dumps(stats, indent=2))
    return stats
