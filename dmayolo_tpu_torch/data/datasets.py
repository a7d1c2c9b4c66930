"""Dataset scanning, the label cache, and per-item augmentation.

Port of `dmayolo_tpu/data/datasets.py`, without OpenCV: images are read by
`imageio` (JPEG through the system's libjpeg, PNG) and resized by `cvops`.

  * the /images/ <-> /labels/ txt convention;
  * a hash-validated label cache next to the labels directory, in the JAX
    package's file name, version and npz layout, so either package reads
    the other's;
  * mosaic-4 or -9 (+ mixup), or letterbox + random_perspective, per item;
  * HSV jitter, flips;
  * rectangular batch shapes for eval.

Returns numpy uint8 HWC RGB images and (n, 5) [cls, xywhn] labels; the
loader (`loader.py`) batches them.  The random draws of an item come from
the `random.Random` passed to `get`, in the JAX package's order, so that
the same seed gives the same augmentation and the same labels.
"""
from __future__ import annotations

import hashlib
import os
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import yaml

from . import cvops
from .augment import (augment_hsv, copy_paste, cutout, flip_lr, flip_ud, mixup, photometric,
                      random_perspective, segments2boxes)
from .imageio import IMG_FORMATS, imread
from .letterbox import letterbox_host

SCAN_THREADS = 8  # threads that verify images while the label cache is built


def img2label_paths(img_paths: List[str]) -> List[str]:
    """/images/ -> /labels/, .ext -> .txt."""
    sa, sb = os.sep + "images" + os.sep, os.sep + "labels" + os.sep
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


_SETUP_HINTS = {
    "visdrone": (
        "\nVisDrone setup (offline): download the VisDrone2019-DET "
        "zips from https://github.com/VisDrone/VisDrone-Dataset on a "
        "connected machine, unzip under the yaml's `path`, then "
        "convert annotations:\n"
        "  python tools/visdrone2yolo.py <path>/VisDrone2019-DET-train\n"
        "  python tools/visdrone2yolo.py <path>/VisDrone2019-DET-val"),
    "uavdt": (
        "\nUAVDT setup (offline): obtain the UAV-benchmark-M archive, "
        "unpack under the yaml's `path`, then:\n"
        "  python tools/uavdt2yolo.py <path>/UAV-benchmark-M "
        "<path>/UAV-benchmark-MOTD_v1.0/GT\n"
        "  python tools/verify_labels.py <path>/images/train"),
}


def check_dataset(data) -> Dict:
    """Parse a dataset yaml or dict (path/train/val/test/nc/names): splits
    made absolute under `path` (or the yaml's directory).  Raises with
    set-up instructions when the val split is missing (offline: nothing is
    downloaded)."""
    if isinstance(data, (str, Path)):
        with open(data, errors="ignore") as f:
            d = yaml.safe_load(f)
        root = Path(d.get("path") or Path(data).parent)
    else:
        d = dict(data)
        root = Path(d.get("path") or ".")
    for k in ("train", "val", "test"):
        if d.get(k):
            v = d[k]
            if isinstance(v, str):
                d[k] = str(root / v) if not Path(v).is_absolute() else v
            else:
                d[k] = [str(root / x) for x in v]
    if "names" not in d:
        d["names"] = [str(i) for i in range(d["nc"])]
    if len(d["names"]) != d["nc"]:
        raise ValueError(f"dataset has {len(d['names'])} names for nc={d['nc']}")

    def _missing(k):  # str or a list of str
        v = d.get(k)
        paths = [v] if isinstance(v, str) else (v or [])
        return [p for p in paths if not Path(p).exists()]

    if _missing("val"):
        missing = [p for k in ("train", "val") for p in _missing(k)]
        name = Path(str(data)).stem.lower() if isinstance(data, (str, Path)) else ""
        hint = next((h for key, h in _SETUP_HINTS.items() if key in name), "")
        if not hint and d.get("download"):
            hint = ("\nThe dataset yaml carries an upstream `download` recipe; "
                    "run it on a connected machine and place the result under "
                    "the yaml's `path`.")
        raise FileNotFoundError(f"dataset paths missing: {list(dict.fromkeys(missing))}{hint}")
    return d


def _scan_images(path) -> List[str]:
    """Image files under a directory (recursively), or listed in a txt."""
    files: List[str] = []
    for p in path if isinstance(path, list) else [path]:
        p = Path(p)
        if p.is_dir():
            files += [str(x) for x in sorted(p.rglob("*.*"))]
        elif p.is_file():  # txt list of image paths
            with open(p) as f:
                parent = str(p.parent) + os.sep
                files += [x.replace("./", parent) if x.startswith("./") else x
                          for x in f.read().strip().splitlines()]
        else:
            raise FileNotFoundError(f"{p} does not exist")
    return sorted(x for x in files if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS)


def _paths_hash(paths: List[str]) -> str:
    """Size and mtime hash of the file set (validates the label cache)."""
    h = hashlib.md5()
    for p in paths:
        try:
            st = os.stat(p)
            h.update(f"{p}{st.st_size}{st.st_mtime_ns}".encode())
        except OSError:
            h.update(p.encode())
    return h.hexdigest()


def verify_image_label(im_file: str, lb_file: str, nc: int):
    """Validate one image/label pair: ((im_file, labels, (h, w), segments),
    None), or (None, message) for a pair to drop."""
    try:
        shape = imread(im_file).shape[:2]
        if shape[0] < 10 or shape[1] < 10:
            return None, f"image too small {shape}"
        segments = []
        if os.path.isfile(lb_file):
            with open(lb_file) as f:
                lb = [x.split() for x in f.read().strip().splitlines() if len(x)]
            if any(len(x) > 6 for x in lb):  # polygon rows: cls + xy pairs
                classes = np.array([x[0] for x in lb], np.float32)
                segments = [np.array(x[1:], np.float32).reshape(-1, 2) for x in lb]
                lb = np.concatenate((classes.reshape(-1, 1), segments2boxes(segments)), 1)
            else:
                lb = np.array(lb, dtype=np.float32) if lb else np.zeros((0, 5), np.float32)
            if len(lb):
                if lb.shape[1] != 5:
                    return None, f"labels require 5 columns, got {lb.shape[1]}"
                if (lb < 0).any():
                    return None, "negative label values"
                if (lb[:, 1:] > 1).any():
                    return None, "non-normalised coordinates"
                if (lb[:, 0] >= nc).any():
                    return None, f"class id >= nc={nc}"
                _, idx = np.unique(lb, axis=0, return_index=True)
                if len(idx) < len(lb):
                    keep = np.sort(idx)
                    lb = lb[keep]
                    if segments:  # stay row-aligned with lb
                        segments = [segments[x] for x in keep]
        else:
            lb = np.zeros((0, 5), np.float32)
        return (im_file, lb, shape, segments), None
    except Exception as e:  # a corrupt or unreadable file: dropped, with its message
        return None, f"{im_file}: {e}"


class DetectionDataset:
    """Training/eval dataset with the mosaic pipeline."""

    CACHE_VERSION = "dmayolo-0.3"  # the JAX package's: either reads the other's cache

    def __init__(self, path, img_size=640, augment=False, hyp: Optional[Dict] = None,
                 rect=False, stride=32, pad=0.0, nc=80, batch_size=16,
                 seed: int = 0, cache_images=False, single_cls=False,
                 cache_disk=False):
        self.img_size = img_size
        self.augment = augment
        self.hyp = hyp or {}
        self.rect = rect
        self.stride = stride
        self.pad = pad
        self.nc = nc
        self.mosaic = augment and not rect
        self.mosaic_border = (-img_size // 2, -img_size // 2)
        self.rng = random.Random(seed)

        self.im_files = _scan_images(path)
        if not self.im_files:
            raise FileNotFoundError(f"no images found in {path}")
        self.label_files = img2label_paths(self.im_files)
        self.labels, self.shapes = self._load_labels()
        if single_cls:
            for lb in self.labels:
                if len(lb):
                    lb[:, 0] = 0
        self.n = len(self.im_files)
        self.indices = list(range(self.n))

        self._im_cache: Dict[int, tuple] = {}
        self.cache_images = cache_images
        self.cache_disk = cache_disk  # resized images as .npy beside the originals

        if self.rect:
            self._plan_rect_batches(batch_size)

    # -- the label cache -----------------------------------------------------
    def _load_labels(self):
        cache_path = Path(self.label_files[0]).parent.with_suffix(".cache.npz")
        h = _paths_hash(self.im_files + self.label_files)
        if cache_path.is_file():
            try:
                z = np.load(cache_path, allow_pickle=True)
                if (str(z["version"]) == self.CACHE_VERSION
                        and str(z["hash"]) == h and "im_files" in z.files):
                    # the surviving file list: the hash covers the set
                    # before corrupt files were dropped
                    self.im_files = [str(f) for f in z["im_files"]]
                    self.label_files = img2label_paths(self.im_files)
                    self.segments = (list(z["segments"]) if "segments" in z.files
                                     else [[] for _ in z["labels"]])
                    return list(z["labels"]), z["shapes"]
            except (OSError, KeyError, ValueError):
                pass  # an unreadable cache is rebuilt
        with ThreadPoolExecutor(min(SCAN_THREADS, os.cpu_count() or 1)) as pool:
            results = list(pool.map(verify_image_label, self.im_files, self.label_files,
                                    [self.nc] * len(self.im_files)))
        labels, shapes, ok_files, ok_labels, all_segs = [], [], [], [], []
        for (res, msg), lb_f in zip(results, self.label_files):
            if res is None:
                print(f"WARNING: dropped: {msg}")
                continue
            im_f, lb, shape, segs = res
            ok_files.append(im_f)
            ok_labels.append(lb_f)
            labels.append(lb)
            shapes.append(shape)
            all_segs.append(segs)
        self.segments = all_segs
        self.im_files, self.label_files = ok_files, ok_labels
        shapes = np.array(shapes, np.int64)
        # 1-D object containers: np.array(..., dtype=object) on rows of one
        # shape builds an (n, k, 5) object array whose reload is boxed objects
        lab_arr = np.empty(len(labels), object)
        lab_arr[:] = labels
        seg_arr = np.empty(len(self.segments), object)
        seg_arr[:] = self.segments
        try:
            np.savez(cache_path.with_suffix(""), version=self.CACHE_VERSION, hash=h,
                     labels=lab_arr, shapes=shapes, segments=seg_arr,
                     im_files=np.array(self.im_files, dtype=object))
        except OSError as e:  # a read-only dataset still loads
            print(f"WARNING: label cache not written: {e}")
        return labels, shapes

    # -- rect batching ---------------------------------------------------------
    def _plan_rect_batches(self, batch_size: int):
        n = len(self.shapes)
        bi = np.floor(np.arange(n) / batch_size).astype(int)
        nb = bi[-1] + 1
        s = self.shapes  # (h, w)
        ar = s[:, 0] / s[:, 1]
        irect = ar.argsort()
        self.im_files = [self.im_files[i] for i in irect]
        self.label_files = [self.label_files[i] for i in irect]
        self.labels = [self.labels[i] for i in irect]
        self.segments = [self.segments[i] for i in irect]
        self.shapes = s[irect]
        ar = ar[irect]
        shapes = [[1, 1]] * nb
        for i in range(nb):
            ari = ar[bi == i]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes[i] = [maxi, 1]
            elif mini > 1:
                shapes[i] = [1, 1 / mini]
        self.batch_shapes = (
            np.ceil(np.array(shapes) * self.img_size / self.stride + self.pad).astype(int)
            * self.stride)
        self.batch_index = bi

    # -- image io --------------------------------------------------------------
    def load_image(self, i: int):
        """(BGR image with its long side at img_size, (h0, w0), (h, w))."""
        if i in self._im_cache:
            return self._im_cache[i]
        # the .npy name carries the source suffix and img_size
        p = Path(self.im_files[i])
        npy = p.parent / f"{p.name}.{self.img_size}.npy" if self.cache_disk else None
        if npy is not None and npy.exists():
            im = np.load(npy)
            h0, w0 = np.load(str(npy) + ".meta.npy")
            out = (im, (int(h0), int(w0)), im.shape[:2])
        else:
            im = imread(self.im_files[i])  # BGR
            h0, w0 = im.shape[:2]
            r = self.img_size / max(h0, w0)
            if r != 1:
                interp = cvops.INTER_AREA if r < 1 and not self.augment else cvops.INTER_LINEAR
                im = cvops.resize(im, (int(w0 * r), int(h0 * r)), interp)
            out = (im, (h0, w0), im.shape[:2])
            if npy is not None:  # the meta first, each file whole: threads read them
                _save_whole(Path(str(npy) + ".meta.npy"), np.array([h0, w0]))
                _save_whole(npy, im)
        if self.cache_images:
            self._im_cache[i] = out
        return out

    # -- mosaic ----------------------------------------------------------------
    def load_mosaic(self, index: int, rng=None):
        rng = self.rng if rng is None else rng
        s = self.img_size
        yc = int(rng.uniform(-self.mosaic_border[0], 2 * s + self.mosaic_border[0]))
        xc = int(rng.uniform(-self.mosaic_border[1], 2 * s + self.mosaic_border[1]))
        indices = [index] + rng.choices(self.indices, k=3)
        rng.shuffle(indices)
        labels4, segments4 = [], []
        im4 = np.full((s * 2, s * 2, 3), 114, np.uint8)
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx)
            if i == 0:  # top left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:  # top right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:  # bottom left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:  # bottom right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            im4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            lb = self.labels[idx].copy()
            segs = [sg.copy() for sg in self.segments[idx]] if len(self.segments[idx]) else []
            if len(lb):
                lb[:, 1:] = _xywhn2xyxy_np(lb[:, 1:], w, h, padw, padh)
                for sg in segs:
                    sg[:, 0] = sg[:, 0] * w + padw
                    sg[:, 1] = sg[:, 1] * h + padh
            labels4.append(lb)
            segments4.extend(segs)
        labels4 = np.concatenate(labels4, 0) if labels4 else np.zeros((0, 5), np.float32)
        np.clip(labels4[:, 1:], 0, 2 * s, out=labels4[:, 1:])
        for sg in segments4:
            np.clip(sg, 0, 2 * s, out=sg)
        im4, labels4, segments4 = copy_paste(
            im4, labels4, segments4, p=self.hyp.get("copy_paste", 0.0), rng=rng)
        return random_perspective(
            im4, labels4, rng=rng, border=self.mosaic_border,
            segments=segments4 if segments4 else None, **self._warp_hyp())

    def _warp_hyp(self):
        h = self.hyp
        return dict(degrees=h.get("degrees", 0.0), translate=h.get("translate", 0.1),
                    scale=h.get("scale", 0.5), shear=h.get("shear", 0.0),
                    perspective=h.get("perspective", 0.0))

    def load_mosaic9(self, index: int, rng=None):
        """The 9-image mosaic."""
        rng = self.rng if rng is None else rng
        s = self.img_size
        indices = [index] + rng.choices(self.indices, k=8)
        rng.shuffle(indices)
        labels9, segments9 = [], []
        im9 = np.full((s * 3, s * 3, 3), 114, np.uint8)
        hp = wp = h0 = w0 = 0
        for i, idx in enumerate(indices):
            img, _, (h, w) = self.load_image(idx)
            if i == 0:  # center
                h0, w0 = h, w
                c = (s, s, s + w, s + h)
            elif i == 1:  # top
                c = (s, s - h, s + w, s)
            elif i == 2:  # top right
                c = (s + wp, s - h, s + wp + w, s)
            elif i == 3:  # right
                c = (s + w0, s, s + w0 + w, s + h)
            elif i == 4:  # bottom right
                c = (s + w0, s + hp, s + w0 + w, s + hp + h)
            elif i == 5:  # bottom
                c = (s + w0 - w, s + h0, s + w0, s + h0 + h)
            elif i == 6:  # bottom left
                c = (s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h)
            elif i == 7:  # left
                c = (s - w, s + h0 - h, s, s + h0)
            else:  # top left
                c = (s - w, s + h0 - hp - h, s, s + h0 - hp)
            padx, pady = c[:2]
            x1, y1, x2, y2 = (max(v, 0) for v in c)
            lb = self.labels[idx].copy()
            segs = [sg.copy() for sg in self.segments[idx]] if len(self.segments[idx]) else []
            if lb.size:
                lb[:, 1:] = _xywhn2xyxy_np(lb[:, 1:], w, h, padx, pady)
                for sg in segs:
                    sg[:, 0] = sg[:, 0] * w + padx
                    sg[:, 1] = sg[:, 1] * h + pady
            labels9.append(lb)
            segments9.extend(segs)
            im9[y1:y2, x1:x2] = img[y1 - pady:, x1 - padx:][: y2 - y1, : x2 - x1]
            hp, wp = h, w

        yc = int(rng.uniform(0, s))
        xc = int(rng.uniform(0, s))
        im9 = np.ascontiguousarray(im9[yc:yc + 2 * s, xc:xc + 2 * s])
        labels9 = np.concatenate(labels9, 0) if labels9 else np.zeros((0, 5), np.float32)
        if labels9.size:
            labels9[:, [1, 3]] -= xc
            labels9[:, [2, 4]] -= yc
        for sg in segments9:
            sg -= np.array([xc, yc])
        np.clip(labels9[:, 1:], 0, 2 * s, out=labels9[:, 1:])
        for sg in segments9:
            np.clip(sg, 0, 2 * s, out=sg)
        return random_perspective(
            im9, labels9, rng=rng, border=self.mosaic_border,
            segments=segments9 if segments9 else None, **self._warp_hyp())

    # -- item --------------------------------------------------------------------
    def __len__(self):
        return self.n

    def __getitem__(self, index: int):
        return self.get(index, self.rng)

    def get(self, index: int, rng):
        """Item `index`, its augmentation drawn from `rng`.

        The loader's threads pass a `random.Random(hash((seed, epoch,
        index)))` a sample, so that the augmentation is a function of those
        three and not of which thread ran first.  Returns (RGB uint8 (H, W,
        3), (n, 5) [cls, xywhn] float32)."""
        hyp = self.hyp
        if self.mosaic and rng.random() < hyp.get("mosaic", 1.0):
            if rng.random() < hyp.get("mosaic9", 0.0):
                img, labels = self.load_mosaic9(index, rng)
            else:
                img, labels = self.load_mosaic(index, rng)
            if rng.random() < hyp.get("mixup", 0.0):
                img2, labels2 = self.load_mosaic(rng.choice(self.indices), rng)
                img, labels = mixup(img, labels, img2, labels2, rng)
        else:
            img, (h0, w0), (h, w) = self.load_image(index)
            shape = self.batch_shapes[self.batch_index[index]] if self.rect else self.img_size
            img, ratio, pad = letterbox_host(img, shape, auto=False, scaleup=self.augment)
            labels = self.labels[index].copy()
            if len(labels):
                labels[:, 1:] = _xywhn2xyxy_np(labels[:, 1:], ratio[0] * w, ratio[1] * h,
                                               pad[0], pad[1])
            if self.augment:
                img, labels = random_perspective(img, labels, rng=rng, **self._warp_hyp())

        nl = len(labels)
        out = np.zeros((nl, 5), np.float32)
        if nl:
            out[:, 0] = labels[:, 0]
            out[:, 1:] = _xyxy2xywhn_np(labels[:, 1:5], img.shape[1], img.shape[0])

        if self.augment and hyp.get("cutout", 0.0) > 0:
            # labels back to pixel xyxy for the IoA filter, then re-normalised
            if nl:
                px = out.copy()
                px[:, 1:] = _xywhn2xyxy_np(out[:, 1:], img.shape[1], img.shape[0])
                px = cutout(img, px, p=hyp["cutout"], rng=rng)
                nl = len(px)
                out = np.zeros((nl, 5), np.float32)
                if nl:
                    out[:, 0] = px[:, 0]
                    out[:, 1:] = _xyxy2xywhn_np(px[:, 1:5], img.shape[1], img.shape[0])
            else:
                cutout(img, np.zeros((0, 5), np.float32), p=hyp["cutout"], rng=rng)
        if self.augment:
            # photometric after the geometry, before HSV
            img = photometric(img, hyp, rng)
            augment_hsv(img, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                        hyp.get("hsv_v", 0.4), rng)
            if rng.random() < hyp.get("flipud", 0.0):
                img, out = flip_ud(img, out)
            if rng.random() < hyp.get("fliplr", 0.5):
                img, out = flip_lr(img, out)

        return cvops.bgr_to_rgb(img), out


def _save_whole(path: Path, a: np.ndarray):
    """np.save to a private file, then renamed over `path`: a reader sees
    the whole array or no file."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    with open(tmp, "wb") as f:
        np.save(f, a)
    os.replace(tmp, path)


def _xywhn2xyxy_np(x, w, h, padw=0, padh=0):
    y = np.empty_like(x)
    y[:, 0] = w * (x[:, 0] - x[:, 2] / 2) + padw
    y[:, 1] = h * (x[:, 1] - x[:, 3] / 2) + padh
    y[:, 2] = w * (x[:, 0] + x[:, 2] / 2) + padw
    y[:, 3] = h * (x[:, 1] + x[:, 3] / 2) + padh
    return y


def _xyxy2xywhn_np(x, w, h, eps=1e-3):
    x = x.copy()
    x[:, [0, 2]] = x[:, [0, 2]].clip(0, w - eps)
    x[:, [1, 3]] = x[:, [1, 3]].clip(0, h - eps)
    y = np.empty_like(x)
    y[:, 0] = ((x[:, 0] + x[:, 2]) / 2) / w
    y[:, 1] = ((x[:, 1] + x[:, 3]) / 2) / h
    y[:, 2] = (x[:, 2] - x[:, 0]) / w
    y[:, 3] = (x[:, 3] - x[:, 1]) / h
    return y
