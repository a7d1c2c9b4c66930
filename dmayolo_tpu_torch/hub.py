"""Hub API: one-call model loading and an input-robust inference wrapper.

Port of `dmayolo_tpu/hub.py` (the reference's hubconf.py:13-143 entry
points and models/common.py:701-891 `AutoShape` and `Detections`).
`load` returns an `AutoShape` on `device` (None: CUDA) that takes image
paths (read by the port's `imread`) and HWC RGB arrays, letterboxes them
on the host as the JAX package does, and serves them through the model's
head-aware serving tail (K3 for more than 512 candidates: the blocked
entry at max_det 1000).  PIL images are not taken: the port has no PIL.
`Detections.pandas` imports pandas when it is called; `render`, `save`
and `crop` draw and write with the port's host library (its bitmap font
for labels, not cv2's Hershey strokes).
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .core.nms import batched_nms
from .data import cvops
from .data.imageio import imread, imwrite
from .data.letterbox import letterbox_host
from .eval.second_stage import _xyxy2xywh_np, expand_boxes
from .eval.validator import _scale_to_native, with_obj_column


def load(weights=None, cfg: Optional[str] = None, nc: Optional[int] = None, names=None,
         device=None):
    """Load model(s) as an end-to-end `AutoShape` callable on `device`.

    weights: checkpoint path (`.npz` or the reference `.pt`), or a LIST of
    paths for an NMS ensemble (outputs concatenated before NMS, the
    reference's Ensemble, models/experimental.py:92-111); cfg: a model
    yaml's path or name."""
    from .cli.common import load_model_from_checkpoint

    if isinstance(weights, (list, tuple)) and len(weights) > 1:
        members = [load_model_from_checkpoint(w, cfg, nc=nc, device=device).fuse()
                   for w in weights]
        return AutoShapeEnsemble(members, names=names)
    if isinstance(weights, (list, tuple)):
        weights = weights[0] if weights else None
    if weights is None and cfg is None:
        cfg = "yolov5s.yaml"  # fresh default model
    model = load_model_from_checkpoint(weights, cfg, nc=nc, device=device)
    return AutoShape(model.fuse(), names=names)


class AutoShape:
    """Robust-input preprocess, inference and NMS (the reference's
    models/common.py:701-793) around a BN-folded model."""

    conf = 0.25
    iou = 0.45
    max_det = 1000
    multi_label = False

    def __init__(self, model, names=None, dtype=torch.bfloat16):
        if not model.fused:
            raise ValueError("AutoShape takes the BN-folded model: call fuse() first")
        self.model = model
        self.names = names or [str(i) for i in range(model.nc)]
        self.dtype = dtype
        self.device = next(model.parameters()).device

    def _infer(self, x: torch.Tensor):
        """uint8 (B, S, S, 3) on the device -> (dets, valid)."""
        model, dtype = self.model, self.dtype
        raw = model.apply(x.to(dtype) / 255.0, dtype=dtype, fused=True)
        if not self.multi_label:
            # serving fast path: the head-aware fused decode (the same
            # detections as decode + single-label batched_nms)
            return model.serve_detections(raw, conf_thres=self.conf, iou_thres=self.iou,
                                          max_det=self.max_det, max_nms=30000)
        dec = with_obj_column(model.decode(raw), model.nc)
        return batched_nms(dec, conf_thres=self.conf, iou_thres=self.iou, multi_label=True,
                           max_det=self.max_det)

    @staticmethod
    def _to_rgb_array(im) -> np.ndarray:
        if isinstance(im, (str, Path)):
            return imread(im)[:, :, ::-1]  # BGR -> RGB
        if hasattr(im, "convert"):
            raise TypeError("PIL images are not taken: the port has no PIL; pass a path "
                            "or an HWC RGB uint8 array")
        arr = np.asarray(im)
        if arr.ndim == 3 and arr.shape[0] < 5:  # CHW
            arr = arr.transpose(1, 2, 0)
        if arr.ndim == 2:
            arr = np.tile(arr[..., None], 3)
        return arr[..., :3]

    def __call__(self, imgs, size: int = 640):
        single = not isinstance(imgs, (list, tuple))
        items = [imgs] if single else list(imgs)
        arrays = [self._to_rgb_array(im) for im in items]
        shapes0 = [a.shape[:2] for a in arrays]
        gs = int(self.model.stride.max())
        size = int(np.ceil(size / gs) * gs)

        lbs = [letterbox_host(np.ascontiguousarray(a, np.uint8), size, auto=False, stride=gs)[0]
               for a in arrays]
        x = np.stack(lbs).astype(np.uint8)
        with torch.inference_mode():
            dets, valid = self._infer(torch.as_tensor(x, device=self.device))
            dets, valid = dets.float().cpu().numpy(), valid.cpu().numpy()
        per_img = []
        for i, s0 in enumerate(shapes0):
            d = dets[i][valid[i]].copy()
            d[:, :4] = _scale_to_native(d[:, :4], x.shape[1:3], s0)
            per_img.append(d)
        files = [Path(im).name if isinstance(im, (str, Path)) else f"image{i}.jpg"
                 for i, im in enumerate(items)]
        return Detections(arrays, per_img, files, self.names)


class AutoShapeEnsemble(AutoShape):
    """Multi-model NMS ensemble: each member's decode concatenated on the
    candidate axis before one NMS pass (the reference's Ensemble,
    models/experimental.py:92-111)."""

    def __init__(self, members, names=None, dtype=torch.bfloat16):
        super().__init__(members[0], names=names, dtype=dtype)
        self.members = members
        # the largest stride of the members rounds the letterbox (the
        # reference's attempt_load, experimental.py:150); a copy of the first
        # member carries it, so the caller's model keeps its own
        self.model = copy.copy(members[0])
        self.model.stride = max(m.stride.max() for m in members) * np.ones(1)

    def _infer(self, x: torch.Tensor):
        dtype = self.dtype
        decs = [with_obj_column(m.decode(m.apply(x.to(dtype) / 255.0, dtype=dtype, fused=True)),
                                m.nc)
                for m in self.members]
        return batched_nms(torch.cat(decs, 1), conf_thres=self.conf, iou_thres=self.iou,
                           multi_label=self.multi_label, max_det=self.max_det)


class Detections:
    """Inference results: print/pandas/crop/render/save/show/tolist and the
    xyxy/xywh/xyxyn/xywhn box views (the reference's
    models/common.py:795-891)."""

    def __init__(self, imgs: List[np.ndarray], dets: List[np.ndarray], files, names):
        self.imgs = imgs
        self.xyxy = dets  # list of (n, 6) [xyxy, conf, cls]
        self.files = files
        self.names = names
        self.n = len(imgs)
        # normalisation vector per image (w, h, w, h, 1, 1), the reference's common.py:800
        gn = [np.array([im.shape[1], im.shape[0], im.shape[1], im.shape[0], 1, 1],
                       np.float32) for im in imgs]
        self.xywh = [self._to_xywh(d) for d in dets]
        self.xyxyn = [d / g for d, g in zip(self.xyxy, gn)]
        self.xywhn = [d / g for d, g in zip(self.xywh, gn)]

    @staticmethod
    def _to_xywh(d):
        out = np.array(d, np.float32, copy=True).reshape(-1, 6)
        out[:, :4] = _xyxy2xywh_np(out[:, :4])
        return out

    def __len__(self):
        return self.n

    def records(self, i: int = 0) -> List[dict]:
        """Image i's detections as the rows of `pandas().xyxy[i]`
        (`to_dict(orient="records")`), built without pandas."""
        return [{"xmin": float(r[0]), "ymin": float(r[1]), "xmax": float(r[2]),
                 "ymax": float(r[3]), "confidence": float(r[4]), "class": int(r[5]),
                 "name": self.names[int(r[5])]} for r in np.asarray(self.xyxy[i])]

    def pandas(self):
        """Copy whose xyxy/xyxyn/xywh/xywhn are per-image DataFrames, the
        `results.pandas().xyxy[0]` idiom (the reference's common.py:874-882)."""
        import pandas as pd

        new = copy.copy(self)
        ca = ["xmin", "ymin", "xmax", "ymax", "confidence", "class", "name"]
        cb = ["xcenter", "ycenter", "width", "height", "confidence", "class", "name"]
        for k, cols in zip(["xyxy", "xyxyn", "xywh", "xywhn"], [ca, ca, cb, cb]):
            frames = []
            for d in getattr(self, k):
                rows = [list(map(float, r[:5])) + [int(r[5]), self.names[int(r[5])]]
                        for r in np.asarray(d)]
                frames.append(pd.DataFrame(rows, columns=cols))
            setattr(new, k, frames)
        return new

    def tolist(self):
        """Per-image single-item Detections (the reference's common.py:884-890)."""
        return [Detections([self.imgs[i]], [self.xyxy[i]], [self.files[i]], self.names)
                for i in range(self.n)]

    def show(self):
        """The reference opens a window; the port has no display."""
        print("show(): no display available; use save() or render()")

    def print(self):
        for i, d in enumerate(self.xyxy):
            counts = {}
            for *_, k in d:
                counts[self.names[int(k)]] = counts.get(self.names[int(k)], 0) + 1
            summary = ", ".join(f"{v} {k}" for k, v in counts.items()) or "no detections"
            print(f"image {i + 1}/{self.n}: {self.imgs[i].shape[1]}x{self.imgs[i].shape[0]} "
                  f"{summary}")

    def render(self):
        """Draw boxes and labels onto copies of the images; returns a list
        of RGB arrays."""
        out = []
        for im, d in zip(self.imgs, self.xyxy):
            im = np.ascontiguousarray(im.copy())
            for x1, y1, x2, y2, conf, k in d:
                cvops.rectangle(im, (int(x1), int(y1)), (int(x2), int(y2)), (255, 60, 60), 2)
                cvops.put_text(im, f"{self.names[int(k)]} {conf:.2f}",
                               (int(x1), max(int(y1) - 4, 8)), 0.5, (255, 60, 60), 1)
            out.append(im)
        return out

    def save(self, save_dir="runs/hub"):
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        for i, im in enumerate(self.render()):
            imwrite((save_dir / self.files[i]).with_suffix(".jpg"), im[:, :, ::-1])
        return save_dir

    def crop(self, save_dir=None):
        """Per-detection crops with save_one_box's gain/pad margin (the
        reference's common.py:825-828 -> general.py:916), optionally saved."""
        crops = []
        for im, d in zip(self.imgs, self.xyxy):
            for x1, y1, x2, y2, conf, k in d:
                h, w = im.shape[:2]
                ex1, ey1, ex2, ey2 = expand_boxes((x1, y1, x2, y2))[0]
                crop = im[int(max(ey1, 0)):int(min(ey2, h)),
                          int(max(ex1, 0)):int(min(ex2, w))]
                crops.append({"box": (x1, y1, x2, y2), "conf": conf,
                              "cls": int(k), "label": self.names[int(k)], "im": crop})
                if save_dir:
                    p = Path(save_dir) / self.names[int(k)]
                    p.mkdir(parents=True, exist_ok=True)
                    imwrite(p / f"crop{len(crops)}.jpg", crop[:, :, ::-1])
        return crops
