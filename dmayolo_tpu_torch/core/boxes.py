"""Box geometry on tensors of any leading shape, boxes last as (..., 4).

Port of `dmayolo_tpu/core/boxes.py`: the same arithmetic, with no in-place
change of the inputs.
"""
from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def xywhn2xyxy(x: torch.Tensor, w: float, h: float, padw: float = 0.0,
               padh: float = 0.0) -> torch.Tensor:
    """Normalised (cx, cy, w, h) -> pixel (x1, y1, x2, y2)."""
    cx, cy, bw, bh = x.unbind(-1)
    return torch.stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                        w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh], -1)


def xyxy2xywhn(x: torch.Tensor, w: float, h: float, clip: bool = False,
               eps: float = 0.0) -> torch.Tensor:
    """Pixel (x1, y1, x2, y2) -> normalised (cx, cy, w, h)."""
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([((x1 + x2) / 2) / w, ((y1 + y2) / 2) / h,
                        (x2 - x1) / w, (y2 - y1) / h], -1)


def xyn2xy(x: torch.Tensor, w: float, h: float, padw: float = 0.0,
           padh: float = 0.0) -> torch.Tensor:
    """Normalised segment points (..., 2) -> pixel points."""
    xs, ys = x.unbind(-1)
    return torch.stack([w * xs + padw, h * ys + padh], -1)


def clip_boxes(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Clip xyxy boxes to the image (height, width)."""
    h, w = shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w),
                        y2.clamp(0, h)], -1)


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape,
                ratio_pad=None) -> torch.Tensor:
    """Map xyxy boxes from the letterboxed `img1_shape` back to the native
    `img0_shape` (the reference's scale_coords)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    shift = torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=boxes.dtype,
                         device=boxes.device)
    return clip_boxes((boxes - shift) / gain, img0_shape)


def letterbox_params(shape, new_shape=(640, 640), auto: bool = True,
                     scale_fill: bool = False, scaleup: bool = True,
                     stride: int = 32):
    """Letterbox resize and pad geometry (host math, no pixels).

    Returns ((new_w, new_h) unpadded size, (ratio_w, ratio_h), (dw, dh)
    padding per side)."""
    h, w = shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(w * r)), int(round(h * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:  # pad to the smallest stride multiple
        dw, dh = dw % stride, dh % stride
    elif scale_fill:  # stretch, no pad
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / w, new_shape[0] / h)
    return new_unpad, ratio, (dw / 2, dh / 2)
