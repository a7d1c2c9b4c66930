"""Aspect-preserving resize + pad, without cv2: on the request's device
(`letterbox`, for serving) and on the host (`letterbox_host`, numpy, for
the data loader).

Port of `dmayolo_tpu/data/augment.py::letterbox`: the same arithmetic for
the ratio, the unpadded size and the padding, and the same 114 fill.  The
device resize is bilinear with half-pixel centres and no antialiasing
(what cv2.INTER_LINEAR does), in f32, rounded to uint8.  cv2 interpolates
uint8 in fixed point, so its pixels may differ from these by 1.  The host
resize is `cvops.resize`, cv2's fixed-point INTER_LINEAR.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import cvops

FILL = 114


def letterbox(im, new_shape=(640, 640), auto=True, stride=32, device="cpu"):
    """HWC uint8 image (numpy array or tensor) -> (HWC uint8 tensor on
    `device`, ratio, (dw, dh)), as the JAX letterbox returns.  `auto` pads
    only to the next multiple of `stride`."""
    im = torch.as_tensor(np.asarray(im) if not torch.is_tensor(im) else im,
                         device=device)
    shape = tuple(im.shape[:2])
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        x = im.permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(new_unpad[1], new_unpad[0]), mode="bilinear",
                          align_corners=False, antialias=False)
        im = x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    h, w, c = im.shape
    out = torch.full((h + top + bottom, w + left + right, c), FILL, dtype=torch.uint8,
                     device=im.device)
    out[top:top + h, left:left + w] = im
    return out, (r, r), (dw, dh)


def letterbox_host(im: np.ndarray, new_shape=(640, 640), color=(FILL, FILL, FILL), auto=True,
                   scale_fill=False, scaleup=True, stride=32):
    """HWC uint8 numpy image -> (image, ratio (rw, rh), (dw, dh)), as the
    JAX letterbox returns: `auto` pads only to the next multiple of
    `stride`, `scale_fill` stretches to the shape without padding, and
    `scaleup=False` never enlarges."""
    shape = im.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        im = cvops.resize(im, new_unpad, cvops.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    return cvops.copy_make_border(im, top, bottom, left, right, color), ratio, (dw, dh)
