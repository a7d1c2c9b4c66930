"""Test-time augmentation: multi-scale and flipped forwards, de-scaled.

Port of `dmayolo_tpu/eval/tta.py`.  Six passes at scales (1, 1, .83, .83,
.67, .67), every second one flipped left-right; the decoded outputs are
mapped back to the unaugmented frame, their first-scale large-object tail
and last-scale small-object head clipped, and concatenated for NMS.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from ..parallel import spatial

TTA_SCALES = (1.0, 1.0, 0.83, 0.83, 0.67, 0.67)
TTA_FLIPS = (None, "lr", None, "lr", None, "lr")


def scale_img(img: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) images, then pad to a multiple of
    `gs` with 0.447 grey.  The resize antialiases when it shrinks, as
    `jax.image.resize(..., "bilinear")` does."""
    if ratio == 1.0:
        return img
    b, h, w, c = img.shape
    nh, nw = int(h * ratio), int(w * ratio)
    x = F.interpolate(img.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=True).to(img.dtype)
    ph, pw = math.ceil(h * ratio / gs) * gs, math.ceil(w * ratio / gs) * gs
    x = F.pad(x, (0, pw - nw, 0, ph - nh), value=0.447)
    return x.permute(0, 2, 3, 1).contiguous()


def descale_pred(p: torch.Tensor, flip, scale: float, img_hw) -> torch.Tensor:
    """Map decoded xywh predictions back to the unaugmented frame."""
    xy = p[..., :2] / scale
    wh = p[..., 2:4] / scale
    if flip == "ud":
        xy = torch.cat([xy[..., 0:1], img_hw[0] - xy[..., 1:2]], -1)
    elif flip == "lr":
        xy = torch.cat([img_hw[1] - xy[..., 0:1], xy[..., 1:2]], -1)
    return torch.cat([xy, wh, p[..., 4:]], -1)


def clip_augmented(ys: List[torch.Tensor], nl: int) -> List[torch.Tensor]:
    """Drop the first scale's large-object tail and the last scale's
    small-object head."""
    g = sum(4 ** x for x in range(nl))
    i = ys[0].shape[1] // g
    ys[0] = ys[0][:, :-i]
    i = (ys[-1].shape[1] // g) * 4 ** (nl - 1)
    ys[-1] = ys[-1][:, i:]
    return ys


def forward_augment(model, x: torch.Tensor, dtype=torch.float32,
                    fused: bool = False) -> torch.Tensor:
    """TTA forward of (B, H, W, 3) images -> (B, N_total, 5 + nc) decoded
    predictions.  On the spatial path (`parallel/spatial.py`) `x` is this
    rank's rows: the flips and the resize run on the image gathered over
    the spatial group (small beside the activations), and each pass on
    this rank's rows of the scaled image."""
    split = spatial.current() is not None
    if split:
        x = spatial.gather_h(x, dim=1)
    img_hw = (x.shape[1], x.shape[2])
    gs = int(model.stride.max())
    ys = []
    for s, f in zip(TTA_SCALES, TTA_FLIPS):
        xi = x
        if f == "lr":
            xi = xi.flip(2)
        elif f == "ud":
            xi = xi.flip(1)
        xi = scale_img(xi, s, gs)
        if split:
            xi = spatial.slice_h(xi, dim=1)
        yi = model.decode(model.apply(xi, dtype=dtype, fused=fused))
        ys.append(descale_pred(yi, f, s, img_hw))
    ys = clip_augmented(ys, model.head.nl)
    return torch.cat(ys, 1)
