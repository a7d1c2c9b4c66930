"""Batch augmentation on the device: HSV jitter, horizontal flip and the
/255 normalise of a uint8 NHWC batch, in plain torch ops on the batch's
device.

Port of `dmayolo_tpu/data/device_aug.py`.  Colour follows cv2's ranges (H
in [0, 180), S and V in [0, 1], hue wraps) but is continuous, not 8-bit
lookup tables, so it matches the host path to quantisation (~1/255).  The
gains and flips are drawn from an explicit `torch.Generator` on the
batch's device; `apply_hsv_flip` takes them as given.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rgb_to_hsv_cv(rgb: torch.Tensor):
    """RGB in [0, 1] -> (h in [0, 180), s in [0, 1], v in [0, 1])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(v == r, torch.remainder((g - b) / safe_c, 6.0),
                    torch.where(v == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0))
    h = torch.where(c > 0, h * 30.0, torch.zeros_like(h))
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v)), torch.zeros_like(v))
    return h, s, v


def hsv_to_rgb_cv(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The inverse of rgb_to_hsv_cv."""
    h6 = torch.remainder(h / 30.0, 6.0)
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32)

    def select(vals, default):
        out = default
        for k in range(4, -1, -1):  # the first match wins, as jnp.select
            out = torch.where(i == k, vals[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    return torch.stack([r, g, b], dim=-1)


def apply_hsv_flip(images: torch.Tensor, gains: torch.Tensor, flipped: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) RGB -> the batch in [0, 1] with each image's HSV
    multiplied by its gains (B, 3) (hue wrapping, S and V clipped) and the
    images where `flipped` (B,) mirrored left-right, in `dtype`."""
    x = images.to(torch.float32) / 255.0
    h, s, v = rgb_to_hsv_cv(x)
    h = torch.remainder(h * gains[:, 0, None, None], 180.0)
    s = torch.clamp(s * gains[:, 1, None, None], 0.0, 1.0)
    v = torch.clamp(v * gains[:, 2, None, None], 0.0, 1.0)
    x = hsv_to_rgb_cv(h, s, v)
    x = torch.where(flipped[:, None, None, None], x.flip(2), x)
    return x.to(dtype)


def augment_batch(images: torch.Tensor, generator: Optional[torch.Generator] = None,
                  hgain=0.015, sgain=0.7, vgain=0.4, fliplr_p=0.5, dtype=torch.float32,
                  rows: Optional[Tuple[int, int]] = None):
    """uint8 NHWC batch -> (augmented batch in [0, 1] in `dtype`, flipped
    (B,) bool).  Per image: HSV gains uniform in 1 +- (hgain, sgain,
    vgain), and a left-right flip with probability `fliplr_p`, drawn from
    `generator` (on the batch's device).  The caller mirrors the targets
    of the flipped rows (`flip_targets_lr`).  `rows` (offset, n): the
    batch is rows offset .. offset + B of a batch of n (a data-parallel
    rank's share): the draws are the n rows', and these rows take theirs."""
    b, dev = images.shape[0], images.device
    off, n = (0, b) if rows is None else rows
    u = torch.rand((n, 3), generator=generator, device=dev)[off:off + b] * 2.0 - 1.0
    gains = u * torch.tensor([hgain, sgain, vgain], device=dev) + 1.0
    flipped = torch.rand((n,), generator=generator, device=dev)[off:off + b] < fliplr_p
    return apply_hsv_flip(images, gains, flipped, dtype), flipped


def flip_targets_lr(targets_box: torch.Tensor, flipped: torch.Tensor) -> torch.Tensor:
    """Normalised xywh targets (B, M, 4) with cx -> 1 - cx on flipped rows."""
    cx = torch.where(flipped[:, None], 1.0 - targets_box[..., 0], targets_box[..., 0])
    return torch.cat([cx[..., None], targets_box[..., 1:]], dim=-1)
