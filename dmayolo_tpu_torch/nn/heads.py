"""Anchor-based YOLOv5 `Detect` head.

Port of `dmayolo_tpu/nn/heads.py::Detect`.  The raw output per scale is
(B, ny, nx, na, no), the JAX layout; decoding emits candidates in the
reference (a, y, x) order so NMS tie-breaks agree with the JAX package.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from .primitives import Conv2d, Sequential


class Detect(nn.Module):
    def __init__(self, nc=80, anchors=(), ch=()):
        super().__init__()
        self.nc = nc
        self.no = nc + 5
        self.nl = len(anchors)
        self.na = len(anchors[0]) // 2
        # pixel-space anchors from the yaml; DetectionModel rescales them
        # to stride units after its stride probe
        self.anchors = np.asarray(anchors, np.float32).reshape(self.nl, -1, 2)
        self.stride = None  # set by DetectionModel
        self.m = Sequential(*[Conv2d(x, self.no * self.na, 1, bias=True) for x in ch])

    @torch.no_grad()
    def bias_init(self):
        """Focal-style prior on the objectness and class biases, in place
        (the JAX `bias_init` without class frequencies)."""
        for i, s in enumerate(self.stride):
            b = self.m[i].bias.view(self.na, -1)
            b[:, 4] += math.log(8 / (640 / float(s)) ** 2)
            b[:, 5:] += math.log(0.6 / (self.nc - 0.999999))

    def forward(self, xs: Sequence[torch.Tensor], dtype) -> List[torch.Tensor]:
        """Raw outputs, list of (B, ny, nx, na, no); no sigmoid."""
        out = []
        for i in range(self.nl):
            y = self.m[i](xs[i], dtype)  # (B, na*no, ny, nx), channels_last
            b, _, ny, nx = y.shape
            out.append(y.permute(0, 2, 3, 1).reshape(b, ny, nx, self.na, self.no))
        return out

    def _grid_anchor(self, i: int, ny: int, nx: int, device):
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device),
                                torch.arange(nx, dtype=torch.float32, device=device),
                                indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)  # (ny, nx, 2) as (x, y)
        anchor_px = torch.as_tensor(self.anchors[i] * self.stride[i], device=device)
        return grid[None, :, :, None, :], anchor_px[None, None, None, :, :]

    def decode(self, raw: Sequence[torch.Tensor]) -> torch.Tensor:
        """(B, sum(na*ny*nx), no) in reference (a, y, x) order:
        xy = (2 sig - 0.5 + grid) * stride, wh = (2 sig)^2 * anchor_px."""
        z = []
        for i, x in enumerate(raw):
            b, ny, nx, na, no = x.shape
            y = torch.sigmoid(x.float())
            grid, anchor_px = self._grid_anchor(i, ny, nx, x.device)
            s = float(self.stride[i])
            xy = (y[..., 0:2] * 2 - 0.5 + grid) * s
            wh = (y[..., 2:4] * 2) ** 2 * anchor_px
            dec = torch.cat([xy, wh, y[..., 4:]], dim=-1)
            z.append(dec.permute(0, 3, 1, 2, 4).reshape(b, na * ny * nx, no))
        return torch.cat(z, dim=1)

    def decode_parts(self, raw: Sequence[torch.Tensor], class_mask=None,
                     ref_order: bool = True):
        """Serving decode: (boxes xyxy (B, N, 4), scores (B, N), cls (B, N))
        without the (B, N, 5+nc) tensor.  The best class is taken on the raw
        logits (sigmoid is monotone), the sigmoids run in f32.

        ref_order=False keeps the native (y, x, a) flatten; it only changes
        equal-score NMS tie-breaks."""
        bxs, scs, cls_ = [], [], []
        for i, x in enumerate(raw):
            b, ny, nx, na, no = x.shape
            best_logit = torch.amax(x[..., 5:], dim=-1)
            bc = torch.argmax(x[..., 5:], dim=-1)  # first maximum, as jnp.argmax
            y4 = torch.sigmoid(x[..., 0:4].float())
            grid, anchor_px = self._grid_anchor(i, ny, nx, x.device)
            s = float(self.stride[i])
            xy = (y4[..., 0:2] * 2 - 0.5 + grid) * s
            wh = (y4[..., 2:4] * 2) ** 2 * anchor_px
            half = wh * 0.5
            box = torch.cat([xy - half, xy + half], dim=-1)
            best = torch.sigmoid(x[..., 4].float()) * torch.sigmoid(best_logit.float())
            if class_mask is not None:
                # the best class is picked first; a detection whose best
                # class is excluded is dropped, never re-labelled
                best = torch.where(class_mask[bc], best, torch.zeros_like(best))
            bc = bc.float()
            if ref_order:  # (a, y, x) flatten, as the reference
                bxs.append(box.permute(0, 3, 1, 2, 4).reshape(b, na * ny * nx, 4))
                scs.append(best.permute(0, 3, 1, 2).reshape(b, na * ny * nx))
                cls_.append(bc.permute(0, 3, 1, 2).reshape(b, na * ny * nx))
            else:
                bxs.append(box.reshape(b, na * ny * nx, 4))
                scs.append(best.reshape(b, na * ny * nx))
                cls_.append(bc.reshape(b, na * ny * nx))
        return torch.cat(bxs, 1), torch.cat(scs, 1), torch.cat(cls_, 1)
