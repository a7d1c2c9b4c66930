"""Detection heads: the anchor-based YOLOv5 `Detect` and the anchor-free
`TDetect` with DFL box regression.

Port of `dmayolo_tpu/nn/heads.py`.  `Detect`'s raw output per scale is
(B, ny, nx, na, no), the JAX layout; its decoding emits candidates in the
reference (a, y, x) order so NMS tie-breaks agree with the JAX package.
`TDetect`'s raw output per scale is (B, ny, nx, 4 * reg_max + nc), box
logits first, and its candidates are the cells in (y, x) order.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from .blocks import ConvBN
from .primitives import Conv2d, Sequential


def anchor_grid(ny: int, nx: int, anchor_px, device):
    """(grid (1, ny, nx, 1, 2) as (x, y), anchors (1, 1, 1, na, 2) in px)."""
    gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device),
                            torch.arange(nx, dtype=torch.float32, device=device),
                            indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)  # (ny, nx, 2) as (x, y)
    anchor_px = torch.as_tensor(anchor_px, device=device)
    return grid[None, :, :, None, :], anchor_px[None, None, None, :, :]


def decode_levels(raw: Sequence[torch.Tensor], strides, anchors_px) -> torch.Tensor:
    """Raw anchor-based heads (B, ny, nx, na, no) a level -> (B,
    sum(na*ny*nx), no) in reference (a, y, x) order: xy = (2 sig - 0.5 +
    grid) * stride, wh = (2 sig)^2 * anchor_px (f32 (na, 2) a level)."""
    z = []
    for x, stride, anc in zip(raw, strides, anchors_px):
        b, ny, nx, na, no = x.shape
        y = torch.sigmoid(x.float())
        grid, anchor_px = anchor_grid(ny, nx, anc, x.device)
        xy = (y[..., 0:2] * 2 - 0.5 + grid) * float(stride)
        wh = (y[..., 2:4] * 2) ** 2 * anchor_px
        dec = torch.cat([xy, wh, y[..., 4:]], dim=-1)
        z.append(dec.permute(0, 3, 1, 2, 4).reshape(b, na * ny * nx, no))
    return torch.cat(z, dim=1)


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
        return anchor_grid(ny, nx, self.anchors[i] * self.stride[i], device)

    def decode(self, raw: Sequence[torch.Tensor]) -> torch.Tensor:
        """(B, sum(na*ny*nx), no) in reference (a, y, x) order
        (`decode_levels`)."""
        return decode_levels(raw, self.stride,
                             [self.anchors[i] * self.stride[i] for i in range(len(raw))])

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

    def decode_scores(self, raw: Sequence[torch.Tensor], class_mask=None) -> torch.Tensor:
        """Lazy decode, pass 1: best-class scores (B, N) in f32 in the
        reference (a, y, x) order, the values of `decode_parts`' scores,
        with no box decode."""
        outs = []
        for x in raw:
            b, ny, nx, na, _ = x.shape
            best = (torch.sigmoid(x[..., 4].float())
                    * torch.sigmoid(torch.amax(x[..., 5:], dim=-1).float()))
            if class_mask is not None:
                bc = torch.argmax(x[..., 5:], dim=-1)
                best = torch.where(class_mask[bc], best, torch.zeros_like(best))
            outs.append(best.permute(0, 3, 1, 2).reshape(b, na * ny * nx))
        return torch.cat(outs, 1)

    def _candidate_constants(self, shapes, device=None) -> torch.Tensor:
        """(N, 5) [grid_x, grid_y, anchor_w_px, anchor_h_px, stride] per
        candidate in the reference (level, a, y, x) order."""
        rows = []
        for i, (ny, nx) in enumerate(shapes):
            # grid (1, ny, nx, 1, 2), anchor_px (1, 1, 1, na, 2)
            grid, anchor_px = self._grid_anchor(i, ny, nx, device)
            t = torch.empty(self.na, ny, nx, 5, device=device)
            t[..., 0:2] = grid[0].permute(2, 0, 1, 3)
            t[..., 2:4] = anchor_px[0, 0, 0][:, None, None, :]
            t[..., 4] = float(self.stride[i])
            rows.append(t.reshape(-1, 5))
        return torch.cat(rows, 0)

    def decode_at(self, raw: Sequence[torch.Tensor], idx: torch.Tensor):
        """Lazy decode, pass 2: the boxes and best classes of the
        candidates `idx` (B, K), indices in the reference order, only ->
        (boxes xyxy (B, K, 4), cls (B, K) f32).  Each level's rows are
        gathered from its natural (y, x, a) layout, never transposed."""
        b, no = raw[0].shape[0], raw[0].shape[-1]
        rows, off = None, 0
        for x in raw:
            _, ny, nx, na, _ = x.shape
            n_i = na * ny * nx
            li = (idx - off).clamp(0, n_i - 1)
            nat = (li % (ny * nx)) * na + li // (ny * nx)
            got = torch.gather(x.reshape(b, n_i, no), 1, nat[..., None].expand(-1, -1, no))
            pick = (idx >= off) & (idx < off + n_i)
            rows = got if rows is None else torch.where(pick[..., None], got, rows)
            off += n_i
        shapes = [(x.shape[1], x.shape[2]) for x in raw]
        cv = self._candidate_constants(shapes, idx.device)[idx]  # (B, K, 5)
        y = torch.sigmoid(rows[..., 0:4].float())
        xy = (y[..., 0:2] * 2 - 0.5 + cv[..., 0:2]) * cv[..., 4:5]
        wh = (y[..., 2:4] * 2) ** 2 * cv[..., 2:4]
        half = wh * 0.5
        boxes = torch.cat([xy - half, xy + half], dim=-1)
        return boxes, torch.argmax(rows[..., 5:], dim=-1).float()


def dfl_expectation(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution-focal decode, in f32: the softmax expectation over
    `reg_max` bins, (..., 4, reg_max) -> (..., 4)."""
    p = torch.softmax(box_logits.float(), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=box_logits.device)
    return (p * bins).sum(-1)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True):
    """(l, t, r, b) distances from the cell centres -> xywh or xyxy boxes."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def make_anchor_points(shapes, strides, offset: float = 0.5, device=None):
    """Cell centres (A, 2) as (x, y) in feature units, and each cell's
    stride (A, 1), for a list of (ny, nx) shapes, in (level, y, x) order."""
    pts, sts = [], []
    for (ny, nx), s in zip(shapes, strides):
        sx = torch.arange(nx, dtype=torch.float32, device=device) + offset
        sy = torch.arange(ny, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        sts.append(torch.full((ny * nx, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(pts), torch.cat(sts)


def _branch(c1, c2, c_out):
    """Two 3x3 ConvBN and a 1x1 conv with bias: keys 0, 1, 2."""
    return Sequential(ConvBN(c1, c2, 3), ConvBN(c2, c2, 3), Conv2d(c2, c_out, 1, bias=True))


class TDetect(nn.Module):
    """Anchor-free decoupled head with DFL box regression: per level a box
    branch `cv2.{i}` (4 * reg_max logits) and a class branch `cv3.{i}`
    (nc logits)."""

    reg_max = 16

    def __init__(self, nc=80, ch=(), inplace=True):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        self.no = nc + self.reg_max * 4
        self.stride = None  # set by DetectionModel
        c2, c3 = max(ch[0] // 4, 16), max(ch[0], self.no - 4)
        self.cv2 = Sequential(*[_branch(x, c2, 4 * self.reg_max) for x in ch])
        self.cv3 = Sequential(*[_branch(x, c3, self.nc) for x in ch])

    @torch.no_grad()
    def bias_init(self):
        """Box biases 1, class biases log(5 / nc / (640 / s)^2), in place."""
        for i, s in enumerate(self.stride):
            self.cv2[i][2].bias.fill_(1.0)
            self.cv3[i][2].bias.fill_(math.log(5 / self.nc / (640 / float(s)) ** 2))

    def forward(self, xs: Sequence[torch.Tensor], dtype) -> List[torch.Tensor]:
        """Raw outputs, list of (B, ny, nx, 4 * reg_max + nc); no sigmoid."""
        return [torch.cat([self.cv2[i](xs[i], dtype), self.cv3[i](xs[i], dtype)],
                          dim=1).permute(0, 2, 3, 1) for i in range(self.nl)]

    def flatten(self, raw: Sequence[torch.Tensor]):
        """Scales concatenated -> (box_logits (B, A, 4 * reg_max),
        cls_logits (B, A, nc))."""
        flat = torch.cat([x.reshape(x.shape[0], -1, self.no) for x in raw], dim=1)
        return flat[..., :4 * self.reg_max], flat[..., 4 * self.reg_max:]

    def _boxes(self, raw, xywh: bool):
        shapes = [(x.shape[1], x.shape[2]) for x in raw]
        points, strides = make_anchor_points(shapes, self.stride, device=raw[0].device)
        box_logits, cls_logits = self.flatten(raw)
        b, a, _ = box_logits.shape
        dist = dfl_expectation(box_logits.reshape(b, a, 4, self.reg_max), self.reg_max)
        return dist2bbox(dist, points[None], xywh=xywh) * strides[None], cls_logits

    def decode(self, raw: Sequence[torch.Tensor]) -> torch.Tensor:
        """(B, A, 4 + nc): xywh pixels and class probabilities (no
        objectness column), the eval path."""
        dbox, cls_logits = self._boxes(raw, xywh=True)
        return torch.cat([dbox, torch.sigmoid(cls_logits.float())], dim=-1)

    def decode_parts(self, raw: Sequence[torch.Tensor], class_mask=None):
        """Serving decode: (boxes xyxy (B, A, 4), scores (B, A), cls (B, A)).
        The score is the best class probability (no objectness), the best
        class taken on the raw logits (sigmoid is monotone)."""
        boxes, cls_logits = self._boxes(raw, xywh=False)
        best = torch.sigmoid(cls_logits.amax(-1).float())
        bc = torch.argmax(cls_logits, dim=-1)  # first maximum, as jnp.argmax
        if class_mask is not None:
            best = torch.where(class_mask[bc], best, torch.zeros_like(best))
        return boxes, best, bc.float()

    def decode_scores(self, raw: Sequence[torch.Tensor], class_mask=None) -> torch.Tensor:
        """Lazy decode, pass 1: best-class scores (B, A) in f32, with no box
        decode at all."""
        outs = []
        for x in raw:
            logits = x[..., 4 * self.reg_max:]
            best = torch.sigmoid(logits.amax(-1).float())
            if class_mask is not None:
                bc = torch.argmax(logits, dim=-1)
                best = torch.where(class_mask[bc], best, torch.zeros_like(best))
            outs.append(best.reshape(x.shape[0], -1))
        return torch.cat(outs, 1)

    def _candidate_constants(self, shapes, device=None) -> torch.Tensor:
        """(A, 3) [anchor_x, anchor_y, stride], the values and order of
        `make_anchor_points`."""
        points, strides = make_anchor_points(shapes, self.stride, device=device)
        return torch.cat([points, strides], dim=-1)

    def decode_at(self, raw: Sequence[torch.Tensor], idx: torch.Tensor):
        """Lazy decode, pass 2: the DFL boxes and best classes of the
        candidate cells `idx` (B, K) only -> (boxes xyxy (B, K, 4), cls
        (B, K) f32).  Each level's rows are gathered from its own map: the
        (B, A, no) concatenation never exists."""
        rows, off = None, 0
        for x in raw:
            flat = x.reshape(x.shape[0], -1, self.no)
            n_i = flat.shape[1]
            li = (idx - off).clamp(0, n_i - 1)
            got = torch.gather(flat, 1, li[..., None].expand(-1, -1, self.no))
            pick = (idx >= off) & (idx < off + n_i)
            rows = got if rows is None else torch.where(pick[..., None], got, rows)
            off += n_i
        shapes = [(x.shape[1], x.shape[2]) for x in raw]
        cv = self._candidate_constants(shapes, idx.device)[idx]  # (B, K, 3)
        b, k = idx.shape
        dist = dfl_expectation(rows[..., :4 * self.reg_max].reshape(b, k, 4, self.reg_max),
                               self.reg_max)
        boxes = dist2bbox(dist, cv[..., 0:2], xywh=False) * cv[..., 2:3]
        return boxes, torch.argmax(rows[..., 4 * self.reg_max:], dim=-1).float()

